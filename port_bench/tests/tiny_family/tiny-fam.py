"""A test architecture added by files alone (``families/tiny-fam.py`` in
a copied harness): a LLaMA-like decoder whose every linear is drawn by
``weights.raw_linear`` under a tag of its own (``reference/tiny_fam.py``'s
``raw_layer``, the raw arrays both sides take), built with the port's
``models/llama.py`` classes; its plain reference is
``reference/tiny_fam.py``, its work the dense count."""

import torch

from pbench import port, weights, work
from reference import tiny_fam

Work = work.Work
logits = tiny_fam.logits


@torch.no_grad()
def build_model(cfg, seed, device):
    from squeezellm_tpu_torch.models import fuse, llama
    from squeezellm_tpu_torch.models.common import Linear, LinearSpec

    pconf = llama.LlamaConfig.from_hf_config(cfg)
    bits = weights.quant(cfg)["bits"]
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        raw, norms = tiny_fam.raw_layer(cfg, seed, i, device)
        lins = {n: port._linear(r, bits) for n, r in raw.items()}
        layers.append(llama.DecoderLayer(pconf, lins, norms[0], norms[1]))
    g = weights.globals_(cfg, seed, device)
    head = Linear(LinearSpec(in_features=cfg["hidden_size"],
                             out_features=cfg["vocab_size"]),
                  {"w": g["lm_head"]})
    return fuse.fuse_for_decode(
        llama.Llama(pconf, g["embed"], layers, g["final_norm"], head))
