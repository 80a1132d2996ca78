"""The system under test: the port's model, built from the raw weights by
the port's own packing, fusion and model classes, and its paged engine.

``build_model`` builds the dense families (``families/mistral.py``,
``families/opt.py``); ``_linear`` packs one raw linear for any family;
``build_engine``, the engine at the cell's settings, is the same for
every architecture. The port (``squeezellm_tpu_torch``) is imported
inside the functions, here and in the family files, never by the
reference.
"""

from __future__ import annotations

import torch

from pbench import weights

PAGE_SIZE = 128  # rows a page of the pool holds


def _linear(raw: dict, bits: int):
    from squeezellm_tpu_torch import formats
    from squeezellm_tpu_torch.models.common import Linear, LinearSpec
    from squeezellm_tpu_torch.ops.quant_linear import QuantLinearSpec

    out_f, in_f = raw["codes"].shape
    dev = raw["codes"].device
    rowptr = torch.zeros(out_f + 1, dtype=torch.int64, device=dev)
    rowptr[1:] = torch.cumsum(torch.bincount(raw["sp_rows"],
                                             minlength=out_f), 0)
    tensors = {
        "qweight": formats.pack_codes(raw["codes"].t(), bits),
        "lut": raw["lut"].float().contiguous(),
        "sp_rowptr": rowptr.to(torch.int32),
        "sp_cols": raw["sp_cols"].to(torch.int32),
        "sp_vals": raw["sp_vals"].float().contiguous(),
        "topx_weights": raw["topx_w"].float().contiguous(),
        "topx_indices": raw["topx_idx"].to(torch.int32),
    }
    has_bias = "bias" in raw
    if has_bias:
        tensors["bias"] = raw["bias"].float().contiguous()
    spec = QuantLinearSpec(bits=bits, in_features=in_f, out_features=out_f,
                           has_bias=has_bias, nnz=int(raw["sp_vals"].numel()),
                           topx=int(raw["topx_idx"].numel()))
    return Linear(LinearSpec(in_features=in_f, out_features=out_f,
                             has_bias=has_bias, quant=spec), tensors)


@torch.no_grad()
def build_model(cfg: dict, seed: int, device):
    """The port's model of configuration ``cfg`` with the seed's weights,
    q|k|v and gate|up fused for decode (``models.fuse.fuse_for_decode``,
    the serving commands' ``--fuse``)."""
    from squeezellm_tpu_torch.models import fuse, llama, opt, registry
    from squeezellm_tpu_torch.models.common import Linear, LinearSpec

    mtype = registry.parse_model_type(cfg["model_type"], cfg)
    pconf = registry.config_class(mtype).from_hf_config(cfg)
    bits = weights.quant(cfg)["bits"]
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        raw = weights.layer(cfg, seed, i, device)
        lins = {n: _linear(r, bits) for n, r in raw["linears"].items()}
        norms = raw["norms"]
        if weights.is_opt(cfg):
            layers.append(opt.DecoderLayer(pconf, lins, norms))
        else:
            layers.append(llama.DecoderLayer(pconf, lins,
                                             norms["input_norm"],
                                             norms["post_norm"]))
        del raw
    g = weights.globals_(cfg, seed, device)
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    head = Linear(LinearSpec(in_features=h, out_features=v),
                  {"w": g["lm_head"]})
    if weights.is_opt(cfg):
        model = opt.OPT(pconf, g["embed"], g["embed_pos"], layers,
                        g["final_norm"], head)
    else:
        model = llama.Llama(pconf, g["embed"], layers, g["final_norm"], head)
    return fuse.fuse_for_decode(model)


def build_engine(model, settings: dict, serve: dict):
    """The paged continuous-batching engine the window drives, at the
    configuration's precision (``serve``: activations, the page pool's
    type, K1's mode), with graphed steps."""
    from squeezellm_tpu_torch import serving

    return serving.PagedContinuousBatchEngine(
        model, slots=settings["slots"], n_pages=settings["pages"],
        page_size=PAGE_SIZE,
        dtype=getattr(torch, serve["activations"]),
        cache_dtype=getattr(torch, serve["kv_cache"]), mode=serve["mode"],
        max_seq=settings["max_seq"], graphs=True)
