"""The plain reference of the test architecture ``tiny-fam``
(``families/tiny-fam.py`` in a copied harness): a LLaMA-like decoder
(RMSNorm, rope, grouped-query attention without a window, SwiGLU) over
weights dequantized in f32 from ``raw_layer``'s raw arrays."""

from __future__ import annotations

import torch

from pbench import weights
from reference.model import _attention, _Linear, _rms, _rope

NAMES = ("q", "k", "v", "o", "gate", "up", "down")


def raw_layer(cfg, seed, i, device):
    """Layer i's linears, each from ``weights.raw_linear`` under a tag of
    its own, and its two RMSNorm weights (2, hidden)."""
    shapes = weights.linear_shapes(cfg)
    lins = {n: weights.raw_linear(seed, f"tiny{i}.{n}", *shapes[n],
                                  weights.quant(cfg), weights.LUT_GAIN,
                                  device) for n in NAMES}
    gen = weights.generator(seed, f"tiny{i}.norms", device)
    norms = 1 + weights.NORM_JITTER * torch.randn(
        2, cfg["hidden_size"], generator=gen, device=device)
    return lins, norms


@torch.no_grad()
def logits(cfg, seed, seqs, starts, device, act=None):
    nh, nkv = cfg["num_attention_heads"], weights.kv_heads(cfg)
    hd, eps = weights.head_dim(cfg), cfg["rms_norm_eps"]
    g = weights.globals_(cfg, seed, device)
    out = []
    for seq, start in zip(seqs, starts):
        pos = torch.arange(len(seq), device=device)
        x = g["embed"][torch.tensor(seq, device=device)].float()
        for i in range(cfg["num_hidden_layers"]):
            raw, norms = raw_layer(cfg, seed, i, device)
            lin = {n: _Linear(r, act) for n, r in raw.items()}
            h = _rms(x, norms[0], eps)
            q = _rope(lin["q"](h).view(-1, nh, hd), pos, cfg["rope_theta"])
            k = _rope(lin["k"](h).view(-1, nkv, hd), pos, cfg["rope_theta"])
            v = lin["v"](h).view(-1, nkv, hd)
            if act is not None:
                k, v = act(k), act(v)
            x = x + lin["o"](_attention(q, k, v, None))
            h = _rms(x, norms[1], eps)
            x = x + lin["down"](torch.nn.functional.silu(lin["gate"](h))
                                * lin["up"](h))
        h = _rms(x[start:], g["final_norm"], eps)
        out.append(h @ g["lm_head"].float().t())
    return out
