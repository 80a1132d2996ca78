"""Seeded raw weights of a sparse-expert decoder layer (Mellum 2), made on
the device: one recipe for the port (``families/mellum.py``, which packs
them by the port's own functions) and the plain reference
(``reference/mellum.py``, which dequantizes them).

Every linear is drawn by ``weights.raw_linear`` from a generator of its
own, seeded from (seed, its tag): the attention's ``layer<i>.<q|k|v|o>``
and each expert's ``layer<i>.expert<e>.<gate|up|down>``, so the reference
can make one expert again after the program's state is freed, in any
order. The norms and the router come from a generator of the layer's own
(``layer<i>.rest``). Scales as the dense recipe's (``pbench/weights.py``):
gain 1 for q, k, v, gate and up, 0.5 for o; norms 1 + N(0, 0.05). The
router is N(0, ROUTER_GAIN / sqrt(hidden)) in f32: at unit-rms states its
logits deviate by 1.5, so that a token's renormalised top-8 weights fall
from ~0.36 to ~0.04 (the order statistics of 64 normals), spread over
several experts as a trained router's are. Each expert's down takes
DOWN_GAIN 0.5, as o does: a token whose 8th and 9th experts nearly tie
swaps one for the other under rounding, and with random experts the swap
moves its output by a whole expert's contribution times that weight; each
swap moves later routers' inputs, and at gain 1 the swaps cascaded through
the 28 layers. Trials of the plain versions at 1024 wide and 28 layers
(bf16 against f32 on the same tokens): logits apart by 0.26 rms (of a
deviation of 2) at gain 1, 0.038 of it with the f32 run's routing forced
on the bf16 one (the swaps, not the arithmetic); 0.079 at 0.5, 0.046 at
0.25; a sharper router (gain 3) 0.25. The configuration lists these under
``assumed``.
"""

from __future__ import annotations

import torch

from pbench import weights

ROUTER_GAIN = 1.5  # the router logits' std at unit-rms states
DOWN_GAIN = 0.5    # each expert's down, as o (module docstring)


def attn_shapes(cfg: dict) -> dict:
    """(out, in) of the attention's linears (``head_dim`` its own)."""
    h, hd = cfg["hidden_size"], weights.head_dim(cfg)
    q, kv = cfg["num_attention_heads"] * hd, weights.kv_heads(cfg) * hd
    return {"q": (q, h), "k": (kv, h), "v": (kv, h), "o": (h, q)}


def expert_shapes(cfg: dict) -> dict:
    """(out, in) of one expert's linears."""
    h, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return {"gate": (f, h), "up": (f, h), "down": (h, f)}


def attn(cfg: dict, seed: int, index: int, device) -> dict:
    """Layer ``index``'s attention linears (``weights.raw_linear``'s
    arrays)."""
    q = weights.quant(cfg)
    return {n: weights.raw_linear(
        seed, f"layer{index}.{n}", o, i, q,
        weights.O_GAIN if n == "o" else weights.LUT_GAIN, device)
        for n, (o, i) in attn_shapes(cfg).items()}


def expert(cfg: dict, seed: int, index: int, e: int, device) -> dict:
    """Expert e of layer ``index``: its gate, up and down."""
    q = weights.quant(cfg)
    return {n: weights.raw_linear(
        seed, f"layer{index}.expert{e}.{n}", o, i, q,
        DOWN_GAIN if n == "down" else weights.LUT_GAIN, device)
        for n, (o, i) in expert_shapes(cfg).items()}


def rest(cfg: dict, seed: int, index: int, device) -> dict:
    """Layer ``index``'s norms and router (``router`` f32 (E, hidden))."""
    h, n_exp = cfg["hidden_size"], cfg["num_experts"]
    gen = weights.generator(seed, f"layer{index}.rest", device)
    norms = 1 + weights.NORM_JITTER * torch.randn(2 * h, generator=gen,
                                                  device=device)
    router = torch.randn(n_exp, h, generator=gen, device=device)
    return {"input_norm": norms[:h], "post_norm": norms[h:],
            "router": router * (ROUTER_GAIN / h ** 0.5)}
