"""The plain reference of Mellum2-12B-A2.5B with Dense-and-Sparse 4-bit
weights, teacher-forced over whole sequences.

It follows the published configuration (Hugging Face ``config.json`` of
``JetBrains/Mellum2-12B-A2.5B-Instruct``, ``model_type`` mellum): token
embedding; per layer RMSNorm (eps from the config), q, k, v of
``head_dim`` each, rope on q and k (``rotate_half`` over contiguous
halves) by the layer type's ``rope_parameters`` (the default rope on
sliding layers; yarn on full layers: frequencies blended by a linear ramp
between the correction dims of ``beta_fast`` and ``beta_slow``, cos and
sin times ``attention_factor``, as transformers'
``_compute_yarn_parameters`` and its rotary embedding compute them),
grouped-query attention, causal, a query at i attending keys j with
i - window < j <= i on sliding layers and all j <= i on full ones, o with
the residual; RMSNorm h, the router's logits h R^T (f32), their softmax
over the experts, the top k (ties to the lower expert), renormalised
(``norm_topk_prob``), and the residual plus sum_j w_j down_j(silu(gate_j(h))
* up_j(h)), the k terms summed in their rank order; a final RMSNorm and
the untied head. The configuration declares no per-head q/k norm, no
shared expert, no attention-output gate and no multi-token-prediction
module, and there are none here.

Every weight is dequantized in f32 from the raw arrays of
``pbench/experts.py`` (``lut[code]``, plus the sidecar value at its slot,
plus the top-X rows, ``reference/model.dequant``), one layer and one
expert at a time, made again from the seed: the reference takes nothing
the program made, and imports neither the port nor JAX. Departures from
the published model: random weights in the recipe's scales.

``act``, when given, rounds what the program holds at its configuration's
precision (bf16) to a lower one, as ``reference/model.py`` does: every
LUT, every linear's input (the router's too), the keys and values, and
the residual stream after every add.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from pbench import experts, weights
from reference.model import _attention, _Linear, _rms


def inv_freq(head_dim: int, rope: dict) -> (torch.Tensor, float):
    """(inverse frequencies (head_dim / 2,) f32, cos/sin scale) of one
    ``rope_parameters`` entry: the default rope's, or yarn's (module
    docstring)."""
    base = rope["rope_theta"]
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    own = 1.0 / base ** exps
    if rope.get("rope_type", "default") == "default":
        return own, 1.0
    if rope["rope_type"] != "yarn":
        raise ValueError(f"rope_type {rope['rope_type']!r}")
    factor, orig = rope["factor"], rope["original_max_position_embeddings"]

    def dim_of(rotations):  # the dim that turns `rotations` times
        return (head_dim * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(dim_of(rope.get("beta_fast", 32))), 0)
    high = min(math.ceil(dim_of(rope.get("beta_slow", 1))), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    blended = (own / factor) * ramp + own * (1 - ramp)
    scale = rope.get("attention_factor")
    if scale is None:
        scale = 0.1 * math.log(factor) + 1.0
    return blended, float(scale)


def _rope(x, pos, inv, scale):
    """x (n, heads, hd) at positions pos (n,)."""
    hd = x.shape[-1]
    ang = pos.float()[:, None] * inv.to(x.device)
    emb = torch.cat([ang, ang], -1)[:, None, :]
    rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], -1)
    return x * (torch.cos(emb) * scale) + rot * (torch.sin(emb) * scale)


def route(h, router, k: int, norm: bool):
    """(expert ids (n, k), weights (n, k)) of rows h: the softmax of the
    router's logits, its top k in rank order (ties to the lower expert),
    renormalised over them when ``norm``."""
    p = torch.softmax(h @ router.t(), dim=-1)
    top, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    w = top[:, :k]
    if norm:
        w = w / w.sum(-1, keepdim=True)
    return idx[:, :k], w


def _moe(h, cfg, seed: int, li: int, router, device, act):
    """sum_j w_j expert_j(h) of rows h (n, hidden), the k terms in rank
    order; each expert made from the seed when a row chose it."""
    k, n_exp = cfg["num_experts_per_tok"], cfg["num_experts"]
    hin = act(h) if act is not None else h
    ids, w = route(hin, router, k, cfg.get("norm_topk_prob", True))
    terms = torch.zeros(h.shape[0], k, h.shape[1], device=device)
    for e in range(n_exp):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        lin = {n: _Linear(r, act) for n, r in
               experts.expert(cfg, seed, li, e, device).items()}
        he = h[rows]
        y = lin["down"](torch.nn.functional.silu(lin["gate"](he))
                        * lin["up"](he))
        terms[rows, slot] = w[rows, slot][:, None] * y
        del lin
    out = terms[:, 0]
    for j in range(1, k):
        out = out + terms[:, j]
    return out


@torch.no_grad()
def logits(cfg: dict, seed: int, seqs: Sequence[Sequence[int]],
           starts: Sequence[int], device,
           act: Optional[Callable] = None) -> List[torch.Tensor]:
    """Teacher-forced logits f32 of each sequence from position
    ``starts[i]`` to its end: (len - start, vocab) per sequence."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nh, nkv = cfg["num_attention_heads"], weights.kv_heads(cfg)
    hd = weights.head_dim(cfg)
    eps = cfg["rms_norm_eps"]
    types = cfg["layer_types"]
    ropes = {t: inv_freq(hd, cfg["rope_parameters"][t]) for t in set(types)}
    lens = [len(s) for s in seqs]
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    toks = torch.tensor([t for s in seqs for t in s], device=device)
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    g = weights.globals_(cfg, seed, device)
    x = g["embed"][toks].float()
    if act is not None:
        x = act(x)
    for li, kind in enumerate(types):
        window = (cfg["sliding_window"] if kind == "sliding_attention"
                  else None)
        nrm = experts.rest(cfg, seed, li, device)
        lin = {n: _Linear(r, act)
               for n, r in experts.attn(cfg, seed, li, device).items()}
        hn = _rms(x, nrm["input_norm"], eps)
        q = lin["q"](hn).view(-1, nh, hd)
        k = lin["k"](hn).view(-1, nkv, hd)
        v = lin["v"](hn).view(-1, nkv, hd)
        del hn
        q = _rope(q, pos, *ropes[kind])
        k = _rope(k, pos, *ropes[kind])
        if act is not None:
            k, v = act(k), act(v)
        att = torch.cat([_attention(q[a:b], k[a:b], v[a:b], window)
                         for a, b in zip(offs[:-1], offs[1:])])
        del q, k, v
        x = x + lin["o"](att)
        if act is not None:
            x = act(x)
        del att, lin
        x = x + _moe(_rms(x, nrm["post_norm"], eps), cfg, seed, li,
                     nrm["router"], device, act)
        if act is not None:
            x = act(x)
    rows = torch.cat([torch.arange(o + s, o + n, device=device)
                      for o, s, n in zip(offs, starts, lens)])
    xr = _rms(x[rows], g["final_norm"], eps)
    if act is not None:
        xr = act(xr)
    out = xr @ g["lm_head"].float().t()
    sizes = [n - s for n, s in zip(lens, starts)]
    return list(torch.split(out, sizes))
