"""The plain reference of Mistral-7B and OPT-6.7B with Dense-and-Sparse
4-bit weights, teacher-forced over whole sequences.

It follows the published architectures (Hugging Face's
``MistralForCausalLM`` and ``OPTForCausalLM``):

* Mistral: token embedding; per layer RMSNorm (eps from the config), q, k,
  v, rope on q and k (``rotate_half`` over contiguous halves, theta from
  the config), grouped-query attention (query head h reads kv head
  h // (heads / kv heads)), causal with the sliding window (a query at i
  attends keys j with i - window < j <= i), o with the residual; RMSNorm,
  down(silu(gate) * up) with the residual; a final RMSNorm and the head.
* OPT: token embedding plus the learned position embedding at position
  + 2; per layer pre-LayerNorm (eps 1e-5), q, k, v and o with biases,
  causal multi-head attention, the residual; LayerNorm, fc2(relu(fc1))
  with biases, the residual; a final LayerNorm and the head tied to the
  token embedding.

Every weight is dequantized in f32 from the raw arrays of
``pbench.weights`` (``lut[code]``, plus the sidecar value at its slot,
plus the top-X rows), one layer at a time, made again from the seed: the
reference takes nothing the program made. Departures from the published
models: random weights in the recipe's scales; no dropout (inference).

``act``, when given, rounds what the program holds at its configuration's
precision (bf16) to a lower one: every LUT (per channel), every linear's
input, the keys and values as the cache would hold them, and the
residual stream after every add. ``fp8`` (``reference/rounding.py``) is
the control's.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from pbench import weights
from reference.rounding import fp8  # noqa: F401 (the control's)

MLP_ROWS = 8192   # rows of the MLP a block
ATTN_QUERIES = 512  # queries of the attention a block


def dequant(lin: dict) -> torch.Tensor:
    """W (out, in) f32 of one raw linear."""
    w = lin["lut"].float().gather(1, lin["codes"].long())
    out_f, in_f = w.shape
    w.view(-1).index_add_(0, lin["sp_rows"] * in_f + lin["sp_cols"],
                          lin["sp_vals"].float())
    w[lin["topx_idx"]] += lin["topx_w"].float().t()
    return w


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _ln(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _rope(x, pos, theta):
    """x (n, heads, hd) at positions pos (n,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos.float()[:, None] * inv
    emb = torch.cat([ang, ang], -1)[:, None, :]
    rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], -1)
    return x * torch.cos(emb) + rot * torch.sin(emb)


class _Linear:
    def __init__(self, raw: dict, act):
        if act is not None:  # the LUT held at act's precision as well
            raw = dict(raw, lut=act(raw["lut"].float()))
        self.w = dequant(raw)
        self.b = raw.get("bias")
        self.act = act

    def __call__(self, x):
        if self.act is not None:
            x = self.act(x)
        y = x @ self.w.t()
        return y if self.b is None else y + self.b.float()


def _attention(q, k, v, window: Optional[int]):
    """Causal attention of one sequence: q (n, H, hd), k and v (n, Hkv,
    hd) -> (n, H * hd), a block of queries at a time over the keys it may
    attend."""
    n, nh, hd = q.shape
    nkv = k.shape[1]
    g = nh // nkv
    out = torch.empty(n, nh, hd, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    for a in range(0, n, ATTN_QUERIES):
        b = min(n, a + ATTN_QUERIES)
        lo = 0 if window is None else max(0, a - window + 1)
        qi = q[a:b].view(b - a, nkv, g, hd).permute(1, 2, 0, 3)
        kj = k[lo:b].permute(1, 0, 2)  # (Hkv, m, hd)
        vj = v[lo:b].permute(1, 0, 2)
        s = torch.einsum("kgqd,kmd->kgqm", qi, kj) * scale
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(lo, b, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        o = torch.einsum("kgqm,kmd->kgqd", s, vj)  # (Hkv, g, b - a, hd)
        out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, nh, hd)
    return out.reshape(n, nh * hd)


def _rows(fn, x):
    return torch.cat([fn(x[i:i + MLP_ROWS])
                      for i in range(0, x.shape[0], MLP_ROWS)])


@torch.no_grad()
def logits(cfg: dict, seed: int, seqs: Sequence[Sequence[int]],
           starts: Sequence[int], device,
           act: Optional[Callable] = None) -> List[torch.Tensor]:
    """Teacher-forced logits f32 of each sequence from position
    ``starts[i]`` to its end: (len - start, vocab) per sequence."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = weights.is_opt(cfg)
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nkv, hd = weights.kv_heads(cfg), weights.head_dim(cfg)
    window = None if opt else cfg.get("sliding_window")
    eps = cfg.get("rms_norm_eps", 1e-5)
    lens = [len(s) for s in seqs]
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    toks = torch.tensor([t for s in seqs for t in s], device=device)
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    g = weights.globals_(cfg, seed, device)
    x = g["embed"][toks].float()
    if opt:
        x = x + g["embed_pos"][pos + 2].float()
    if act is not None:
        x = act(x)
    for li in range(cfg["num_hidden_layers"]):
        raw = weights.layer(cfg, seed, li, device)
        lin = {n: _Linear(r, act) for n, r in raw["linears"].items()}
        nrm = raw["norms"]
        hn = (_ln(x, *nrm["attn_norm"]) if opt
              else _rms(x, nrm["input_norm"], eps))
        q = lin["q"](hn).view(-1, nh, hd)
        k = lin["k"](hn).view(-1, nkv, hd)
        v = lin["v"](hn).view(-1, nkv, hd)
        del hn
        if not opt:
            q = _rope(q, pos, cfg["rope_theta"])
            k = _rope(k, pos, cfg["rope_theta"])
        if act is not None:
            k, v = act(k), act(v)
        att = torch.cat([_attention(q[a:b], k[a:b], v[a:b], window)
                         for a, b in zip(offs[:-1], offs[1:])])
        del q, k, v
        x = x + lin["o"](att)
        if act is not None:
            x = act(x)
        del att
        if opt:
            x = x + _rows(lambda r: lin["down"](torch.relu(
                lin["up"](_ln(r, *nrm["ffn_norm"])))), x)
        else:
            def mlp(r):
                hr = _rms(r, nrm["post_norm"], eps)
                return lin["down"](torch.nn.functional.silu(lin["gate"](hr))
                                   * lin["up"](hr))
            x = x + _rows(mlp, x)
        if act is not None:
            x = act(x)
        del lin, raw
    rows = torch.cat([torch.arange(o + s, o + n, device=device)
                      for o, s, n in zip(offs, starts, lens)])
    xr = x[rows]
    fn = g["final_norm"]
    xr = _ln(xr, *fn) if opt else _rms(xr, fn, eps)
    if act is not None:
        xr = act(xr)
    out = xr @ g["lm_head"].float().t()
    sizes = [n - s for n, s in zip(lens, starts)]
    return list(torch.split(out, sizes))
