"""Shared building blocks: linears (dense or LUT-quantized), norms, RoPE,
attention with a preallocated token-major KV cache, and the two
collectives of a tensor-parallel shard.

The PyTorch counterpart of the JAX package's ``models/common.py``; the
same functions under the same names, on tensors. The KV cache is updated
in place (JAX returns a new one).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from squeezellm_tpu_torch.ops import kv_quant
from squeezellm_tpu_torch.ops.quant_linear import (
    QuantLinearSpec,
    quant_linear_apply,
)


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Static description of one linear: dense fp or LUT-quantized."""

    in_features: int
    out_features: int
    has_bias: bool = False
    quant: Optional[QuantLinearSpec] = None  # None => dense weights

    @property
    def is_quant(self) -> bool:
        return self.quant is not None


def apply_linear(spec: LinearSpec, params: Dict[str, torch.Tensor],
                 x: torch.Tensor, *, mode: str = "exact",
                 y0: Optional[torch.Tensor] = None,
                 plain: bool = False, decode: bool = False) -> torch.Tensor:
    """y = y0 + x @ W^T (+ b). Dense params: {'w': (out, in), 'b'?};
    quantized: the quant_linear tensors. A quantized linear folds y0 into
    its kernel's output init; a dense one adds it. decode: the call is a
    decode step (``quant_linear_apply``)."""
    if spec.is_quant:
        return quant_linear_apply(spec.quant, params, x, mode=mode, y0=y0,
                                  plain=plain, decode=decode)
    y = torch.matmul(x, params["w"].to(x.dtype).t())
    if y0 is not None:
        y = y + y0.to(x.dtype)
    if spec.has_bias:
        y = y + params["b"].to(x.dtype)
    return y


class Linear(nn.Module):
    """A linear's spec and tensors (buffers) as a module."""

    def __init__(self, spec: LinearSpec, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        self.spec = spec
        self._names = tuple(tensors)
        for name, t in tensors.items():
            self.register_buffer(name, t)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self._names}

    def add_tensors(self, **tensors: torch.Tensor) -> None:
        """Attach derived tensors (decode-time tables) as buffers."""
        for name, t in tensors.items():
            self.register_buffer(name, t)
        self._names += tuple(n for n in tensors if n not in self._names)

    def drop_tensors(self, *names: str) -> None:
        """Detach tensors that ``add_tensors`` attached."""
        for name in names:
            delattr(self, name)
        self._names = tuple(n for n in self._names if n not in names)

    def forward(self, x: torch.Tensor, *, mode: str = "exact",
                y0: Optional[torch.Tensor] = None,
                plain: bool = False, decode: bool = False) -> torch.Tensor:
        return apply_linear(self.spec, self.tensors(), x, mode=mode, y0=y0,
                            plain=plain, decode=decode)


# ---------------------------------------------------------------------------
# Tensor parallelism: a shard's place and its two collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TPGroup:
    """Where a tensor-parallel shard of a model sits: rank ``rank`` of
    ``size`` ranks whose collectives run on ``group`` (a
    ``torch.distributed`` process group) over ``backend`` ("nccl" or
    "gloo"). ``parallel.tp.shard_model`` sets one on the local model
    (``model.tp``); every forward hands it to its layers in ``Step.tp``.

    ``counts`` counts the collectives called, by kind ("all_reduce",
    "gather"). With ``timed`` set, each collective first waits for the
    device and then for itself, and ``seconds`` sums the time spent inside
    them: a measurement's switch, off in serving (a replayed CUDA graph
    runs no Python, so neither counts nor times its collectives)."""

    rank: int
    size: int
    group: object
    backend: str
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0, "gather": 0})
    timed: bool = False
    seconds: float = 0.0

    def _run(self, kind: str, fn, t: torch.Tensor) -> None:
        self.counts[kind] += 1
        if not self.timed:
            fn()
            return
        sync = (torch.cuda.synchronize if t.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        self.seconds += time.perf_counter() - t0


def all_reduce(y: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The sum of every rank's ``y`` (the partial outputs of a row-parallel
    linear), in ``y``'s dtype, on every rank; in place."""
    tp._run("all_reduce", lambda: dist.all_reduce(y, group=tp.group), y)
    return y


def gather_vocab(y: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """A column-parallel lm_head's full logit rows (..., V) from every
    rank's block (..., V / tp), rank r's block at columns r * V / tp on.
    NCCL gathers (``all_gather_into_tensor``, rows concatenated rank by
    rank). Over gloo each rank writes its block into a zero-filled
    full-width buffer and the buffers are summed, which is exact: every
    element is one rank's value plus zeros. Gloo's own gather of CUDA
    tensors is not documented, and its output shapes differ between torch
    versions; its all-reduce is the same everywhere."""
    lead, vl = y.shape[:-1], y.shape[-1]
    if tp.backend == "nccl":
        rows = y.reshape(-1, vl).contiguous()
        out = y.new_empty((tp.size * rows.shape[0], vl))  # rank-major rows
        tp._run("gather", lambda: dist.all_gather_into_tensor(
            out, rows, group=tp.group), y)
        return (out.view(tp.size, -1, vl).transpose(0, 1)
                .reshape(*lead, tp.size * vl))
    full = y.new_zeros(*lead, tp.size, vl)
    full[..., tp.rank, :] = y
    tp._run("gather", lambda: dist.all_reduce(full, group=tp.group), y)
    return full.reshape(*lead, tp.size * vl)


def kv_heads(model) -> int:
    """The KV heads whose cache this process holds: the config's, or
    n_kv_heads / tp on a tensor-parallel shard (``model.tp``)."""
    tp = getattr(model, "tp", None)
    return model.config.n_kv_heads // (tp.size if tp else 1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE (HF LLaMA convention: rotate_half over contiguous halves)
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32):
    """positions: int tensor (...,). Returns cos/sin (..., head_dim),
    computed in f32 in the JAX package's op order, then cast to dtype."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * inv_freq  # (..., hd/2)
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope_tm(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D) TOKEN-major; cos/sin: (B, S, D) or (S, D)."""
    if cos.dim() == x.dim() - 2:
        cos = cos[None]
        sin = sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    d2 = x.shape[-1] // 2
    rotated = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return x * cos + rotated * sin


# ---------------------------------------------------------------------------
# Attention with a preallocated KV cache
# ---------------------------------------------------------------------------


def is_int8(dtype) -> bool:
    return dtype == "int8" or dtype is torch.int8


def init_kv_cache(batch: int, max_seq: int, n_layers: int, n_kv_heads: int,
                  head_dim: int, dtype=torch.float32,
                  device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Per-layer list of {'k','v'} of shape (B, max_seq, H_kv * D):
    TOKEN-major, a token's row contiguous across heads.

    dtype "int8" (or torch.int8): the quantized cache. 'k'/'v' hold int8
    codes and the sidecars 'ks'/'vs' one f32 scale per (slot, kv head,
    token), stored (B, H_kv, max_seq): a head's scales contiguous along
    the tokens. (The JAX package pads the head axis to 8 rows for the
    TPU's f32 tile; the port stores exactly H_kv.) Rows quantize at
    insert (``ops/kv_quant.py``)."""
    shape = (batch, max_seq, n_kv_heads * head_dim)
    if is_int8(dtype):
        side = (batch, n_kv_heads, max_seq)
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "ks": torch.zeros(side, dtype=torch.float32, device=device),
                 "vs": torch.zeros(side, dtype=torch.float32, device=device)}
                for _ in range(n_layers)]
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(n_layers)]


def read_kv(cache: Dict[str, torch.Tensor], dtype, n_kv_heads: int):
    """HEAD-major (k, v) (B, H_kv, S, D) of a token-major cache in
    ``dtype``: views, not copies, when the cache already has it; codes
    times the row scale for an int8 cache."""
    B, S, KV = cache["k"].shape
    hd = KV // n_kv_heads

    def hm(a):
        return a.view(B, S, n_kv_heads, hd).transpose(1, 2)

    if "ks" in cache:
        return ((hm(cache["k"]).float() * cache["ks"][..., None]).to(dtype),
                (hm(cache["v"]).float() * cache["vs"][..., None]).to(dtype))
    return hm(cache["k"]).to(dtype), hm(cache["v"]).to(dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """x: (B, H, S, D) -> (B, H*n_rep, S, D)."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, H, Sk, D); mask broadcastable to
    (B, H, Sq, Sk), True = attend. Softmax in f32."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(dt)
    return torch.matmul(probs.float(), v.float()).to(dt)


def causal_mask(sq: int, sk: int, offset: int = 0,
                sliding_window: Optional[int] = None,
                device="cpu") -> torch.Tensor:
    """(1, 1, sq, sk) bool causal mask; query i sits at position offset+i."""
    qpos = offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if sliding_window is not None:
        m = m & (kpos > qpos - sliding_window)
    return m[None, None]


def decode_mask(max_seq: int, pos: torch.Tensor,
                sliding_window: Optional[int] = None) -> torch.Tensor:
    """Mask for single-token queries at position(s) pos: scalar ->
    (1, 1, 1, max_seq); (B,) -> (B, 1, 1, max_seq)."""
    kpos = torch.arange(max_seq, device=pos.device)[None, :]
    p = pos.reshape(-1, 1)
    m = kpos <= p
    if sliding_window is not None:
        m = m & (kpos > p - sliding_window)
    return m[:, None, None, :]


def window_mask(sq: int, max_seq: int, pos: torch.Tensor,
                sliding_window: Optional[int] = None) -> torch.Tensor:
    """Mask for an sq-token query window per slot: slot b's rows sit at
    positions pos[b] .. pos[b] + sq - 1, each attending the cache columns
    at or before its own position. (B, 1, sq, max_seq) bool."""
    kpos = torch.arange(max_seq, device=pos.device)[None, None, None, :]
    qpos = (pos.reshape(-1, 1, 1, 1)
            + torch.arange(sq, device=pos.device)[None, None, :, None])
    m = kpos <= qpos
    if sliding_window is not None:
        m = m & (kpos > qpos - sliding_window)
    return m


def update_kv_window(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                     v_new: torch.Tensor, pos: torch.Tensor) -> None:
    """Write an s-token window's k/v (B, s, H_kv, D) at per-slot positions
    pos (B,), in place: slot b's rows land at [pos[b], pos[b] + s), cast
    to the cache dtype; an int8 cache quantizes each row
    (``ops/kv_quant.quantize_rows``) into its (B, H_kv, S) scales. A slot
    with pos < 0 writes nothing. The window must fit in the cache (the
    engines reserve its rows). Only device tensors index, so a CUDA graph
    can capture the write."""
    B, s = k_new.shape[:2]
    S = cache["k"].shape[1]
    pos = pos.reshape(-1).long()
    live = (pos >= 0)[:, None, None]
    # an inactive slot writes its own rows [0, s) back: no change
    rows = (pos[:, None] + torch.arange(s, device=pos.device)).clamp(0, S - 1)
    b_idx = torch.arange(B, device=pos.device)[:, None]
    for name, new in (("k", k_new), ("v", v_new)):
        if "ks" in cache:
            new, scale = kv_quant.quantize_rows(new)
            sc = cache[name + "s"]
            sc[b_idx, :, rows] = torch.where(live, scale[..., 0],
                                             sc[b_idx, :, rows])
        c = cache[name]
        c[b_idx, rows] = torch.where(live, new.reshape(B, s, -1).to(c.dtype),
                                     c[b_idx, rows])


def write_kv_rows(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                  v: torch.Tensor, start=0) -> None:
    """Prefill: write k/v (B, s, H_kv, D) into rows [start, start + s), in
    place, cast to the cache dtype; an int8 cache quantizes each row at
    insert. start: a python int, or an int tensor of one element on the
    cache's device (the rows are then written by an index copy, so a step
    captured in a CUDA graph writes wherever the tensor points at each
    replay)."""
    b, s = k.shape[:2]
    rows = None
    if torch.is_tensor(start):
        rows = start.reshape(()).long() + torch.arange(s, device=k.device)
    for name, new in (("k", k), ("v", v)):
        if "ks" in cache:
            new, scale = kv_quant.quantize_rows(new)
            scale = scale[..., 0].transpose(1, 2)  # (B, H_kv, s)
            if rows is None:
                cache[name + "s"][:, :, start: start + s] = scale
            else:
                cache[name + "s"].index_copy_(2, rows, scale.contiguous())
        c = cache[name]
        new = new.reshape(b, s, -1).to(c.dtype)
        if rows is None:
            c[:, start: start + s] = new
        else:
            c.index_copy_(1, rows, new)


def init_paged_pool(n_layers: int, n_pages: int, page_size: int,
                    n_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                    device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Per-layer list of page pools {'pk', 'pv'} of shape
    (n_pages, page_size, H_kv * D): TOKEN-major pages, one page id spanning
    all layers. A model call reads the page table (B, maxp) int32 from the
    key 'pt' that the caller adds to each layer's dict.

    dtype "int8" (or torch.int8): int8 codes plus the sidecars 'sk'/'sv',
    one f32 scale per (page, kv head, token), stored
    (n_pages, H_kv, page_size). (The JAX package pads the head axis to 8
    rows for the TPU's f32 tile; the port stores exactly H_kv.)"""
    shape = (n_pages, page_size, n_kv_heads * head_dim)
    if is_int8(dtype):
        side = (n_pages, n_kv_heads, page_size)
        return [{"pk": torch.zeros(shape, dtype=torch.int8, device=device),
                 "pv": torch.zeros(shape, dtype=torch.int8, device=device),
                 "sk": torch.zeros(side, dtype=torch.float32, device=device),
                 "sv": torch.zeros(side, dtype=torch.float32, device=device)}
                for _ in range(n_layers)]
    return [{"pk": torch.zeros(shape, dtype=dtype, device=device),
             "pv": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(n_layers)]


def update_kv_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                    v_new: torch.Tensor, pos) -> Dict[str, torch.Tensor]:
    """Write one new token's k/v (B, 1, H_kv, D) at position(s) pos (int,
    or (B,) tensor for per-slot positions), in place, cast to the cache
    dtype; an int8 cache quantizes the row at insert."""
    B = k_new.shape[0]
    slots = torch.arange(B, device=k_new.device)
    for name, new in (("k", k_new), ("v", v_new)):
        if "ks" in cache:
            new, scale = kv_quant.quantize_rows(new)
            if isinstance(pos, int):
                cache[name + "s"][:, :, pos] = scale[:, 0, :, 0]
            else:
                cache[name + "s"][slots, :, pos.long()] = scale[:, 0, :, 0]
        c = cache[name]
        rows = new.reshape(B, -1).to(c.dtype)
        if isinstance(pos, int):
            c[:, pos] = rows
        else:
            c[slots, pos.long()] = rows
    return cache
