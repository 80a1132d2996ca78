"""K6-K9: attention through a page table over a shared KV page pool, with
rope and the pool write fused in.

The pool of one layer is token-major, ``(P, ps, Hkv*hd)`` for k and for v
(f32 or bf16; or int8 codes with f32 row scales ``(P, Hkv, ps)``, a head's
scales contiguous along the page's tokens). A slot owns the pages its row
of the page table ``(B, maxp)`` int32 names; position ``t`` of the slot
lives in page ``table[t // ps]`` at row ``t % ps``. Pools are updated in
place.

* K6 ``paged_decode_attention`` / K7 ``paged_decode_attention_q8``: one
  token per slot. Rope q and k_new from the passed cos/sin rows, write k/v
  at position ``len - 1``, attend positions ``[max(len - window, 0), len)``
  with GQA. A slot with ``len == 0`` writes nothing and outputs zeros.
* K8 ``paged_verify_attention`` / K9 ``paged_verify_attention_q8``: a
  W-token window per slot from position ``start``. Rope and write all W
  rows (they may cross a page boundary), then each of the W query rows
  attends causally over prefix and window (``qpos - window < kpos <=
  qpos`` with ``qpos = start + w``). ``start < 0`` writes nothing and
  outputs zeros.

The new tokens enter attention as the pool holds them (rounded to bf16, or
code times scale). The int8 twins quantize the roped k rows and the v rows
with the ``ops/kv_quant.py`` math, bit for bit.

The CUDA kernels (``csrc/paged_attn.cu``, one template, four entry points)
replace the TPU kernels ``_paged_attn_kernel`` (K6),
``_paged_attn_kernel_q8`` (K7), ``_paged_verify_kernel`` (K8) and
``_paged_verify_kernel_q8`` (K9) of ``squeezellm_tpu/ops/paged_attn.py``;
their bound on the H100 and how the design meets it are noted in the CUDA
source. The kernels split a slot's positions over blocks of ``CHUNK``
(:func:`splits`, a function of the page table's capacity alone) and merge
the blocks' partial softmax states in a fixed order inside the same
launch, through a workspace kept per device and shape (:func:`workspace`).
A wrapper runs its plain version for CPU tensors only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from squeezellm_tpu_torch import _build
from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.ops import kv_quant

_FLOATS = (torch.float32, torch.bfloat16)
MAX_WINDOW_TOKENS = 8  # W of a verify window the kernels take
MAX_GROUP = 8  # query heads per kv head
# positions a block reads (the row split; at most 1024, the kernel's
# bound). Timed on the H100 at 256, 512 and 1024 (chip_ab.py: K6-K9 at 8
# slots of 1024 rows and at 8 slots of the serving run's 40-330 rows; the
# readings are in PERF.md): 1024 was the fastest at 1024 rows for all four,
# one block a kv head and slot with no partials to merge, and no slower at
# 40-330 rows. Longer contexts split: a 2048-row slot takes two blocks
CHUNK = 1024


def splits(capacity: int) -> int:
    """Blocks a (kv head, slot) pair's positions are split over: a
    function of the page table's capacity (maxp * ps) alone, so that a
    slot's bits do not depend on its cohort's lengths, starts or size."""
    return -(-capacity // CHUNK)


_WORKSPACE = {}


def workspace(device, B: int, Hkv: int, R: int, hd: int, n_splits: int):
    """The partial states (f32 (B, Hkv, n_splits, R, hd) and (B, Hkv,
    n_splits, R, 2), R = g * W query rows) and the zeroed counters (int32
    (B, Hkv), reset by the kernel) of one call shape on `device`:
    allocated once, reused by every later call of that shape (one stream
    at a time)."""
    key = (torch.device(device), B, Hkv, R, hd, n_splits)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = (torch.empty((B, Hkv, n_splits, R, hd), dtype=torch.float32,
                          device=device),
              torch.empty((B, Hkv, n_splits, R, 2), dtype=torch.float32,
                          device=device),
              torch.zeros((B, Hkv), dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _rotate(x, cos, sin):
    """x (..., hd) f32 by cos/sin broadcastable to it (HF rotate-half), the
    multiply and the add rounded separately."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return x * cos + rot * sin


def _write_rows(pools, scales, rows, page_tables, pos, active):
    """Write rows[name] (B, Hkv, W, hd) f32 at positions pos (B, W) of the
    active slots through the page table, in place. Float pools cast; int8
    pools (``scales`` given) quantize each row."""
    Hkv, hd = rows[0].shape[1], rows[0].shape[3]
    ps = pools[0].shape[1]
    cap = page_tables.shape[1] * ps
    ok = active[:, None] & (pos < cap)  # (B, W)
    page = (pos.clamp(min=0) // ps).clamp(max=page_tables.shape[1] - 1)
    pid = torch.gather(page_tables.long(), 1, page)[ok]  # (n,)
    off = (pos % ps)[ok]
    for i, new in enumerate(rows):
        sel = new.transpose(1, 2)[ok]  # (n, Hkv, hd)
        if scales is None:
            pools[i][pid, off] = sel.reshape(-1, Hkv * hd).to(pools[i].dtype)
        else:
            codes, s = kv_quant.quantize_rows(sel)
            pools[i][pid, off] = codes.reshape(-1, Hkv * hd)
            scales[i][pid, :, off] = s[..., 0]


def _gather(pools, scales, page_tables, Hkv: int):
    """Each slot's pages as (B, Hkv, maxp*ps, hd) f32 k and v."""
    B, maxp = page_tables.shape
    pt = page_tables.long()
    out = []
    for i, pool in enumerate(pools):
        ps, KV = pool.shape[1], pool.shape[2]
        x = pool[pt].view(B, maxp * ps, Hkv, KV // Hkv).transpose(1, 2)
        x = x.float()
        if scales is not None:
            s = scales[i][pt]  # (B, maxp, Hkv, ps)
            x = x * s.transpose(1, 2).reshape(B, Hkv, maxp * ps, 1)
        out.append(x)
    return out


def _window_plain(q, k_new, v_new, pools, scales, page_tables, start,
                  sliding_window, rope_cos, rope_sin):
    """The shared plain body: q (B, H, W, hd), k_new/v_new (B, Hkv, W, hd),
    rope rows (B, W, hd) or None, start (B,) int (< 0: inactive).
    Returns (B, H, W, hd) f32."""
    B, H, W, hd = q.shape
    Hkv = k_new.shape[1]
    qf, kf, vf = q.float(), k_new.float(), v_new.float()
    if rope_cos is not None:
        c = rope_cos.float().reshape(B, 1, W, hd)
        s = rope_sin.float().reshape(B, 1, W, hd)
        qf, kf = _rotate(qf, c, s), _rotate(kf, c, s)
    start = start.long()
    active = start >= 0
    qpos = start[:, None] + torch.arange(W, device=q.device)  # (B, W)
    _write_rows(pools, scales, (kf, vf), page_tables, qpos, active)
    k, v = _gather(pools, scales, page_tables, Hkv)
    k = common.repeat_kv(k, H // Hkv)
    v = common.repeat_kv(v, H // Hkv)
    kpos = torch.arange(k.shape[2], device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]
    if sliding_window is not None:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - sliding_window)
    out = common.attention(qf, k, v, mask[:, None])
    return torch.where(active[:, None, None, None], out,
                       torch.zeros_like(out))


def paged_decode_attention_plain(q, k_new, v_new, pool_k, pool_v,
                                 page_tables, lengths, *,
                                 sliding_window: Optional[int] = None,
                                 rope_cos=None, rope_sin=None):
    """The plain PyTorch version of K6: gather the slot's pages, write,
    mask, softmax, in f32. q (B, H, hd) pre-rope when rope rows (B, hd)
    are given; k_new/v_new (B, Hkv, hd); lengths (B,) int, tokens per slot
    including the current one. Returns (B, H, hd) f32."""
    return _window_plain(
        q[:, :, None], k_new[:, :, None], v_new[:, :, None],
        (pool_k, pool_v), None, page_tables, lengths.long() - 1,
        sliding_window, rope_cos, rope_sin)[:, :, 0]


def paged_decode_attention_q8_plain(q, k_new, v_new, pool_k, pool_v,
                                    scale_k, scale_v, page_tables, lengths,
                                    *, sliding_window: Optional[int] = None,
                                    rope_cos=None, rope_sin=None):
    """The plain PyTorch version of K7: :func:`paged_decode_attention_plain`
    over int8 pools (P, ps, Hkv*hd) and f32 row scales (P, Hkv, ps)."""
    return _window_plain(
        q[:, :, None], k_new[:, :, None], v_new[:, :, None],
        (pool_k, pool_v), (scale_k, scale_v), page_tables,
        lengths.long() - 1, sliding_window, rope_cos, rope_sin)[:, :, 0]


def paged_verify_attention_plain(q, k_new, v_new, pool_k, pool_v,
                                 page_tables, start, *,
                                 sliding_window: Optional[int] = None,
                                 rope_cos=None, rope_sin=None):
    """The plain PyTorch version of K8. q (B, H, W, hd), k_new/v_new
    (B, Hkv, W, hd), rope rows (B, W, hd) or None, start (B,) int.
    Returns (B, H, W, hd) f32."""
    return _window_plain(q, k_new, v_new, (pool_k, pool_v), None,
                         page_tables, start, sliding_window, rope_cos,
                         rope_sin)


def paged_verify_attention_q8_plain(q, k_new, v_new, pool_k, pool_v,
                                    scale_k, scale_v, page_tables, start, *,
                                    sliding_window: Optional[int] = None,
                                    rope_cos=None, rope_sin=None):
    """The plain PyTorch version of K9."""
    return _window_plain(q, k_new, v_new, (pool_k, pool_v),
                         (scale_k, scale_v), page_tables, start,
                         sliding_window, rope_cos, rope_sin)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k_new, v_new, pools, scales, page_tables, index, rope_cos,
           rope_sin) -> int:
    """Raise on what the kernels do not take, on either device alike;
    q (B, H, W, hd). Returns the number of query heads per kv head."""
    B, H, W, hd = q.shape
    Hkv = k_new.shape[1]
    g = H // max(Hkv, 1)
    if (Hkv == 0 or g * Hkv != H or not 1 <= g <= MAX_GROUP
            or hd not in (32, 64, 128) or not 1 <= W <= MAX_WINDOW_TOKENS):
        raise ValueError(
            f"the paged attention kernels take hd in (32, 64, 128), 1..8 "
            f"query heads per kv head and windows of 1..8 tokens, got "
            f"H={H} Hkv={Hkv} hd={hd} W={W}")
    for name, t, heads in (("q", q, H), ("k_new", k_new, Hkv),
                           ("v_new", v_new, Hkv)):
        if (t.device != q.device or t.dtype != q.dtype
                or t.dtype not in _FLOATS
                or tuple(t.shape) != (B, heads, W, hd) or t.stride(3) != 1):
            raise ValueError(f"{name}: expected a {q.dtype} tensor "
                             f"(B, {heads}, W, {hd}) with contiguous rows "
                             f"on {q.device}")
    if k_new.stride() != v_new.stride():
        raise ValueError("k_new and v_new must share their strides")
    want = (torch.int8,) if scales is not None else _FLOATS
    P, ps = pools[0].shape[0], pools[0].shape[1]
    for name, t in (("pool_k", pools[0]), ("pool_v", pools[1])):
        if (t.device != q.device or t.dtype not in want
                or t.dtype != pools[0].dtype
                or tuple(t.shape) != (P, ps, Hkv * hd)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous pool "
                             f"(P, ps, {Hkv * hd}) of {want} on {q.device}")
    if scales is not None:
        for name, t in (("scale_k", scales[0]), ("scale_v", scales[1])):
            if (t.device != q.device or t.dtype != torch.float32
                    or tuple(t.shape) != (P, Hkv, ps)
                    or not t.is_contiguous()):
                raise ValueError(f"{name}: expected contiguous f32 scales "
                                 f"({P}, {Hkv}, {ps}) on {q.device}")
    if (page_tables.dtype != torch.int32 or page_tables.dim() != 2
            or page_tables.shape[0] != B or not page_tables.is_contiguous()
            or page_tables.device != q.device):
        raise ValueError("page_tables: expected contiguous int32 (B, maxp) "
                         "on the same device")
    if (index.dtype != torch.int32 or tuple(index.shape) != (B,)
            or index.device != q.device):
        raise ValueError("lengths/start: expected int32 (B,) on the same "
                         "device")
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin must be passed together")
    if rope_cos is not None:
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if (t.dtype != torch.float32 or t.numel() != B * W * hd
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name}: expected contiguous f32 "
                                 f"(B, W, hd) rope rows")
    return g


def _launch(fn_name, q, k_new, v_new, pools, scales, page_tables, index,
            sliding_window, rope_cos, rope_sin, g):
    """One launch of the entry point ``fn_name`` (the decode ones read
    ``index`` as lengths, the verify ones as starts); q (B, H, W, hd).
    Returns the token-major output buffer (B, W, H, hd) f32."""
    B, H, W, hd = q.shape
    Hkv = k_new.shape[1]
    ps, maxp = pools[0].shape[1], page_tables.shape[1]
    strides = (*q.stride()[:3], *k_new.stride()[:3])
    if max(strides) >= 2**31:
        raise ValueError(f"{fn_name}: strides exceed int32")
    window = (maxp * ps + W + 1 if sliding_window is None
              else int(sliding_window))
    out = torch.empty((B, W, H, hd), dtype=torch.float32, device=q.device)
    ws = workspace(q.device, B, Hkv, g * W, hd, splits(maxp * ps))
    cache_args = ([pools[0].data_ptr(), pools[1].data_ptr(),
                   int(pools[0].dtype == torch.bfloat16)]
                  if scales is None else
                  [pools[0].data_ptr(), pools[1].data_ptr(),
                   scales[0].data_ptr(), scales[1].data_ptr()])
    err = getattr(_build.lib(), fn_name)(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), *strides,
        int(q.dtype == torch.bfloat16),
        rope_cos.data_ptr() if rope_cos is not None else None,
        rope_sin.data_ptr() if rope_cos is not None else None,
        *cache_args, page_tables.data_ptr(), index.data_ptr(),
        out.data_ptr(), *(t.data_ptr() for t in ws), B, W, ps, maxp, Hkv,
        g, hd, window, 1.0 / math.sqrt(hd), CHUNK,
        _build.stream_ptr(q.device))
    _build.check(err, fn_name)
    return out


def _make(name, number, fn_name, q8, decode):
    """The wrapper of one entry point: refuse what the kernel does not take,
    run the plain version for CPU tensors, else launch ``fn_name`` and count
    the launch in the wrapper's own ``launches``. The int8 twins take the
    two scale tensors after the pools; the decode ones take one token per
    slot (q (B, H, hd)) and lengths where the verify ones take a window
    (q (B, H, W, hd)) and starts."""
    plain = globals()[name + "_plain"]

    def wrapper(q, k_new, v_new, pool_k, pool_v, *rest,
                sliding_window: Optional[int] = None, rope_cos=None,
                rope_sin=None):
        if len(rest) != (4 if q8 else 2):
            raise TypeError(f"{name}: expected {9 if q8 else 7} tensors")
        scales = tuple(rest[:2]) if q8 else None
        page_tables, index = rest[-2:]
        # a decode token is a one-token window (B, heads, 1, hd)
        qw, kw, vw = ((t[:, :, None] for t in (q, k_new, v_new)) if decode
                      else (q, k_new, v_new))
        g = _check(qw, kw, vw, (pool_k, pool_v), scales, page_tables, index,
                   rope_cos, rope_sin)
        if q.device.type == "cpu":
            return plain(q, k_new, v_new, pool_k, pool_v, *rest,
                         sliding_window=sliding_window, rope_cos=rope_cos,
                         rope_sin=rope_sin)
        if q.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {q.device}")
        out = _launch(fn_name, qw, kw, vw, (pool_k, pool_v), scales,
                      page_tables, index, sliding_window, rope_cos, rope_sin,
                      g)
        wrapper.launches += 1
        return out[:, 0] if decode else out.transpose(1, 2)

    wrapper.launches = 0
    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (
        f"K{number} on CUDA tensors, its plain version "
        f"(:func:`{name}_plain`, which has the shapes) on CPU tensors. "
        f"q, k_new and v_new are f32 or bf16 with a contiguous last dim "
        f"(head-major views of a token-major projection need no copy), "
        f"rope rows f32; the pools"
        + (", int8 with f32 row scales (P, Hkv, ps)," if q8 else "")
        + f" are contiguous and updated in place; page_tables (B, maxp) "
        f"and the {'lengths' if decode else 'starts'} (B,) are int32. "
        + ("Returns (B, H, hd) f32. " if decode else
           "The slot's pages must cover ``start + W`` rows. Returns "
           "(B, H, W, hd) f32, a view of a token-major buffer on the card. ")
        + f"Counts its launches in ``{name}.launches``.")
    return wrapper


paged_decode_attention = _make(
    "paged_decode_attention", 6, "slt_paged_decode_attn", False, True)
paged_decode_attention_q8 = _make(
    "paged_decode_attention_q8", 7, "slt_paged_decode_attn_q8", True, True)
paged_verify_attention = _make(
    "paged_verify_attention", 8, "slt_paged_verify_attn", False, False)
paged_verify_attention_q8 = _make(
    "paged_verify_attention_q8", 9, "slt_paged_verify_attn_q8", True, False)
