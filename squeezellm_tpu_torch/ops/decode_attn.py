"""K2 and K5: dense decode attention with rope and the cache write fused
in, over an f32/bf16 cache (K2) or an int8 cache with row scales (K5).

For one token per slot: rope q and k_new from the passed cos/sin rows
(the model's ``rope_cos_sin`` values), write k/v into the token-major
(B, S, Hkv*hd) cache at row ``n - 1`` with ``n = min(len, S)``, then
attend rows ``[max(n - window, 0), n)`` with GQA; a slot of length 0
writes nothing and outputs zeros. The current token enters attention as
the cache holds it (rounded to the cache dtype).

K5 (``decode_attention_q8``) does the same over int8 codes (B, S, Hkv*hd)
with f32 row scales (B, Hkv, S): it quantizes the roped k row and the v
row with the ``ops/kv_quant.py`` math, writes codes and scales at row
``n - 1``, and attends the prefix as stored (code times scale, the current
token included).

The CUDA kernels (``csrc/decode_attn.cu``, one template over the cache
type) replace the TPU kernels ``_dense_attn_kernel`` (K2) and
``_dense_attn_kernel_q8`` (K5) of ``squeezellm_tpu/ops/decode_attn.py``
(``dense_decode_attention`` and ``dense_decode_attention_q8``); their
bound on the H100 and how the design meets it are noted in the CUDA
source. The kernels split a slot's rows over blocks of ``CHUNK`` cache
rows (:func:`splits`, a function of the cache's capacity alone) and merge
the blocks' partial softmax states in a fixed order inside the same
launch, through a workspace the wrapper keeps per device and shape
(:func:`workspace`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from squeezellm_tpu_torch import _build
from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.ops import kv_quant

_FLOATS = (torch.float32, torch.bfloat16)
# cache rows a block reads (the row split); at 2048 rows a LLaMA-2-7B
# decode step's kernel runs 8 blocks a kv head, 256 at batch 1. Timed on
# the H100 at 2048 rows (chip_smoke.py check_k2): 256 rows a block beat 128
# and 64, whose extra blocks cost more in merging than they gained
CHUNK = 256


def splits(S: int) -> int:
    """Blocks a (kv head, slot) pair's rows are split over: a function of
    the cache's capacity S alone, so that a slot's bits do not depend on
    its cohort's lengths or size."""
    return -(-S // CHUNK)


_WORKSPACE = {}


def workspace(device, B: int, Hkv: int, g: int, hd: int, S: int):
    """The partial states (f32 (B, Hkv, splits, g, hd) and (B, Hkv, splits,
    g, 2)) and the zeroed tile counters (int32 (B, Hkv), reset by the
    kernel) of one call shape on `device`: allocated once, reused by every
    later call of that shape (one stream at a time)."""
    key = (device, B, Hkv, g, hd, splits(S))
    ws = _WORKSPACE.get(key)
    if ws is None:
        sp = splits(S)
        ws = (torch.empty((B, Hkv, sp, g, hd), dtype=torch.float32,
                          device=device),
              torch.empty((B, Hkv, sp, g, 2), dtype=torch.float32,
                          device=device),
              torch.zeros((B, Hkv), dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def decode_attention_plain(q, k_new, v_new, ck, cv, lengths, *,
                           sliding_window: Optional[int] = None,
                           rope_cos: Optional[torch.Tensor] = None,
                           rope_sin: Optional[torch.Tensor] = None):
    """The plain PyTorch version of K2. Returns (B, H, hd) f32 and updates
    ck/cv in place. q (B, H, hd) pre-rope when rope rows (B, hd) are
    given; k_new/v_new (B, Hkv, hd); lengths (B,) int, tokens per slot
    including the current one."""
    B, Hkv, hd = k_new.shape
    qf, kf = _rope(q, k_new, rope_cos, rope_sin)
    n = lengths.long().clamp(max=ck.shape[1])
    active = n > 0
    row = (n - 1).clamp(min=0)
    b_idx = torch.arange(B, device=ck.device)
    # an inactive slot writes its own row back: no change
    keep = [torch.where(active[:, None], new.reshape(B, -1).to(c.dtype),
                        c[b_idx, row]).view(B, 1, Hkv, hd)
            for c, new in ((ck, kf), (cv, v_new))]
    cache = common.update_kv_cache({"k": ck, "v": cv}, *keep, row)
    return _attend(qf, cache, n, Hkv, sliding_window)


def decode_attention_q8_plain(q, k_new, v_new, ck, cv, sk, sv, lengths, *,
                              sliding_window: Optional[int] = None,
                              rope_cos: Optional[torch.Tensor] = None,
                              rope_sin: Optional[torch.Tensor] = None):
    """The plain PyTorch version of K5: :func:`decode_attention_plain`
    over int8 codes ck/cv (B, S, Hkv*hd) and f32 row scales sk/sv
    (B, Hkv, S), all updated in place."""
    B = q.shape[0]
    Hkv = k_new.shape[1]
    qf, kf = _rope(q, k_new, rope_cos, rope_sin)
    n = lengths.long().clamp(max=ck.shape[1])
    active = n > 0
    row = (n - 1).clamp(min=0)
    b_idx = torch.arange(B, device=ck.device)
    for codes_c, scale_c, new in ((ck, sk, kf), (cv, sv, v_new)):
        codes, scale = kv_quant.quantize_rows(new)  # (B,Hkv,hd), (B,Hkv,1)
        # an inactive slot writes its own row back: no change
        codes_c[b_idx, row] = torch.where(
            active[:, None], codes.reshape(B, -1), codes_c[b_idx, row])
        scale_c[b_idx, :, row] = torch.where(
            active[:, None], scale[..., 0], scale_c[b_idx, :, row])
    cache = {"k": ck, "v": cv, "ks": sk, "vs": sv}
    return _attend(qf, cache, n, Hkv, sliding_window)


def _rope(q, k_new, rope_cos, rope_sin):
    """q and k_new in f32, rotated by the (B, hd) rope rows when given."""
    B, _, hd = q.shape
    qf, kf = q.float(), k_new.float()
    if rope_cos is not None:
        c = rope_cos.float().reshape(B, 1, hd)
        s = rope_sin.float().reshape(B, 1, hd)
        qf = common.apply_rope_tm(qf[:, None], c, s)[:, 0]
        kf = common.apply_rope_tm(kf[:, None], c, s)[:, 0]
    return qf, kf


def _attend(qf, cache, n, Hkv: int, sliding_window):
    """Attention of qf (B, H, hd) over the cache's rows
    [max(n - window, 0), n) as stored; zeros for a slot with n == 0."""
    H = qf.shape[1]
    k, v = common.read_kv(cache, torch.float32, Hkv)
    k = common.repeat_kv(k, H // Hkv)
    v = common.repeat_kv(v, H // Hkv)
    mask = common.decode_mask(cache["k"].shape[1], n - 1, sliding_window)
    out = common.attention(qf[:, :, None, :], k, v, mask)[:, :, 0]
    return torch.where((n > 0)[:, None, None], out, torch.zeros_like(out))


def decode_attention(q, k_new, v_new, ck, cv, lengths, *,
                     sliding_window: Optional[int] = None,
                     rope_cos: Optional[torch.Tensor] = None,
                     rope_sin: Optional[torch.Tensor] = None):
    """K2 on CUDA tensors, its plain version on CPU tensors.

    q (B, H, hd) and k_new/v_new (B, Hkv, hd) in f32 or bf16 with
    contiguous rows (any batch stride); rope rows (B, hd) f32 or None;
    ck/cv (B, S, Hkv*hd) f32 or bf16, contiguous, updated in place;
    lengths (B,) int32. Returns (B, H, hd) f32. Counts its launches in
    ``decode_attention.launches``, those without rope rows (OPT) also in
    ``decode_attention.ropeless_launches``."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_new, v_new, ck, cv, lengths, sliding_window=sliding_window,
            rope_cos=rope_cos, rope_sin=rope_sin)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    Hkv = k_new.shape[1]
    S = ck.shape[1]
    g = _check_operands(q, k_new, v_new, ck, cv, _FLOATS, lengths, rope_cos,
                        rope_sin)
    window = S + 1 if sliding_window is None else int(sliding_window)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    ws = workspace(q.device, B, Hkv, g, hd, S)
    err = _build.lib().slt_decode_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), q.stride(0),
        k_new.stride(0), int(q.dtype == torch.bfloat16),
        rope_cos.data_ptr() if rope_cos is not None else None,
        rope_sin.data_ptr() if rope_cos is not None else None,
        ck.data_ptr(), cv.data_ptr(), int(ck.dtype == torch.bfloat16),
        lengths.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in ws), B,
        S, Hkv, g, hd, window, 1.0 / math.sqrt(hd), CHUNK,
        _build.stream_ptr(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    decode_attention.ropeless_launches += rope_cos is None
    return out


decode_attention.launches = 0
decode_attention.ropeless_launches = 0


def decode_attention_q8(q, k_new, v_new, ck, cv, sk, sv, lengths, *,
                        sliding_window: Optional[int] = None,
                        rope_cos: Optional[torch.Tensor] = None,
                        rope_sin: Optional[torch.Tensor] = None):
    """K5 on CUDA tensors, its plain version on CPU tensors.

    q, k_new, v_new, lengths and the rope rows as :func:`decode_attention`
    takes them; ck/cv (B, S, Hkv*hd) int8 and sk/sv (B, Hkv, S) f32,
    contiguous, updated in place (any S). Returns (B, H, hd) f32. Counts
    its launches in ``decode_attention_q8.launches``."""
    if q.device.type == "cpu":
        return decode_attention_q8_plain(
            q, k_new, v_new, ck, cv, sk, sv, lengths,
            sliding_window=sliding_window, rope_cos=rope_cos,
            rope_sin=rope_sin)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_q8: unsupported device "
                         f"{q.device}")
    B, H, hd = q.shape
    Hkv = k_new.shape[1]
    S = ck.shape[1]
    g = _check_operands(q, k_new, v_new, ck, cv, (torch.int8,), lengths,
                        rope_cos, rope_sin)
    for name, t in (("sk", sk), ("sv", sv)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (B, Hkv, S) or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous f32 scales "
                             f"(B, {Hkv}, {S}) on {q.device}")
    window = S + 1 if sliding_window is None else int(sliding_window)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    ws = workspace(q.device, B, Hkv, g, hd, S)
    err = _build.lib().slt_decode_attn_q8(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), q.stride(0),
        k_new.stride(0), int(q.dtype == torch.bfloat16),
        rope_cos.data_ptr() if rope_cos is not None else None,
        rope_sin.data_ptr() if rope_cos is not None else None,
        ck.data_ptr(), cv.data_ptr(), sk.data_ptr(), sv.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in ws), B,
        S, Hkv, g, hd, window, 1.0 / math.sqrt(hd), CHUNK,
        _build.stream_ptr(q.device))
    _build.check(err, "decode_attention_q8")
    decode_attention_q8.launches += 1
    return out


decode_attention_q8.launches = 0


def _check_operands(q, k_new, v_new, ck, cv, cache_dtypes, lengths, rope_cos,
                    rope_sin) -> int:
    """Raise on what the kernels do not take; returns the number of query
    heads per kv head."""
    B, H, hd = q.shape
    Hkv = k_new.shape[1]
    S = ck.shape[1]
    g = H // Hkv
    if g * Hkv != H or not 1 <= g <= 8 or hd not in (32, 64, 128):
        raise ValueError(f"the decode attention kernels take hd in (32, 64, "
                         f"128) and 1..8 query heads per kv head, got "
                         f"H={H} Hkv={Hkv} hd={hd}")
    for name, t, heads in (("q", q, H), ("k_new", k_new, Hkv),
                           ("v_new", v_new, Hkv)):
        if (t.device != q.device or t.dtype != q.dtype
                or t.dtype not in _FLOATS or tuple(t.shape) != (B, heads, hd)
                or t.stride(2) != 1 or t.stride(1) != hd):
            raise ValueError(f"{name}: expected a {q.dtype} CUDA tensor "
                             f"(B, {heads}, {hd}) with contiguous rows")
    if k_new.stride(0) != v_new.stride(0):
        raise ValueError("k_new and v_new must share their batch stride")
    for name, t in (("ck", ck), ("cv", cv)):
        if (t.device != q.device or t.dtype != ck.dtype
                or t.dtype not in cache_dtypes
                or tuple(t.shape) != (B, S, Hkv * hd)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous cache "
                             f"(B, S, {Hkv * hd}) of {cache_dtypes} on "
                             f"{q.device}")
    if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,)
            or lengths.device != q.device):
        raise ValueError("lengths: expected int32 (B,) on the same device")
    if rope_cos is not None:
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if (t.dtype != torch.float32 or tuple(t.shape) != (B, hd)
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name}: expected contiguous f32 (B, hd)")
    return g
