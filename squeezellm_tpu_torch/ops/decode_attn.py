"""K2: dense decode attention with rope and the cache write fused in.

For one token per slot: rope q and k_new from the passed cos/sin rows
(the model's ``rope_cos_sin`` values), write k/v into the token-major
(B, S, Hkv*hd) cache at row ``n - 1`` with ``n = min(len, S)``, then
attend rows ``[max(n - window, 0), n)`` with GQA; a slot of length 0
writes nothing and outputs zeros. The current token enters attention as
the cache holds it (rounded to the cache dtype).

The CUDA kernel (``csrc/decode_attn.cu``) replaces the TPU kernel
``_dense_attn_kernel`` of ``squeezellm_tpu/ops/decode_attn.py``
(``dense_decode_attention``); its bound on the H100 and how the design
meets it are noted in the CUDA source.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from squeezellm_tpu_torch import _build
from squeezellm_tpu_torch.models import common

_FLOATS = (torch.float32, torch.bfloat16)


def decode_attention_plain(q, k_new, v_new, ck, cv, lengths, *,
                           sliding_window: Optional[int] = None,
                           rope_cos: Optional[torch.Tensor] = None,
                           rope_sin: Optional[torch.Tensor] = None):
    """The plain PyTorch version of K2. Returns (B, H, hd) f32 and updates
    ck/cv in place. q (B, H, hd) pre-rope when rope rows (B, hd) are
    given; k_new/v_new (B, Hkv, hd); lengths (B,) int, tokens per slot
    including the current one."""
    B, H, hd = q.shape
    Hkv = k_new.shape[1]
    S = ck.shape[1]
    qf, kf = q.float(), k_new.float()
    if rope_cos is not None:
        c = rope_cos.float().reshape(B, 1, hd)
        s = rope_sin.float().reshape(B, 1, hd)
        qf = common.apply_rope_tm(qf[:, None], c, s)[:, 0]
        kf = common.apply_rope_tm(kf[:, None], c, s)[:, 0]
    n = lengths.long().clamp(max=S)
    active = n > 0
    row = (n - 1).clamp(min=0)
    b_idx = torch.arange(B, device=ck.device)
    # an inactive slot writes its own row back: no change
    keep = [torch.where(active[:, None], new.reshape(B, -1).to(c.dtype),
                        c[b_idx, row]).view(B, 1, Hkv, hd)
            for c, new in ((ck, kf), (cv, v_new))]
    cache = common.update_kv_cache({"k": ck, "v": cv}, *keep, row)
    k, v = common.read_kv(cache, torch.float32, Hkv)
    k = common.repeat_kv(k, H // Hkv)
    v = common.repeat_kv(v, H // Hkv)
    mask = common.decode_mask(S, n - 1, sliding_window)
    out = common.attention(qf[:, :, None, :], k, v, mask)[:, :, 0]
    return torch.where(active[:, None, None], out, torch.zeros_like(out))


def decode_attention(q, k_new, v_new, ck, cv, lengths, *,
                     sliding_window: Optional[int] = None,
                     rope_cos: Optional[torch.Tensor] = None,
                     rope_sin: Optional[torch.Tensor] = None):
    """K2 on CUDA tensors, its plain version on CPU tensors.

    q (B, H, hd) and k_new/v_new (B, Hkv, hd) in f32 or bf16 with
    contiguous rows (any batch stride); rope rows (B, hd) f32 or None;
    ck/cv (B, S, Hkv*hd) f32 or bf16, contiguous, updated in place;
    lengths (B,) int32. Returns (B, H, hd) f32. Counts its launches in
    ``decode_attention.launches``."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_new, v_new, ck, cv, lengths, sliding_window=sliding_window,
            rope_cos=rope_cos, rope_sin=rope_sin)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    Hkv = k_new.shape[1]
    S = ck.shape[1]
    g = H // Hkv
    if g * Hkv != H or not 1 <= g <= 8 or hd not in (32, 64, 128):
        raise ValueError(f"decode_attention kernel takes hd in (32, 64, "
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
                or t.dtype not in _FLOATS or tuple(t.shape) != (B, S, Hkv * hd)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous f32/bf16 cache "
                             f"(B, S, {Hkv * hd}) on {q.device}")
    if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,)
            or lengths.device != q.device):
        raise ValueError("lengths: expected int32 (B,) on the same device")
    if rope_cos is not None:
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if (t.dtype != torch.float32 or tuple(t.shape) != (B, hd)
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name}: expected contiguous f32 (B, hd)")
    window = S + 1 if sliding_window is None else int(sliding_window)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    err = _build.lib().slt_decode_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), q.stride(0),
        k_new.stride(0), int(q.dtype == torch.bfloat16),
        rope_cos.data_ptr() if rope_cos is not None else None,
        rope_sin.data_ptr() if rope_cos is not None else None,
        ck.data_ptr(), cv.data_ptr(), int(ck.dtype == torch.bfloat16),
        lengths.data_ptr(), out.data_ptr(), B, S, Hkv, g, hd, window,
        1.0 / math.sqrt(hd), _build.stream_ptr(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
