"""Per-row int8 KV-cache quantization: the one definition of the math.

The counterpart of the JAX package's ``ops/kv_quant.py`` (``quantize_rows``
and ``dequantize_rows``; the port keeps its own copy of the constants). One
f32 scale per (token row, kv head): ``s = max(max|row| * f32(1/127),
1e-12)``, ``q = clip(round_half_even(row / s), -127, 127)``. The scale is a
MULTIPLY by the f32-rounded reciprocal (a divide by 127 is 1 ulp off) and
the codes a true f32 divide; K5 (``csrc/decode_attn.cu``) inlines the same
expressions and must produce the same bits, as do K7 and K9
(``csrc/paged_attn.cu``).

A page pool keeps its scales head-major per page, ``(P, Hkv, ps)``: a
head's scales contiguous along the page's tokens, exactly ``Hkv`` rows (the
JAX package pads them to 8 for the TPU's f32 tile).
"""

from __future__ import annotations

import torch

QMAX = 127.0
RQMAX = 1.0 / 127.0  # rounded to f32 where it multiplies the f32 row maximum
EPS = 1e-12  # scale of an all-zero row (its codes are 0)


def quantize_rows(x: torch.Tensor):
    """Quantize along the last axis: x (..., hd) f32/bf16 ->
    (codes int8 (..., hd), scale f32 (..., 1))."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1, keepdim=True) * RQMAX).clamp_min(EPS)
    q = torch.round(xf / s).clamp(-QMAX, QMAX).to(torch.int8)
    return q, s


def dequantize_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (up to rounding): int8 (..., hd)
    times f32 (..., 1) -> f32."""
    return q.float() * s


def pool_pack_scales(s: torch.Tensor) -> torch.Tensor:
    """Row scales (..., ps, Hkv, 1) of token-major pages (from
    :func:`quantize_rows` on (..., ps, Hkv, hd)) -> the pool's head-major
    sidecar (..., Hkv, ps)."""
    return s[..., 0].transpose(-1, -2)


def pool_unpack_scales(sc: torch.Tensor) -> torch.Tensor:
    """The pool's sidecar (..., Hkv, ps) -> row scales (..., ps, Hkv, 1)."""
    return sc.transpose(-1, -2)[..., None]
