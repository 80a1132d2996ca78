"""K3: causal flash attention for a prefill window.

``flash_attention(q, k, v, offset)`` keeps the JAX function's layout:
q (B, H, Sq, hd) at positions ``[offset, offset + Sq)``, k/v
(B, Hkv, Sk, hd) holding the window itself or the whole cache (only rows
``< offset + Sq`` are read), out (B, H, Sq, hd) f32. Masks
``kpos <= qpos`` and ``kpos > qpos - window``; GQA by ``h // g``. Any Sq
and Sk (the kernel masks the ragged edge).

The CUDA kernel (``csrc/flash_attn.cu``) replaces the TPU kernel
``_flash_kernel`` of ``squeezellm_tpu/ops/flash_attn.py``
(``flash_attention``); its bound on the H100 and how the design meets it
are noted in the CUDA source. It reads q, k and v through their strides,
so head-major views of the token-major cache need no copy, and writes a
token-major buffer that the caller reshapes for free.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from squeezellm_tpu_torch import _build
from squeezellm_tpu_torch.models import common

_FLOATS = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, offset: int, *,
                          sliding_window: Optional[int] = None):
    """The plain PyTorch version of K3: (B, H, Sq, hd) f32."""
    H, Sq = q.shape[1], q.shape[2]
    Hkv, Sk = k.shape[1], k.shape[2]
    kk = common.repeat_kv(k.float(), H // Hkv)
    vv = common.repeat_kv(v.float(), H // Hkv)
    mask = common.causal_mask(Sq, Sk, offset, sliding_window, q.device)
    return common.attention(q.float(), kk, vv, mask)


def flash_attention(q, k, v, offset: int, *,
                    sliding_window: Optional[int] = None):
    """K3 on CUDA tensors, its plain version on CPU tensors.

    q f32/bf16 and k/v f32/bf16 (k and v sharing dtype and strides), each
    with a contiguous last dim; offset a python int. Returns
    (B, H, Sq, hd) f32 (a view of a token-major buffer on the card).
    Counts its launches in ``flash_attention.launches``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, offset,
                                     sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if (Hkv == 0 or H % Hkv or hd not in (32, 64, 128)
            or tuple(k.shape) != (B, Hkv, Sk, hd)
            or tuple(v.shape) != tuple(k.shape)):
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "(hd in 32, 64, 128; H a multiple of Hkv)")
    if (q.dtype not in _FLOATS or k.dtype not in _FLOATS
            or v.dtype != k.dtype or k.stride() != v.stride()
            or q.stride(3) != 1 or k.stride(3) != 1
            or k.device != q.device or v.device != q.device):
        raise ValueError("flash_attention kernel: q, k, v must be f32/bf16 "
                         "CUDA tensors with a contiguous last dim; k and v "
                         "share dtype and strides")
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    window = Sk + Sq + 1 if sliding_window is None else int(sliding_window)
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3],
               out.stride(0), out.stride(2), out.stride(1))
    if max(strides) >= 2**31:
        raise ValueError("flash_attention kernel: strides exceed int32")
    err = _build.lib().slt_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        B, H, Hkv, Sq, Sk, hd, int(offset), window, 1.0 / math.sqrt(hd),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0
