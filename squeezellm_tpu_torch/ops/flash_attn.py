"""K3: causal flash attention for a prefill window.

``flash_attention(q, k, v, offset)`` keeps the JAX function's layout:
q (B, H, Sq, hd) at positions ``[offset, offset + Sq)``, k/v
(B, Hkv, Sk, hd) holding the window itself or the whole cache (only rows
``< offset + Sq`` are read), out (B, H, Sq, hd) f32. Masks
``kpos <= qpos`` and ``kpos > qpos - window``; GQA by ``h // g``. Any Sq
and Sk (the kernel masks the ragged edge).

The CUDA kernels (``csrc/flash_attn.cu``) replace the TPU kernel
``_flash_kernel`` of ``squeezellm_tpu/ops/flash_attn.py``
(``flash_attention``); their bound on the H100 and how the designs meet
it are noted in the CUDA source. ``mode`` picks the regime, as it picks
K1's: ``"bf16"`` with q, k and v all bf16 runs both products on the
tensor cores (p rounded to bf16 before p.v: within 2**-8 of max |v| of
the plain version), every other call the exact regime's f32-FMA kernel
(within 1e-4). Both read q, k and v through their strides, so head-major
views of the token-major cache need no copy, and write a token-major
buffer that the caller reshapes for free. The offset is a python int or
an int tensor of one element on q's device; the kernels read it from
device memory, as the TPU kernel reads its scalar-prefetched offset, so a
launch captured in a CUDA graph serves whatever position the tensor holds
at each replay.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from squeezellm_tpu_torch import _build
from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.ops.lut_matmul import grown

_FLOATS = (torch.float32, torch.bfloat16)
MODES = ("exact", "bf16")


# per device, int32 0, 1, 2, ...: a python int offset is read from its
# entry, so an int costs the launch no allocation and no copy
_OFFSETS = {}


def _offset_tensor(offset, device) -> torch.Tensor:
    """The offset as the kernels read it: one int32 on `device` (for a
    python int, a view of its entry in the device's table)."""
    if not torch.is_tensor(offset):
        if offset < 0:
            raise ValueError(f"offset must be >= 0, got {offset}")
        table = grown(_OFFSETS, device, offset + 1, lambda m: torch.arange(
            max(m, 1 << 16), dtype=torch.int32, device=device))
        return table[offset: offset + 1]
    if offset.numel() != 1 or offset.device != device or (
            offset.dtype.is_floating_point or offset.dtype.is_complex):
        raise ValueError("offset must be an int or an int tensor of one "
                         f"element on {device}")
    return offset.reshape(1).to(torch.int32)


def flash_attention_plain(q, k, v, offset, *,
                          sliding_window: Optional[int] = None,
                          mode: str = "exact"):
    """The plain PyTorch version of K3: (B, H, Sq, hd) f32, with f32
    products in either mode (the reference both regimes are held to).
    offset: an int, or an int tensor of one element (the causal mask is
    then built on the device)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if torch.is_tensor(offset):
        offset = _offset_tensor(offset, q.device).reshape(()).long()
    H, Sq = q.shape[1], q.shape[2]
    Hkv, Sk = k.shape[1], k.shape[2]
    kk = common.repeat_kv(k.float(), H // Hkv)
    vv = common.repeat_kv(v.float(), H // Hkv)
    mask = common.causal_mask(Sq, Sk, offset, sliding_window, q.device)
    return common.attention(q.float(), kk, vv, mask)


def flash_attention(q, k, v, offset, *,
                    sliding_window: Optional[int] = None,
                    mode: str = "exact"):
    """K3 on CUDA tensors, its plain version on CPU tensors.

    q f32/bf16 and k/v f32/bf16 (k and v sharing dtype and strides), each
    with a contiguous last dim; offset a python int (>= 0) or an int
    tensor of one element on q's device, read by the kernel; mode "bf16"
    with all
    three bf16 takes the tensor-core kernel (which also needs 16-byte
    aligned data and row strides in multiples of 8 elements), any other
    call the f32-FMA kernel. Returns (B, H, Sq, hd) f32 (a view of a
    token-major buffer on the card). Counts its launches in
    ``flash_attention.launches`` and by regime in
    ``flash_attention.regime_launches``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, offset,
                                     sliding_window=sliding_window,
                                     mode=mode)
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
    off = _offset_tensor(offset, q.device)
    window = Sk + Sq + 1 if sliding_window is None else int(sliding_window)
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3],
               out.stride(0), out.stride(2), out.stride(1))
    if max(strides) >= 2**31:
        raise ValueError("flash_attention kernel: strides exceed int32")
    regime = ("bf16" if mode == "bf16" and q.dtype == torch.bfloat16
              and k.dtype == torch.bfloat16 else "exact")
    if regime == "bf16" and (
            any(t.data_ptr() % 16 for t in (q, k, v))
            or any(st % 8 for st in strides[:6])):
        raise ValueError("flash_attention tensor-core kernel: q, k and v "
                         "need 16-byte aligned data and row, head and batch "
                         "strides in multiples of 8 elements")
    err = _build.lib().slt_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        int(regime == "bf16"), B, H, Hkv, Sq, Sk, hd, off.data_ptr(), window,
        1.0 / math.sqrt(hd), _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.regime_launches[regime] += 1
    return out.transpose(1, 2)


flash_attention.launches = 0
flash_attention.regime_launches = dict.fromkeys(MODES, 0)
