"""K12: the standalone CSR sparse sum ``y[b, r] = sum_e vals[e] *
x[b, cols[e]]`` over a linear's sparse sidecar, for 1..1023 rows, f32.

The port's counterpart of the JAX package's separate sparse launch
``gather_spmv`` (``squeezellm_tpu/ops/pallas_ops.py``): its grouped kernel
``_spmv_kernel_grouped`` and its classic ``_spmv_kernel``. Those read a
slot plan (``ops/spmv.py`` of the JAX package), a TPU layout the port does
not build; the CUDA kernel (``csrc/spmv.cu``) reads the CSR sidecar
itself, in a fixed order with no atomics. ``quant_linear`` takes it for
the transposed 4-bit decode (K11 folds no sidecar); every other row band
folds the sidecar into K1, K4 or K10. x is read as it is (f32, or bf16
widened): the sum never rounds x, as ``gather_spmv`` does not.
"""

from __future__ import annotations

import torch

from squeezellm_tpu_torch import _build
from squeezellm_tpu_torch.ops import plain_ops
from squeezellm_tpu_torch.ops.lut_matmul import MAX_ROWS, _check


def spmv_plain(x: torch.Tensor, rowptr: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor, out_features: int) -> torch.Tensor:
    """The plain PyTorch version of K12: (B, out) f32."""
    return plain_ops.sparse_matmul(x, rowptr, cols, vals, out_features)


def spmv(x: torch.Tensor, rowptr: torch.Tensor, cols: torch.Tensor,
         vals: torch.Tensor, out_features: int) -> torch.Tensor:
    """K12 on a CUDA tensor, its plain version on a CPU tensor.

    x: (B, in) f32 or bf16, B in 1..1023; rowptr int32 (out + 1,), cols
    int32 (nnz,), vals f32 (nnz,); all contiguous. Returns (B, out) f32.
    Counts its launches in ``spmv.launches``."""
    dev = x.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"spmv: unsupported device {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"spmv takes x (1..{MAX_ROWS}, in), got "
                         f"{tuple(x.shape)}")
    B, in_f = x.shape
    _check(x, (B, in_f), (torch.float32, torch.bfloat16), "x", dev)
    _check(rowptr, (out_features + 1,), (torch.int32,), "rowptr", dev)
    _check(cols, cols.shape, (torch.int32,), "cols", dev)
    _check(vals, cols.shape, (torch.float32,), "vals", dev)
    if dev == "cpu":
        return spmv_plain(x, rowptr, cols, vals, out_features)
    y = torch.empty((B, out_features), dtype=torch.float32, device=x.device)
    err = _build.lib().slt_spmv(
        x.data_ptr(), int(x.dtype == torch.bfloat16), rowptr.data_ptr(),
        cols.data_ptr(), vals.data_ptr(), y.data_ptr(), B, in_f,
        out_features, _build.stream_ptr(x.device))
    _build.check(err, "spmv")
    spmv.launches += 1
    return y


spmv.launches = 0
