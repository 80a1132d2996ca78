"""K12: the standalone CSR sparse sum ``s[b, r] = sum_e vals[e] *
x[b, cols[e]]`` over a linear's sparse sidecar, for 1..1023 rows, f32,
written to a fresh tensor or folded in place into an accumulator:
``y = (y + y0) + s``.

The port's counterpart of the JAX package's separate sparse launch
``gather_spmv`` (``squeezellm_tpu/ops/pallas_ops.py``): its grouped kernel
``_spmv_kernel_grouped`` and its classic ``_spmv_kernel``. Those read a
slot plan (``ops/spmv.py`` of the JAX package), a TPU layout the port does
not build; the CUDA kernel (``csrc/spmv.cu``) reads the CSR sidecar
itself: :func:`group_size` lanes share a CSR row, reading its entries
coalesced with several in flight, and a fixed butterfly sums their
partials, so a row's result does not depend on the rows beside it and
there are no atomics. ``quant_linear`` takes it for the transposed 4-bit
decode (K11 folds no sidecar), in place on K11's output with the residual
``y0``, so the route's two adds cost no launch of their own; every other
row band folds the sidecar into K1, K4 or K10. x is read as it is (f32, or
bf16 widened): the sum never rounds x, as ``gather_spmv`` does not.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from squeezellm_tpu_torch import _build
from squeezellm_tpu_torch.ops import plain_ops
from squeezellm_tpu_torch.ops.lut_matmul import MAX_ROWS, _check, grown

# entries a lane has in flight (kUnroll in csrc/spmv.cu); group_size reads
# it to pick G, so a mismatch would cost speed, never a wrong sum
UNROLL = 4


@functools.lru_cache(maxsize=None)
def group_size(nnz: int, out_features: int) -> int:
    """Lanes a CSR row: the fewest of 8, 16, 32 that give a mean row at
    most UNROLL entries a lane, one round of loads. A function of the
    sidecar's shape only."""
    mean = nnz / max(out_features, 1)
    return next((g for g in (8, 16) if mean <= g * UNROLL), 32)


def tile_rows(B: int) -> int:
    """Batch rows a launch's tile (MT in csrc/spmv.cu). From 2 rows the
    kernel first copies x into (tiles, in, MT) scratch, so that an entry's
    x values of a tile are one vector load."""
    return 1 if B <= 1 else 2 if B <= 2 else 4 if B <= 4 else 8


_WORKSPACE = {}


def _workspace(device, nbytes: int) -> torch.Tensor:
    """Bytes on `device` for the copy of x, kept between calls: each call
    writes them and reads them back in stream order."""
    return grown(_WORKSPACE, device, nbytes, lambda m: torch.empty(
        m, dtype=torch.uint8, device=device))


def spmv_plain(x: torch.Tensor, rowptr: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor, out_features: int,
               y: Optional[torch.Tensor] = None,
               y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of K12: the sum as a fresh (B, out) f32,
    or, given y, ``y = (y + y0) + sum`` in place (y0 optional, widened)."""
    s = plain_ops.sparse_matmul(x, rowptr, cols, vals, out_features)
    if y is None:
        if y0 is not None:
            raise ValueError("spmv: y0 is folded into y, which is missing")
        return s
    if y0 is not None:
        y.add_(y0.float())
    return y.add_(s)


def spmv(x: torch.Tensor, rowptr: torch.Tensor, cols: torch.Tensor,
         vals: torch.Tensor, out_features: int,
         y: Optional[torch.Tensor] = None,
         y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K12 on a CUDA tensor, its plain version on a CPU tensor.

    x: (B, in) f32 or bf16, B in 1..1023; rowptr int32 (out + 1,), cols
    int32 (nnz,), vals f32 (nnz,). Without y returns the sum, (B, out)
    f32; with y (B, out) f32 folds ``y = (y + y0) + sum`` into it in place
    and returns it, y0 (B, out) f32 or bf16 or None. All contiguous.
    Counts its launches in ``spmv.launches``, and the copies of x it makes
    first at 2 rows and more in ``spmv.copy_launches``."""
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
    if y is not None:
        _check(y, (B, out_features), (torch.float32,), "y", dev)
    if y0 is not None:
        if y is None:
            raise ValueError("spmv: y0 is folded into y, which is missing")
        _check(y0, (B, out_features), (torch.float32, torch.bfloat16), "y0",
               dev)
    if dev == "cpu":
        return spmv_plain(x, rowptr, cols, vals, out_features, y=y, y0=y0)
    accumulate = y is not None
    if y is None:
        y = torch.empty((B, out_features), dtype=torch.float32,
                        device=x.device)
    mt = tile_rows(B)
    xt = None
    if mt > 1:
        xt = _workspace(x.device,
                        -(-B // mt) * mt * in_f * x.element_size())
    err = _build.lib().slt_spmv(
        x.data_ptr(), int(x.dtype == torch.bfloat16), mt,
        None if xt is None else xt.data_ptr(),
        0 if xt is None else xt.numel(), rowptr.data_ptr(),
        cols.data_ptr(), vals.data_ptr(),
        None if y0 is None else y0.data_ptr(),
        int(y0 is not None and y0.dtype == torch.bfloat16), y.data_ptr(),
        int(accumulate), B, in_f, out_features,
        group_size(cols.numel(), out_features), _build.stream_ptr(x.device))
    _build.check(err, "spmv")
    spmv.launches += 1
    if xt is not None:
        spmv.copy_launches += 1
    return y


spmv.launches = 0
spmv.copy_launches = 0
