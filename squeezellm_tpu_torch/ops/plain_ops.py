"""Plain-PyTorch LUT-dequant matmul family.

The counterpart of the JAX package's ``ops/xla_ops.py``: the semantic
reference the CUDA kernels are held against, and the path taken for CPU
tensors.

  dense       y = x @ dequant(qweight, lut)
  +sparse     y[..., r] += v * x[..., c]   (CSR sidecar, padding dropped)
  +hybrid     y[..., topx_idx] += x @ topx_weights
"""

from __future__ import annotations

from typing import Optional

import torch

from squeezellm_tpu_torch import formats

SPARSE_SCRATCH = 2**28  # floats of scratch in sparse_matmul's grid


def dequantize(qweight: torch.Tensor, lut: torch.Tensor, bits: int,
               in_features: int) -> torch.Tensor:
    """Packed words + per-channel LUT -> dense weights ``(in, out)`` f32."""
    codes = formats.unpack_codes(qweight, bits, in_features)  # (in, out)
    # W[i, o] = lut[o, codes[i, o]]
    return lut.float().t().gather(0, codes)


def lut_matmul(x: torch.Tensor, qweight: torch.Tensor, lut: torch.Tensor,
               bits: int) -> torch.Tensor:
    """Dense LUT matmul ``x (..., in) -> (..., out)``, f32 accumulation."""
    w = dequantize(qweight, lut, bits, x.shape[-1])
    return torch.matmul(x.float(), w)


def sparse_matmul(x: torch.Tensor, rowptr: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor, out_features: int) -> torch.Tensor:
    """Sparse-outlier contribution ``y[..., r] = sum v * x[..., c]`` over a
    CSR sidecar (row pointers ``(out + 1,)``, columns and values).

    Each row's entries are laid out in a zero-padded ``(out, widest row)``
    grid and summed along it, so the result is the same on every run (a
    scatter such as ``index_add_`` sums with atomics on CUDA). The grid is
    taken a block of rows at a time, so that the scratch stays near
    ``SPARSE_SCRATCH`` floats however the outliers crowd into a few rows
    (a sensitivity-ranked sidecar can put half a row's inputs in one)."""
    counts = (rowptr[1:] - rowptr[:-1]).long()
    width = int(counts.max()) if counts.numel() else 0
    if width == 0:
        return torch.zeros(x.shape[:-1] + (out_features,),
                           dtype=torch.float32, device=x.device)
    xf = x.float()
    block = max(1, SPARSE_SCRATCH // (xf[..., 0].numel() * width))
    slot = torch.arange(width, device=x.device)
    starts = rowptr[:-1].long()
    parts = []
    for r0 in range(0, out_features, block):
        valid = slot < counts[r0: r0 + block, None]  # (rows, width)
        idx = torch.where(valid, starts[r0: r0 + block, None] + slot, 0)
        v = torch.where(valid, vals.float()[idx], 0.0)
        parts.append((xf[..., cols.long()[idx]] * v).sum(-1))
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def hybrid_matmul(x: torch.Tensor, topx_weights: torch.Tensor,
                  topx_indices: torch.Tensor, out_features: int,
                  base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-X dense-channel contribution, additive.

    base: the accumulator the contribution is added to IN ITS OWN dtype
    (in place); a fresh f32 zero tensor when None.

    The product is taken in f64 and rounded to f32: a library GEMM sums a
    row in an order that depends on how many rows it is given, and in f32
    that moves a row's result with the batch (a request's sampled tokens
    would then depend on what is served beside it); the f64 sum's order
    errors lie far below one f32 step, so the rounded row does not move."""
    part = torch.matmul(x.double(), topx_weights.double()).float()
    y = (base if base is not None
         else torch.zeros(x.shape[:-1] + (out_features,), dtype=torch.float32,
                          device=x.device))
    return y.index_add_(-1, topx_indices, part.to(y.dtype))
