"""Quantized linear: the PyTorch counterpart of the JAX package's
``ops/quant_linear.py`` (``QuantLinearSpec`` + ``quant_linear_apply``).

A quantized linear is a static :class:`QuantLinearSpec` plus a dict of
tensors:

  qweight       int32 (n_words, out)   packed codes (formats)
  lut           f32   (out, 2**bits)   per-output-channel codebook
  sp_rowptr     int32 (out + 1,)       optional CSR sparse sidecar
  sp_cols       int32 (nnz,)
  sp_vals       f32   (nnz,)
  topx_weights  f32   (in, topX)       optional hybrid dense channels
  topx_indices  int32 (topX,)
  bias          f32   (out,)           optional

The order of operations is the JAX ``pallas``/``pallas-bf16`` one, so the
bf16 regime matches it: ``y = y0 + sparse(x_f32) + x.W`` in f32, then the
top-X channels added in y's dtype, then the bias, then the cast to
``x.dtype``. The first step routes by the row count as the JAX package
does: 1..1023 rows go to K1 (``ops/lut_matmul``); ``BIG_BATCH`` = 1024
rows and more (an eval stride, a long prompt) go to K4
(``ops/dequant_dense``: the weight dequantized once, the sidecar folded
into it) followed by one dense matmul and the ``y0`` add.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from squeezellm_tpu_torch.ops import plain_ops
from squeezellm_tpu_torch.ops.dequant_dense import (
    dense_matmul,
    dequant_dense,
    dequant_dense_plain,
)
from squeezellm_tpu_torch.ops.lut_matmul import lut_matmul, lut_matmul_plain

BIG_BATCH = 1024  # rows from which the weight is dequantized once (K4)


@dataclasses.dataclass(frozen=True)
class QuantLinearSpec:
    bits: int
    in_features: int
    out_features: int
    has_bias: bool = False
    nnz: int = 0  # 0 => no sparse sidecar
    topx: int = 0  # 0 => no hybrid dense channels

    @property
    def include_sparse(self) -> bool:
        return self.nnz > 0


def quant_linear_apply(spec: QuantLinearSpec,
                       params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                       mode: str = "exact",
                       y0: Optional[torch.Tensor] = None,
                       plain: bool = False) -> torch.Tensor:
    """y = y0 + x @ dequant(qweight) + sparse + hybrid + bias, in x.dtype.

    mode: 'exact' (f32) or 'bf16' (x and LUT rounded to bf16, f32
    accumulation). y0: optional (..., out) residual, folded into K1's
    output init or added after K4's matmul. plain: run the kernels' plain
    versions whatever the device (the reference they are held against)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, spec.in_features).contiguous()
    y0_2 = (None if y0 is None
            else y0.reshape(-1, spec.out_features).contiguous())
    sparse = {}
    if spec.include_sparse:
        sparse = dict(rowptr=params["sp_rowptr"], cols=params["sp_cols"],
                      vals=params["sp_vals"])
    if x2.shape[0] >= BIG_BATCH and spec.bits <= 4:
        fn = dequant_dense_plain if plain else dequant_dense
        w = fn(params["qweight"], params["lut"], spec.bits,
               spec.in_features, mode=mode, **sparse)
        y = dense_matmul(x2, w, plain=plain)
        del w
        if y0_2 is not None:
            y = y + y0_2.float()
    else:
        fn = lut_matmul_plain if plain else lut_matmul
        y = fn(x2, params["qweight"], params["lut"], spec.bits, y0=y0_2,
               mode=mode, **sparse)
    if spec.topx > 0:
        y = plain_ops.hybrid_matmul(x2, params["topx_weights"],
                                    params["topx_indices"],
                                    spec.out_features, base=y)
    if spec.has_bias:
        y = y + params["bias"].to(y.dtype)
    return y.to(x.dtype).reshape(*lead, spec.out_features)
