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
  struct_a      f32   (out, 8)         decode tables (models.fuse):
  struct_d      f32   (out,)             structured codebook, K10
  qweight_t     int32 (out, n_words)     transposed words, K11

The order of operations is the JAX ``pallas``/``pallas-bf16`` one, so the
bf16 regime matches it: ``y = y0 + sparse(x_f32) + x.W`` in f32, then the
top-X channels added in y's dtype, then the bias, then the cast to
``x.dtype``. The first step routes as the JAX package does, checking in
this order:

1. at most 8 rows, 4 bits, and ``qweight_t`` attached
   (``models.fuse.attach_decode_luts(transposed=True)``): K11
   (``ops/lut_matmul_t``), then ``+ y0`` and K12's sparse sum
   (``ops/spmv``), both in K12's launch, in place on K11's output;
2. a structured table attached (``struct_a``/``struct_d``) and fewer than
   ``BIG_BATCH`` rows: K10 (``ops/lut_matmul.lut_matmul_struct``), with
   the CSR fold and ``y0`` as in K1;
3. ``BIG_BATCH`` = 1024 rows and more (an eval stride, a long prompt): K4
   (``ops/dequant_dense``: the weight dequantized once from the generic
   LUT, the sidecar folded into it) followed by one dense matmul and the
   ``y0`` add; fewer rows: K1 (``ops/lut_matmul``).

Inside K1 and K10 the call site picks the device kernel: ``decode=True``
(the model's one-token-a-slot decode step, and a verify window of at most
16 rows) takes the GEMV at any row count, every other call the mode's
kernel (the tensor cores in bf16 mode), so a row's result does not depend
on how many rows share its call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from squeezellm_tpu_torch import formats
from squeezellm_tpu_torch.ops import plain_ops
from squeezellm_tpu_torch.ops.dequant_dense import (
    dense_matmul,
    dequant_dense,
    dequant_dense_plain,
)
from squeezellm_tpu_torch.ops.lut_matmul import (
    lut_matmul,
    lut_matmul_plain,
    lut_matmul_struct,
    lut_matmul_struct_plain,
)
from squeezellm_tpu_torch.ops.lut_matmul_t import (
    MAX_ROWS as T_MAX_ROWS,
    lut_matmul_t,
    lut_matmul_t_plain,
)
from squeezellm_tpu_torch.ops.spmv import spmv, spmv_plain

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
                       plain: bool = False,
                       decode: bool = False) -> torch.Tensor:
    """y = y0 + x @ dequant(qweight) + sparse + hybrid + bias, in x.dtype.

    mode: 'exact' (f32) or 'bf16' (x and LUT rounded to bf16, f32
    accumulation). y0: optional (..., out) residual, folded into K1's
    output init or K12's launch, or added after K4's matmul. plain: run
    the kernels' plain versions whatever the device (the reference they
    are held against).
    decode: the call is a decode step (one token a slot), which K1 and
    K10 run as their GEMV at any slot count."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, spec.in_features).contiguous()
    y0_2 = (None if y0 is None
            else y0.reshape(-1, spec.out_features).contiguous())
    sparse = {}
    if spec.include_sparse:
        sparse = dict(rowptr=params["sp_rowptr"], cols=params["sp_cols"],
                      vals=params["sp_vals"])
    rows = x2.shape[0]
    kernel = {} if plain else {"variant": "gemv" if decode else None}
    if rows <= T_MAX_ROWS and spec.bits == 4 and "qweight_t" in params:
        fn = lut_matmul_t_plain if plain else lut_matmul_t
        y = fn(x2, params["qweight_t"], params["lut"], mode=mode)
        if sparse:  # y = (y + y0) + sparse, in place in K12's launch
            fn = spmv_plain if plain else spmv
            fn(x2, sparse["rowptr"], sparse["cols"], sparse["vals"],
               spec.out_features, y=y, y0=y0_2)
        elif y0_2 is not None:
            y = y + y0_2.float()
    elif "struct_a" in params and rows < BIG_BATCH:
        fn = lut_matmul_struct_plain if plain else lut_matmul_struct
        y = fn(x2, params["qweight"], params["struct_a"], params["struct_d"],
               y0=y0_2, mode=mode, **sparse, **kernel)
    elif rows >= BIG_BATCH and spec.bits <= 4:
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
               mode=mode, **sparse, **kernel)
    if spec.topx > 0:
        y = plain_ops.hybrid_matmul(x2, params["topx_weights"],
                                    params["topx_indices"],
                                    spec.out_features, base=y)
    if spec.has_bias:
        y = y + params["bias"].to(y.dtype)
    return y.to(x.dtype).reshape(*lead, spec.out_features)


def pack_linear(weight: torch.Tensor, lut: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                outliers: Optional[torch.Tensor] = None, bits: int = 4,
                nnz_pad_multiple: int = 512):
    """Pack one linear, on the tensors' device, into (spec, numpy arrays of
    the checkpoint format): the port of the JAX package's ``pack_linear``
    (the reference's ``QuantLinearLUT.pack2``).

    weight: (out, in) with outlier slots zeroed; lut: (out, 2**bits);
    labels: (out, in) codes, or None for nearest-centroid assignment;
    outliers: (out, in) extracted values or None. An outlier is stored as
    ``w - centroid_nearest_zero(channel)``, since the dense path
    dequantizes its zeroed slot to that centroid, in a COO list padded to
    a multiple of ``nnz_pad_multiple`` (``formats.SparseCOO``). Returns
    ``QuantLinearSpec`` (``nnz`` counts live entries) and {qweight, lut,
    sp_rows, sp_cols, sp_vals?, bias?}; ``carry.linear_from_tree`` makes
    the CSR linear of it."""
    out_features, in_features = weight.shape
    if tuple(lut.shape) != (out_features, 2**bits):
        raise ValueError(f"lut shape {tuple(lut.shape)} for {out_features} "
                         f"channels at {bits} bits")
    lut = lut.float()
    if labels is None:
        labels = formats.assign_codes(weight.float(), lut)
    params = {
        "qweight": formats.pack_codes(labels.t(), bits).cpu().numpy(),
        "lut": lut.cpu().numpy(),
    }
    nnz = 0
    if outliers is not None:
        outliers = outliers.float()
        zero = formats.nearest_to_zero(lut)
        corrected = torch.where(outliers != 0, outliers - zero[:, None], 0.0)
        coo = formats.SparseCOO.from_dense(corrected,
                                           pad_multiple=nnz_pad_multiple)
        params.update(sp_rows=coo.rows, sp_cols=coo.cols, sp_vals=coo.vals)
        nnz = coo.nnz
    if bias is not None:
        params["bias"] = bias.float().cpu().numpy()
    spec = QuantLinearSpec(bits=bits, in_features=in_features,
                           out_features=out_features,
                           has_bias=bias is not None, nnz=nnz)
    return spec, params
