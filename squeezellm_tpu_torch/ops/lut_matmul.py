"""K1: LUT-dequant matmul with the CSR sparse fold and a ``y0`` init.

``y = y0 + sparse(x) + x @ W`` with ``W[i, o] = lut[o, code(i, o)]``, f32
out. The CUDA kernel (``csrc/lut_matmul.cu``) replaces the TPU kernels
``_lut_matmul_sp_kernel`` / ``_lut_matmul_kernel`` of
``squeezellm_tpu/ops/pallas_ops.py`` (``lut_matmul``) and, for 17..1023
rows, the sparse add of ``_spmv_kernel`` (``gather_spmv``). Its bound on
the H100 and how the design meets it are noted in the CUDA source.

Modes: ``exact`` is f32 throughout (the JAX ``pallas``/``gather``
regime); ``bf16`` rounds x and the LUT to bf16 before the products and
accumulates in f32 (the ``pallas-bf16`` regime). The sparse fold always
reads x unrounded.
"""

from __future__ import annotations

from typing import Optional

import torch

from squeezellm_tpu_torch import _build, formats
from squeezellm_tpu_torch.ops import plain_ops

MODES = ("exact", "bf16")
MAX_ROWS = 1023  # quant_linear_apply sends 1024 rows and more to K4


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def lut_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                     lut: torch.Tensor, bits: int, *,
                     rowptr: Optional[torch.Tensor] = None,
                     cols: Optional[torch.Tensor] = None,
                     vals: Optional[torch.Tensor] = None,
                     y0: Optional[torch.Tensor] = None,
                     mode: str = "exact") -> torch.Tensor:
    """The plain PyTorch version of K1: x (M, in) -> y (M, out) f32."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    out_features = qweight.shape[1]
    xf = x.float()
    lut_d = _round_bf16(lut.float()) if mode == "bf16" else lut.float()
    xd = _round_bf16(xf) if mode == "bf16" else xf
    w = plain_ops.dequantize(qweight, lut_d, bits, x.shape[-1])
    y = (y0.float() if y0 is not None
         else torch.zeros(x.shape[0], out_features, device=x.device))
    if rowptr is not None:
        y = y + plain_ops.sparse_matmul(xf, rowptr, cols, vals, out_features)
    return y + torch.matmul(xd, w)


def lut_matmul(x: torch.Tensor, qweight: torch.Tensor, lut: torch.Tensor,
               bits: int, *, rowptr: Optional[torch.Tensor] = None,
               cols: Optional[torch.Tensor] = None,
               vals: Optional[torch.Tensor] = None,
               y0: Optional[torch.Tensor] = None,
               mode: str = "exact") -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor.

    x: (M, in) f32 or bf16, contiguous; qweight int32 (n_words, out);
    lut f32 (out, 2**bits); rowptr/cols/vals: the CSR sidecar (int32,
    int32, f32) or None; y0: (M, out) f32/bf16 or None. Returns (M, out)
    f32. Counts its launches in ``lut_matmul.launches``."""
    if x.device.type == "cpu":
        return lut_matmul_plain(x, qweight, lut, bits, rowptr=rowptr,
                                cols=cols, vals=vals, y0=y0, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"lut_matmul: unsupported device {x.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if bits not in (3, 4):
        raise ValueError(f"lut_matmul kernel takes bits 3 or 4, got {bits}")
    M, in_f = x.shape
    out_f = qweight.shape[1]
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"lut_matmul kernel takes 1..{MAX_ROWS} rows, "
                         f"got {M}")
    _check(x, (M, in_f), (torch.float32, torch.bfloat16), "x")
    _check(qweight, (formats.n_words(in_f, bits), out_f), (torch.int32,),
           "qweight")
    _check(lut, (out_f, 1 << bits), (torch.float32,), "lut")
    if y0 is not None:
        _check(y0, (M, out_f), (torch.float32, torch.bfloat16), "y0")
    has_sparse = rowptr is not None
    if has_sparse:
        _check(rowptr, (out_f + 1,), (torch.int32,), "rowptr")
        _check(cols, cols.shape, (torch.int32,), "cols")
        _check(vals, cols.shape, (torch.float32,), "vals")
    y = torch.empty((M, out_f), dtype=torch.float32, device=x.device)
    lib = _build.lib()
    err = lib.slt_lut_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), qweight.data_ptr(),
        lut.data_ptr(),
        rowptr.data_ptr() if has_sparse else None,
        cols.data_ptr() if has_sparse else None,
        vals.data_ptr() if has_sparse else None,
        y0.data_ptr() if y0 is not None else None,
        int(y0 is not None and y0.dtype == torch.bfloat16), y.data_ptr(),
        M, in_f, out_f, bits, int(mode == "bf16"),
        _build.stream_ptr(x.device))
    _build.check(err, "lut_matmul")
    lut_matmul.launches += 1
    return y


lut_matmul.launches = 0


def _check(t: torch.Tensor, shape, dtypes, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
