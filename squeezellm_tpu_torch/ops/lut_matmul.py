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

K10 (``lut_matmul_struct``) is the same kernel template for a 4-bit
STRUCTURED codebook, given as A (out, 8) and d (out,) with
``W[i, o] = A[o, c & 7] + (c & 8 ? d[o] : 0)`` (``models.fuse`` attaches
them where a LUT decomposes so). It replaces the structured bodies of the
TPU kernels (``_dequant_plane_struct_sel`` through ``_lut_matmul_body``).
bf16 mode rounds W, the sum, to bf16, as the TPU's one-pass MXU does.
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
    if bits not in (3, 4):
        raise ValueError(f"lut_matmul kernel takes bits 3 or 4, got {bits}")
    _check_operands(x, qweight, bits, mode, y0, rowptr, cols, vals)
    M, in_f = x.shape
    out_f = qweight.shape[1]
    _check(lut, (out_f, 1 << bits), (torch.float32,), "lut", x.device.type)
    if x.device.type == "cpu":
        return lut_matmul_plain(x, qweight, lut, bits, rowptr=rowptr,
                                cols=cols, vals=vals, y0=y0, mode=mode)
    has_sparse = rowptr is not None
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


def struct_lut(struct_a: torch.Tensor, struct_d: torch.Tensor) -> torch.Tensor:
    """A structured table as the (out, 16) LUT it stands for (f32)."""
    a = struct_a.float()
    return torch.cat([a, a + struct_d.float()[:, None]], dim=1)


def lut_matmul_struct_plain(x: torch.Tensor, qweight: torch.Tensor,
                            struct_a: torch.Tensor, struct_d: torch.Tensor,
                            *, rowptr: Optional[torch.Tensor] = None,
                            cols: Optional[torch.Tensor] = None,
                            vals: Optional[torch.Tensor] = None,
                            y0: Optional[torch.Tensor] = None,
                            mode: str = "exact") -> torch.Tensor:
    """The plain PyTorch version of K10: K1's on the expanded table."""
    return lut_matmul_plain(x, qweight, struct_lut(struct_a, struct_d), 4,
                            rowptr=rowptr, cols=cols, vals=vals, y0=y0,
                            mode=mode)


def lut_matmul_struct(x: torch.Tensor, qweight: torch.Tensor,
                      struct_a: torch.Tensor, struct_d: torch.Tensor, *,
                      rowptr: Optional[torch.Tensor] = None,
                      cols: Optional[torch.Tensor] = None,
                      vals: Optional[torch.Tensor] = None,
                      y0: Optional[torch.Tensor] = None,
                      mode: str = "exact") -> torch.Tensor:
    """K10 on a CUDA tensor, its plain version on a CPU tensor.

    K1's operands at 4 bits, with struct_a f32 (out, 8) and struct_d f32
    (out,) in place of the LUT. Returns (M, out) f32. Counts its launches
    in ``lut_matmul_struct.launches``."""
    _check_operands(x, qweight, 4, mode, y0, rowptr, cols, vals)
    M, in_f = x.shape
    out_f = qweight.shape[1]
    _check(struct_a, (out_f, 8), (torch.float32,), "struct_a",
           x.device.type)
    _check(struct_d, (out_f,), (torch.float32,), "struct_d", x.device.type)
    if x.device.type == "cpu":
        return lut_matmul_struct_plain(x, qweight, struct_a, struct_d,
                                       rowptr=rowptr, cols=cols, vals=vals,
                                       y0=y0, mode=mode)
    has_sparse = rowptr is not None
    y = torch.empty((M, out_f), dtype=torch.float32, device=x.device)
    err = _build.lib().slt_lut_matmul_struct(
        x.data_ptr(), int(x.dtype == torch.bfloat16), qweight.data_ptr(),
        struct_a.data_ptr(), struct_d.data_ptr(),
        rowptr.data_ptr() if has_sparse else None,
        cols.data_ptr() if has_sparse else None,
        vals.data_ptr() if has_sparse else None,
        y0.data_ptr() if y0 is not None else None,
        int(y0 is not None and y0.dtype == torch.bfloat16), y.data_ptr(),
        M, in_f, out_f, int(mode == "bf16"), _build.stream_ptr(x.device))
    _build.check(err, "lut_matmul_struct")
    lut_matmul_struct.launches += 1
    return y


lut_matmul_struct.launches = 0


def _check_operands(x, qweight, bits, mode, y0, rowptr, cols, vals) -> None:
    """What K1 and K10 take, checked alike for CPU and CUDA tensors."""
    dev = x.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, in), got {tuple(x.shape)}")
    M, in_f = x.shape
    out_f = qweight.shape[1]
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"the kernel takes 1..{MAX_ROWS} rows, got {M}")
    _check(x, (M, in_f), (torch.float32, torch.bfloat16), "x", dev)
    _check(qweight, (formats.n_words(in_f, bits), out_f), (torch.int32,),
           "qweight", dev)
    if y0 is not None:
        _check(y0, (M, out_f), (torch.float32, torch.bfloat16), "y0", dev)
    if rowptr is not None:
        _check(rowptr, (out_f + 1,), (torch.int32,), "rowptr", dev)
        _check(cols, cols.shape, (torch.int32,), "cols", dev)
        _check(vals, cols.shape, (torch.float32,), "vals", dev)


def _check(t: torch.Tensor, shape, dtypes, name: str,
           device_type: str = "cuda") -> None:
    if t.device.type != device_type:
        raise ValueError(f"{name} must be a {device_type} tensor, got "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
