"""K4: dequantize a packed weight to a dense one, the sparse sidecar folded
in, for calls of 1024 rows and more (eval strides, long prompts).

``dequant_dense`` returns ``W (in, out)`` with ``W[i, o] = lut[o, code(i,
o)]`` plus every CSR entry ``(o, i, v)`` added on top (the sidecar holds
corrections, never replacements); :func:`dense_matmul` then computes
``x @ W`` with f32 accumulation and f32 output, one dense matmul as in the
JAX package. The CUDA kernel (``csrc/dequant_dense.cu``) replaces the TPU
kernel ``_dequant_dense_kernel`` of ``squeezellm_tpu/ops/pallas_ops.py``
(``_lut_matmul_bigbatch``) and the scatter of the COO sidecar into its
scratch; its bound on the H100 and how the design meets it are noted in
the CUDA source. W is allocated per call and never kept: a cached dense
weight would undo the memory the quantized model saves.

Modes, rounding where the JAX package rounds. ``exact``: f32 W, f32
product with TF32 off. ``bf16``: the LUT is rounded to bf16 and W stored
in bf16; a sidecar value is rounded to bf16 and added in bf16, so a folded
slot holds ``bf16(bf16(lut) + bf16(v))``; x is rounded to bf16; the
product accumulates in f32 and is returned in f32. In this band the
sidecar therefore meets the bf16-rounded x, while K1 (1..1023 rows) reads
x unrounded for its sparse fold: the JAX package has the same seam between
its two row bands, and the port keeps it.
"""

from __future__ import annotations

from typing import Optional

import torch

from squeezellm_tpu_torch import _build, formats
from squeezellm_tpu_torch.ops import plain_ops

MODES = ("exact", "bf16")


def _w_dtype(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return torch.bfloat16 if mode == "bf16" else torch.float32


def dequant_dense_plain(qweight: torch.Tensor, lut: torch.Tensor, bits: int,
                        in_features: int, *,
                        rowptr: Optional[torch.Tensor] = None,
                        cols: Optional[torch.Tensor] = None,
                        vals: Optional[torch.Tensor] = None,
                        mode: str = "exact") -> torch.Tensor:
    """The plain PyTorch version of K4: W (in, out), bf16 or f32."""
    dt = _w_dtype(mode)
    # a bf16-rounded LUT gathers to values bf16 holds exactly
    w = plain_ops.dequantize(qweight, lut.float().to(dt), bits,
                             in_features).to(dt)
    if rowptr is None or cols.numel() == 0:
        return w
    out_features = qweight.shape[1]
    counts = (rowptr[1:] - rowptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(out_features, device=w.device), counts)
    slot = cols.long() * out_features + rows  # flat index into W
    # entries that share a slot add one after the other, in CSR order (each
    # sum rounded to W's type): pass k adds every slot's k-th entry
    order = torch.sort(slot, stable=True).indices
    sorted_slot = slot[order]
    first = torch.ones_like(sorted_slot, dtype=torch.bool)
    first[1:] = sorted_slot[1:] != sorted_slot[:-1]
    idx = torch.arange(slot.numel(), device=w.device)
    run_start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start
    flat, v = w.view(-1), vals.float().to(dt)
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        flat[slot[sel]] = flat[slot[sel]] + v[sel]
    return w


def dequant_dense(qweight: torch.Tensor, lut: torch.Tensor, bits: int,
                  in_features: int, *,
                  rowptr: Optional[torch.Tensor] = None,
                  cols: Optional[torch.Tensor] = None,
                  vals: Optional[torch.Tensor] = None,
                  mode: str = "exact") -> torch.Tensor:
    """K4 on CUDA tensors, its plain version on CPU tensors.

    qweight int32 (n_words, out); lut f32 (out, 2**bits); rowptr/cols/vals:
    the CSR sidecar (int32, int32, f32) or None. Returns W (in, out), bf16
    in ``bf16`` mode and f32 in ``exact`` mode. Counts its launches in
    ``dequant_dense.launches``."""
    if qweight.device.type == "cpu":
        return dequant_dense_plain(qweight, lut, bits, in_features,
                                   rowptr=rowptr, cols=cols, vals=vals,
                                   mode=mode)
    dev = qweight.device
    if dev.type != "cuda":
        raise ValueError(f"dequant_dense: unsupported device {dev}")
    dt = _w_dtype(mode)
    if bits not in (3, 4):
        raise ValueError(f"dequant_dense kernel takes bits 3 or 4, got "
                         f"{bits}")
    out_f = qweight.shape[1]

    def check(t, shape, dtype, name):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor "
                             f"{shape} on {dev}")

    check(qweight, (formats.n_words(in_features, bits), out_f), torch.int32,
          "qweight")
    check(lut, (out_f, 1 << bits), torch.float32, "lut")
    has_sparse = rowptr is not None
    if has_sparse:
        check(rowptr, (out_f + 1,), torch.int32, "rowptr")
        check(cols, tuple(cols.shape), torch.int32, "cols")
        check(vals, tuple(cols.shape), torch.float32, "vals")
    w = torch.empty((in_features, out_f), dtype=dt, device=dev)
    err = _build.lib().slt_dequant_dense(
        qweight.data_ptr(), lut.data_ptr(),
        rowptr.data_ptr() if has_sparse else None,
        cols.data_ptr() if has_sparse else None,
        vals.data_ptr() if has_sparse else None,
        w.data_ptr(), in_features, out_f, bits, int(dt == torch.bfloat16),
        _build.stream_ptr(dev))
    _build.check(err, "dequant_dense")
    dequant_dense.launches += 1
    return w


dequant_dense.launches = 0


def dense_matmul(x: torch.Tensor, w: torch.Tensor, *,
                 plain: bool = False) -> torch.Tensor:
    """``x (M, in) @ W (in, out)`` with f32 accumulation, f32 out.

    f32 W (exact mode): an f32 product; on the card TF32 must be off. bf16
    W (bf16 mode): x is rounded to bf16 and the product of the two bf16
    operands keeps its f32 sums (``torch.matmul`` of two bf16 tensors would
    round them to bf16): on the card one bf16 matmul with f32 output; on
    the CPU, and for the plain reference, the f32 product of the upcast
    operands, which multiplies the same bf16 values."""
    if w.dtype == torch.float32:
        if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "exact mode needs full-f32 products: set "
                "torch.backends.cuda.matmul.allow_tf32 = False")
        return torch.mm(x.float(), w)
    xb = x.to(torch.bfloat16)
    if x.is_cuda and not plain:
        return torch.mm(xb, w, out_dtype=torch.float32)
    return torch.mm(xb.float(), w.float())
