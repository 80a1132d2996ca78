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

Two device kernels serve both wrappers; :func:`plan` lays one out per call
(a pure function, so the CPU tests reach it): the GEMV (exact mode, and
bf16 mode where the caller asks for it; 1-16 rows a tile) and the
tensor-core kernel (``mma.sync`` bf16 with f32 accumulation; bf16 mode
only). The CALLER picks the kernel, never the row count: the model's
one-token-a-slot decode step asks for the GEMV at any slot count, and so
does a verify window of at most 16 rows; every other call (prefill,
chunks, larger verify windows, an eval forward below 1024 rows) takes
the tensor-core kernel in bf16 mode (``quant_linear_apply(decode=...)``,
``models.llama.Step.lin``). Both kernels split the packed words
across blocks (``splits``) and sum the partials in a fixed order, and the
split follows the layer's shape only, so a row's bits do not depend on the
rows batched with it, nor a sampled token on its cohort. On the H100 the
GEMV is the faster kernel up to 8 rows and the tensor cores from 12
(``chip_smoke.py`` times both at 8-40 rows), so the decode step of more
than 8 slots pays for its invariance in bf16 mode.

K10 (``lut_matmul_struct``) is the same two kernels for a 4-bit
STRUCTURED codebook, given as A (out, 8) and d (out,) with
``W[i, o] = A[o, c & 7] + (c & 8 ? d[o] : 0)`` (``models.fuse`` attaches
them where a LUT decomposes so). It replaces the structured bodies of the
TPU kernels (``_dequant_plane_struct_sel`` through ``_lut_matmul_body``).
bf16 mode rounds W, the sum, to bf16, as the TPU's one-pass MXU does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from squeezellm_tpu_torch import _build, formats
from squeezellm_tpu_torch.ops import plain_ops

MODES = ("exact", "bf16")
MAX_ROWS = 1023  # quant_linear_apply sends 1024 rows and more to K4
VARIANTS = ("gemv", "mma")
COLS = 128  # output columns a block (kCols in csrc/lut_matmul.cu)
GEMV_ROW_TILES = (1, 2, 4, 8, 16)
MMA_ROW_TILE = 64
# k-split: at least as many blocks as the card holds at once (132 SMs; the
# GEMV fits 4 blocks an SM at one row, the MMA kernel 2), so that every SM
# keeps its stages of words in flight, but no split thinner than MIN_WORDS
# packed word rows. The split is fixed per layer shape: the GEMV's is the
# one-row tile's, the MMA kernel's the one MMA_SPLIT_ROW_TILES row tiles
# (a 65-128-row call) fill the card with; fewer would grow the (splits, M,
# out) f32 workspace at 1023 rows, more would idle SMs at 40 rows.
SMS = 132
GEMV_MIN_WORDS, MMA_MIN_WORDS = 32, 64
MMA_SPLIT_ROW_TILES = 2
# the sidecar's fold runs in blocks of its own beside the word stream: 8 a
# column tile in the GEMV, whose stream is short (a 4096-wide output's
# blocks stream 8 KB each), 1 in the MMA kernel, whose partials are M rows
# deep
GEMV_FOLDS = 8


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape: the kernel, its rows a tile, and the k-split
    (``splits`` blocks of ``words_per_split`` packed word rows a column
    tile; with the sidecar's ``folds`` blocks, their partials go to a
    (folds + splits, M, out) workspace)."""

    variant: str
    row_tile: int
    splits: int
    words_per_split: int
    tiles: int  # (row tiles) x (column tiles), one counter each
    folds: int  # blocks a column tile for the sidecar's fold, if any


def plan(M: int, in_f: int, out_f: int, bits: int, mode: str,
         variant: Optional[str] = None) -> Plan:
    """The kernel and grid for M rows of an (in_f -> out_f) layer.

    ``variant`` None takes the mode's kernel: the tensor-core kernel in
    bf16 mode, the GEMV in exact mode, at every row count; a decode step
    asks for "gemv". "mma" is refused in exact mode (its bf16 operands
    would change exact mode's numbers). The k-split depends on the shape
    only, never on M, so a row is summed in the same order whatever else
    is batched with it."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if variant == "mma" and mode != "bf16":
        raise ValueError("the tensor-core kernel runs bf16 mode only")
    if variant is None:
        variant = "mma" if mode == "bf16" else "gemv"
    nw = formats.n_words(in_f, bits)
    col_tiles = -(-out_f // COLS)
    if variant == "gemv":
        row_tile = next(t for t in GEMV_ROW_TILES if t >= min(M, 16))
        wave, min_words, fill = SMS * 4, GEMV_MIN_WORDS, col_tiles
    else:
        row_tile = MMA_ROW_TILE
        wave, min_words = SMS * 2, MMA_MIN_WORDS
        fill = col_tiles * MMA_SPLIT_ROW_TILES
    tiles = col_tiles * -(-M // row_tile)
    splits = max(1, min(-(-wave // fill), nw // min_words))
    per = -(-(-(-nw // splits)) // 8) * 8
    return Plan(variant, row_tile, -(-nw // per), per, tiles,
                GEMV_FOLDS if variant == "gemv" else 1)


_COUNTERS = {}
# every workspace a wrapper has outgrown (K1/K10's counters, K11's
# partials, K12's copy of x): a CUDA graph captured before the growth still
# reads and writes the old buffer at each replay, so none is ever freed
RETIRED = []


def grown(store: dict, device, n: int, make) -> torch.Tensor:
    """``store[device]``, replaced by ``make(n)`` when it holds fewer than
    n elements; the buffer it replaces is kept alive in RETIRED."""
    t = store.get(device)
    if t is None or t.numel() < n:
        if t is not None:
            RETIRED.append(t)
        t = store[device] = make(n)
    return t


def _counters(device, n: int) -> torch.Tensor:
    """The tile counters of the k-split on `device`: zeros, and left zero
    by every launch (the last block of a tile resets its own), so one
    buffer serves every call on the device's stream."""
    return grown(_COUNTERS, device, n, lambda m: torch.zeros(
        max(m, 4096), dtype=torch.int32, device=device))


def _launch(fn, name, x, qweight, tables, bits, mode, rowptr, cols, vals,
            y0, p: Plan) -> torch.Tensor:
    """Launch K1's or K10's C entry point `fn` with plan `p`."""
    M, in_f = x.shape
    out_f = qweight.shape[1]
    has_sparse = rowptr is not None
    y = torch.empty((M, out_f), dtype=torch.float32, device=x.device)
    folds = p.folds if has_sparse else 0
    parts = folds + p.splits  # partials a column tile
    ws = (torch.empty((parts, M, out_f), dtype=torch.float32,
                      device=x.device) if parts > 1 else None)
    cnt = _counters(x.device, p.tiles) if parts > 1 else None
    # the fold gathers x by input, so it reads x transposed (x itself at
    # one row)
    xt = x.t().contiguous() if has_sparse else None
    head = [x.data_ptr(), int(x.dtype == torch.bfloat16),
            xt.data_ptr() if has_sparse else None,
            qweight.data_ptr(), *[t.data_ptr() for t in tables],
            rowptr.data_ptr() if has_sparse else None,
            cols.data_ptr() if has_sparse else None,
            vals.data_ptr() if has_sparse else None,
            y0.data_ptr() if y0 is not None else None,
            int(y0 is not None and y0.dtype == torch.bfloat16), y.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            cnt.data_ptr() if cnt is not None else None, M, in_f, out_f]
    tail = [int(mode == "bf16"), VARIANTS.index(p.variant), p.row_tile,
            p.splits, p.words_per_split, folds, _build.stream_ptr(x.device)]
    err = fn(*head, *([bits] if len(tables) == 1 else []), *tail)
    _build.check(err, name)
    return y


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
               mode: str = "exact",
               variant: Optional[str] = None) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor.

    x: (M, in) f32 or bf16, contiguous; qweight int32 (n_words, out);
    lut f32 (out, 2**bits); rowptr/cols/vals: the CSR sidecar (int32,
    int32, f32) or None; y0: (M, out) f32/bf16 or None; variant: the
    device kernel, None for the mode's (:func:`plan`). Returns (M, out) f32.
    Counts its launches in ``lut_matmul.launches`` and, by kernel, in
    ``lut_matmul.variant_launches``."""
    if bits not in (3, 4):
        raise ValueError(f"lut_matmul kernel takes bits 3 or 4, got {bits}")
    _check_operands(x, qweight, bits, mode, y0, rowptr, cols, vals)
    M, in_f = x.shape
    out_f = qweight.shape[1]
    _check(lut, (out_f, 1 << bits), (torch.float32,), "lut", x.device.type)
    p = plan(M, in_f, out_f, bits, mode, variant)
    if x.device.type == "cpu":
        return lut_matmul_plain(x, qweight, lut, bits, rowptr=rowptr,
                                cols=cols, vals=vals, y0=y0, mode=mode)
    y = _launch(_build.lib().slt_lut_matmul, "lut_matmul", x, qweight,
                (lut,), bits, mode, rowptr, cols, vals, y0, p)
    lut_matmul.launches += 1
    lut_matmul.variant_launches[p.variant] += 1
    return y


lut_matmul.launches = 0
lut_matmul.variant_launches = dict.fromkeys(VARIANTS, 0)


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
                      mode: str = "exact",
                      variant: Optional[str] = None) -> torch.Tensor:
    """K10 on a CUDA tensor, its plain version on a CPU tensor.

    K1's operands at 4 bits, with struct_a f32 (out, 8) and struct_d f32
    (out,) in place of the LUT. Returns (M, out) f32. Counts its launches
    in ``lut_matmul_struct.launches`` and, by kernel, in
    ``lut_matmul_struct.variant_launches``."""
    _check_operands(x, qweight, 4, mode, y0, rowptr, cols, vals)
    M, in_f = x.shape
    out_f = qweight.shape[1]
    _check(struct_a, (out_f, 8), (torch.float32,), "struct_a",
           x.device.type)
    _check(struct_d, (out_f,), (torch.float32,), "struct_d", x.device.type)
    p = plan(M, in_f, out_f, 4, mode, variant)
    if x.device.type == "cpu":
        return lut_matmul_struct_plain(x, qweight, struct_a, struct_d,
                                       rowptr=rowptr, cols=cols, vals=vals,
                                       y0=y0, mode=mode)
    y = _launch(_build.lib().slt_lut_matmul_struct, "lut_matmul_struct", x,
                qweight, (struct_a, struct_d), 4, mode, rowptr, cols, vals,
                y0, p)
    lut_matmul_struct.launches += 1
    lut_matmul_struct.variant_launches[p.variant] += 1
    return y


lut_matmul_struct.launches = 0
lut_matmul_struct.variant_launches = dict.fromkeys(VARIANTS, 0)


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
