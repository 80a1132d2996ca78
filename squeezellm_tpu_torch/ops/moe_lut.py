"""K13: K1's LUT-dequant matmul grouped over a layer's experts, routed from
device memory, and the combine of the experts' outputs.

``y = sparse(x) + x @ W_e + top-X_e(x)`` for every row of x, W_e the
weights of the expert whose rows hold it: a layer's (token, expert) pairs
are sorted by expert (``models.moe.route``), expert e's rows are
``[offsets[e], offsets[e + 1])`` and ``offsets`` lies on the device. The
experts' operands are stacked: ``qweight`` (E, n_words, out), ``lut``
(E, out, 2**bits), the sidecar's ``rowptr`` (E, out + 1) into the
concatenated ``cols`` / ``vals``, the top-X rows transposed,
``topx_weights`` (E, X, in), and ``topx_indices`` (E, X). The CUDA kernel
(``csrc/moe_lut.cu``) replaces no TPU kernel (the JAX package has no
sparse experts); its design is noted there.

One launch serves every expert: :func:`tile_map` writes on the device
which expert owns each row tile of the launch, so the grid depends on the
row count alone and a decode step's graph captures it for any routing.
Tiles of no expert leave at once: an expert that no row chose reads no
word. bf16 mode only; a decode call (``variant="dec"``) runs K1's decode
body (``moe_dec_kernel``), every other call its prefill body
(``moe_mma_kernel``). The k-split follows the layer's shape and the
experts a row chooses (:func:`plan`), so a row's bits do not depend on the
rows that share its launch or its expert.

:func:`moe_combine` sums each row's k expert outputs with their weights in
f32 in a fixed order and adds the residual last.

``moe_lut_matmul_plain`` is the plain version: a loop over the experts
through ``lut_matmul_plain`` and ``hybrid_matmul`` (it reads the offsets on
the host); a CPU tensor takes it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from squeezellm_tpu_torch import _build, formats
from squeezellm_tpu_torch.ops import lut_matmul as k1
from squeezellm_tpu_torch.ops import plain_ops

VARIANTS = ("mma", "dec")  # the prefill and the decode body
ROW_TILES = {"mma": (k1.MMA_ROW_TILE,), "dec": k1.DEC_ROW_TILES}
# the sidecar's and the top-X rows' fold: one block a column tile (K1's
# decode kernel takes 2, but here the many experts' blocks fill the card)
FOLDS = 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's k-split (K1's ``Plan`` less its row tiles: those
    follow the routing, ``tile_map``)."""

    splits: int
    words_per_split: int


def row_tile(rows: int, variant: str) -> int:
    """Rows a tile for a launch whose experts have at most ``rows`` rows
    each: 8 or 16 for the decode body, as K1's decode kernel takes them,
    64 for the prefill body."""
    tiles = ROW_TILES[variant]
    return tiles[rows > tiles[0]] if len(tiles) > 1 else tiles[0]


def plan(in_f: int, out_f: int, bits: int, variant: str,
         per_row: int) -> Plan:
    """The k-split of an (in_f -> out_f) expert: enough word blocks for
    K1's wave when the ``per_row`` experts of one row are the only ones
    read (one row tile each), at least K1's words a block. It depends on
    the shape and ``per_row`` only."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    nw = formats.n_words(in_f, bits)
    fill = -(-out_f // k1.COLS) * per_row
    if variant == "dec":
        min_words = k1.DEC_MIN_WORDS
    else:
        min_words, fill = k1.MMA_MIN_WORDS, fill * k1.MMA_SPLIT_ROW_TILES
    wave = k1.SMS * k1.BLOCKS_PER_SM[variant]
    splits = max(1, min(-(-wave // fill), nw // min_words))
    per = -(-(-(-nw // splits)) // 8) * 8
    return Plan(-(-nw // per), per)


def n_tiles(n_experts: int, rows: int, pairs: int, tile: int) -> int:
    """Row tiles a launch holds: no expert has more than ``rows`` rows,
    and ``pairs`` rows in all take at most pairs / tile + E tiles."""
    return min(n_experts * -(-rows // tile), -(-pairs // tile) + n_experts)


def tile_map(offsets: torch.Tensor, ntiles: int, tile: int) -> torch.Tensor:
    """(2, ntiles) int32 on offsets' device: each row tile's expert (-1 for
    none) and first row, the experts' tiles in order, each expert's
    ceil(rows / tile) of them. Device operations only: no host sync."""
    counts = (offsets[1:] - offsets[:-1]).long()
    per = (counts + tile - 1) // tile
    ends = torch.cumsum(per, 0)
    z = torch.arange(ntiles, device=offsets.device)
    e = torch.searchsorted(ends, z, right=True)
    n_exp = offsets.numel() - 1
    ec = e.clamp(max=n_exp - 1)
    first = offsets.long()[ec] + (z - (ends - per)[ec]) * tile
    return torch.stack([torch.where(e < n_exp, ec, -1),
                        first]).to(torch.int32).contiguous()


def _expert_sidecar(rowptr, cols, vals, e: int):
    """Expert e's CSR sidecar with its row pointers from 0."""
    rp = rowptr[e].long()
    lo, hi = int(rp[0]), int(rp[-1])
    return (rp - lo).to(torch.int32), cols[lo:hi], vals[lo:hi]


def moe_lut_matmul_plain(x: torch.Tensor, offsets: torch.Tensor,
                         qweight: torch.Tensor, lut: torch.Tensor,
                         bits: int, *, rowptr=None, cols=None, vals=None,
                         topx_weights=None, topx_indices=None,
                         mode: str = "exact") -> torch.Tensor:
    """The plain PyTorch version of K13: x (P, in) -> (P, out) f32, expert
    by expert through K1's plain version (the sidecar folded as K1 folds
    it) and the top-X rows' ``hybrid_matmul``, as ``quant_linear_apply``
    runs one linear."""
    out_f = qweight.shape[-1]
    y = torch.zeros(x.shape[0], out_f, dtype=torch.float32, device=x.device)
    off = offsets.tolist()
    for e in range(len(off) - 1):
        r0, r1 = off[e], off[e + 1]
        if r1 <= r0:
            continue
        xe = x[r0:r1]
        sparse = {}
        if rowptr is not None:
            rp, c, v = _expert_sidecar(rowptr, cols, vals, e)
            sparse = dict(rowptr=rp, cols=c, vals=v)
        ye = k1.lut_matmul_plain(xe, qweight[e], lut[e], bits, mode=mode,
                                 **sparse)
        if topx_weights is not None:
            ye = plain_ops.hybrid_matmul(xe, topx_weights[e].t(),
                                         topx_indices[e], out_f, base=ye)
        y[r0:r1] = ye
    return y


def moe_lut_matmul(x: torch.Tensor, offsets: torch.Tensor,
                   qweight: torch.Tensor, lut: torch.Tensor, bits: int, *,
                   rowptr=None, cols=None, vals=None, topx_weights=None,
                   topx_indices=None, mode: str = "bf16",
                   variant: str = "mma", tiles: Optional[torch.Tensor] = None,
                   row_tile: Optional[int] = None,
                   per_row: int = 1) -> torch.Tensor:
    """K13 on a CUDA tensor, its plain version on a CPU tensor.

    x (P, in) f32 or bf16, rows sorted by expert; offsets int32 (E + 1,);
    the stacked operands as the module docstring gives them; ``tiles``
    and ``row_tile``: the launch's :func:`tile_map` and its rows a tile
    (:func:`row_tile`); ``per_row``: the experts each token chose (the
    k-split's, :func:`plan`). Returns (P, out) f32. Counts its launches in
    ``moe_lut_matmul.launches`` and, by body, in
    ``moe_lut_matmul.variant_launches``."""
    if bits not in (3, 4):
        raise ValueError(f"K13 takes bits 3 or 4, got {bits}")
    n_exp, nw, out_f = qweight.shape
    P, in_f = x.shape
    if nw != formats.n_words(in_f, bits):
        raise ValueError(f"qweight has {nw} word rows for {in_f} inputs")
    if tuple(offsets.shape) != (n_exp + 1,):
        raise ValueError(f"offsets must be ({n_exp + 1},), got "
                         f"{tuple(offsets.shape)}")
    if x.device.type == "cpu":
        return moe_lut_matmul_plain(
            x, offsets, qweight, lut, bits, rowptr=rowptr, cols=cols,
            vals=vals, topx_weights=topx_weights,
            topx_indices=topx_indices, mode=mode)
    if mode != "bf16":
        raise ValueError("K13 runs bf16 mode only (plain=True for exact)")
    if tiles is None or row_tile is None:
        raise ValueError("K13 needs the launch's tile map and row tile")
    for name, t, dts in (("x", x, (torch.float32, torch.bfloat16)),
                         ("offsets", offsets, (torch.int32,)),
                         ("qweight", qweight, (torch.int32,)),
                         ("lut", lut, (torch.float32,)),
                         ("tiles", tiles, (torch.int32,))):
        k1._check(t, t.shape, dts, name)
    p = plan(in_f, out_f, bits, variant, per_row)
    has_sparse = rowptr is not None
    topx = 0 if topx_weights is None else topx_weights.shape[1]
    folds = FOLDS if has_sparse or topx else 0
    parts = folds + p.splits
    ntiles = tiles.shape[1]
    y = torch.empty((P, out_f), dtype=torch.float32, device=x.device)
    ws = (torch.empty((parts, P, out_f), dtype=torch.float32,
                      device=x.device) if parts > 1 else None)
    col_tiles = -(-out_f // k1.COLS)
    cnt = (k1._counters(x.device, ntiles * col_tiles) if parts > 1
           else None)
    xt = x.t().contiguous() if has_sparse else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.lib().slt_moe_lut_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ptr(xt),
        qweight.data_ptr(), lut.data_ptr(), ptr(rowptr), ptr(cols),
        ptr(vals), ptr(topx_weights), ptr(topx_indices), topx,
        offsets.data_ptr(), tiles.data_ptr(), ntiles, y.data_ptr(), ptr(ws),
        ptr(cnt), P, in_f, out_f, bits, VARIANTS.index(variant) + 1,
        row_tile, p.splits, p.words_per_split, folds,
        _build.stream_ptr(x.device))
    _build.check(err, "moe_lut_matmul")
    moe_lut_matmul.launches += 1
    moe_lut_matmul.variant_launches[variant] += 1
    return y


moe_lut_matmul.launches = 0
moe_lut_matmul.variant_launches = dict.fromkeys(VARIANTS, 0)


def moe_combine_plain(d: torch.Tensor, inv: torch.Tensor, w: torch.Tensor,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The plain version of the combine: rows (T, n) in residual's type
    (f32 without one) of residual + sum_j w[:, j] * d[inv[:, j]], the sum
    in f32 in the order j = 0 .. k - 1, the residual added last."""
    acc = torch.zeros(inv.shape[0], d.shape[1], dtype=torch.float32,
                      device=d.device)
    for j in range(inv.shape[1]):
        acc = acc + w[:, j:j + 1] * d[inv[:, j]]
    if residual is None:
        return acc
    return (residual.float() + acc).to(residual.dtype)


def moe_combine(d: torch.Tensor, inv: torch.Tensor, w: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The combine in one launch on a CUDA tensor (its plain version on a
    CPU one): d (P, n) f32, inv (T, k) int64, w (T, k) f32, residual
    (T, n) bf16 or f32 or None; returns (T, n) in residual's type (f32
    without one). Counts its launches in ``moe_combine.launches``."""
    if d.device.type == "cpu":
        return moe_combine_plain(d, inv, w, residual)
    rows, k = inv.shape
    n = d.shape[1]
    dt = residual.dtype if residual is not None else torch.float32
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"residual dtype {dt} (f32 or bf16)")
    for name, t, dts in (("d", d, (torch.float32,)),
                         ("inv", inv, (torch.int64,)),
                         ("w", w, (torch.float32,))):
        k1._check(t, t.shape, dts, name)
    if residual is not None:
        k1._check(residual, (rows, n), (dt,), "residual")
    out = torch.empty((rows, n), dtype=dt, device=d.device)
    err = _build.lib().slt_moe_combine(
        d.data_ptr(), inv.data_ptr(), w.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        rows, k, n, int(dt == torch.bfloat16), _build.stream_ptr(d.device))
    _build.check(err, "moe_combine")
    moe_combine.launches += 1
    return out


moe_combine.launches = 0
