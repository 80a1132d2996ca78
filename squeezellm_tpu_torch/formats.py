"""Packed-weight, LUT and sparse-outlier formats, in PyTorch.

The port's own copy of the shared checkpoint packing (the JAX package's
``squeezellm_tpu/formats.py`` defines it; the two must stay identical):

* 4-bit: 8 codes per int32 word, code ``j`` of a word at bits ``4*j``.
* 3-bit: 10 codes per int32 word at bits ``3*j``; the top 2 bits are unused.
* 2-bit / 8-bit: 16 / 4 codes per word.
* Words are packed along the INPUT dim: ``qweight`` is int32
  ``(n_words(in, bits), out)``, so the output axis is contiguous.
* ``lut`` is float32 ``(out, 2**bits)``: one codebook per output channel.
* The sparse sidecar stores ``w - centroid_nearest_zero(channel)`` at each
  outlier slot: it is a correction added on top of the dequantized slot.
  On disk it is a flat COO list sorted by row then column and zero-padded
  to a multiple of ``pad_multiple`` entries (:class:`SparseCOO`); in memory
  the port keeps it as CSR (``carry.csr_from_coo``).

The reference's own CUDA layout (``pack_codes_ref`` / ``unpack_codes_ref``,
read only by ``convert``) packs 4-bit codes as above but 3-bit codes as a
contiguous bit stream: 32 inputs in 3 words, input ``j`` of a group at bit
``3*j`` of the 96, so inputs 10 and 21 straddle a word boundary.

Packing runs on the tensors' own device (the offline pipeline and
``convert`` pack on the card); :class:`SparseCOO` hands its arrays back to
the host as numpy, the form a checkpoint stores.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SUPPORTED_BITS = (2, 3, 4, 8)
# Codes packed per int32 word.
CODES_PER_WORD = {2: 16, 3: 10, 4: 8, 8: 4}


def n_words(in_features: int, bits: int) -> int:
    """Number of packed int32 words along the input dim."""
    cpw = CODES_PER_WORD[bits]
    return (in_features + cpw - 1) // cpw


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer codes ``(in, out)`` in ``[0, 2**bits)`` -> int32
    ``(n_words(in, bits), out)``; the slots past ``in`` in the last word
    hold 0."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    if codes.dim() != 2:
        raise ValueError(f"codes must be (in, out), got shape "
                         f"{tuple(codes.shape)}")
    in_features, out_features = codes.shape
    cpw = CODES_PER_WORD[bits]
    nw = n_words(in_features, bits)
    padded = torch.zeros(nw * cpw, out_features, dtype=torch.int64,
                         device=codes.device)
    padded[:in_features] = codes.to(torch.int64) & ((1 << bits) - 1)
    padded = padded.view(nw, cpw, out_features)
    shifts = torch.arange(0, bits * cpw, bits, device=codes.device,
                          dtype=torch.int64)
    words = (padded << shifts[None, :, None]).sum(1)  # < 2**32, no overlap
    return _int32(words)


def unpack_codes(qweight: torch.Tensor, bits: int,
                 in_features: int) -> torch.Tensor:
    """int32 ``(n_words, out)`` -> int64 codes ``(in, out)``.

    Shifts are taken on the zero-extended 64-bit word with an explicit
    mask, so the sign bit and the unused high bits of a 3-bit word never
    leak into a code; codes past ``in_features`` in the last word are cut.
    """
    cpw = CODES_PER_WORD[bits]
    nw, out_features = qweight.shape
    if nw != n_words(in_features, bits):
        raise ValueError(
            f"qweight has {nw} words; expected {n_words(in_features, bits)}")
    words = qweight.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, bits * cpw, bits, device=qweight.device,
                          dtype=torch.int64)
    codes = (words[:, None, :] >> shifts[None, :, None]) & ((1 << bits) - 1)
    return codes.reshape(nw * cpw, out_features)[:in_features]


def _int32(words: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit words held in int64 -> the int32 of the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _ref_group(bits: int):
    """(inputs, words) of one group of the reference layout."""
    if bits == 4:
        return 8, 1
    if bits == 3:
        return 32, 3
    raise ValueError(f"reference layout supports bits in (3, 4), got {bits}")


def _ref_slots(bits: int):
    """Per input of a group: (word, shift, spill), the code at bit
    ``shift`` of ``word`` and, where ``spill`` > 0, its top ``spill`` bits
    at the bottom of the next word (3-bit inputs 10 and 21)."""
    n, _ = _ref_group(bits)
    out = []
    for j in range(n):
        word, shift = divmod(bits * j, 32)
        out.append((word, shift, max(0, shift + bits - 32)))
    return out


def pack_codes_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Codes ``(in, out)`` -> int32 ``(in // 32 * bits, out)`` in the
    reference layout (its ``QuantLinearLUT.pack2``): 4-bit 8 codes a word
    at bits ``4*j``; 3-bit 32 codes in 3 words as one bit stream. Works in
    int64 on the tensor's device (CUDA has no unsigned 32-bit shift)."""
    n, nw = _ref_group(bits)
    in_features, out_features = codes.shape
    if in_features % n:
        raise ValueError(f"reference {bits}-bit layout needs in % {n} == 0")
    g = (codes.to(torch.int64) & ((1 << bits) - 1)).view(
        in_features // n, n, out_features)
    words = torch.zeros(in_features // n, nw, out_features,
                        dtype=torch.int64, device=codes.device)
    for j, (word, shift, spill) in enumerate(_ref_slots(bits)):
        words[:, word] |= (g[:, j] << shift) & 0xFFFFFFFF
        if spill:
            words[:, word + 1] |= g[:, j] >> (bits - spill)
    return _int32(words.view(-1, out_features))


def unpack_codes_ref(qweight: torch.Tensor, bits: int,
                     in_features: int) -> torch.Tensor:
    """Reference-layout words ``(in // 32 * bits, out)`` -> uint8 codes
    ``(in, out)``: each 32-bit word zero-extended to int64, so no sign bit
    reaches a code."""
    n, nw = _ref_group(bits)
    out_features = qweight.shape[1]
    if in_features % n or qweight.shape[0] != in_features // n * nw:
        raise ValueError(f"qweight {tuple(qweight.shape)} does not hold "
                         f"{in_features} {bits}-bit inputs")
    words = (qweight.to(torch.int64) & 0xFFFFFFFF).view(
        in_features // n, nw, out_features)
    codes = torch.empty(in_features // n, n, out_features, dtype=torch.uint8,
                        device=qweight.device)
    mask = (1 << bits) - 1
    for j, (word, shift, spill) in enumerate(_ref_slots(bits)):
        c = words[:, word] >> shift
        if spill:
            c = c | (words[:, word + 1] << (bits - spill))
        codes[:, j] = (c & mask).to(torch.uint8)
    return codes.view(in_features, out_features)


def convert_ref_qweight(qweight_ref: torch.Tensor, bits: int,
                        in_features: int) -> torch.Tensor:
    """Reference-layout words -> the shared checkpoint's words, on the
    tensor's device."""
    return pack_codes(unpack_codes_ref(qweight_ref, bits, in_features), bits)


def assign_codes(weight: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid codes: weight ``(out, in)``, lut ``(out, K)`` ->
    uint8 ``(out, in)``, argmin of ``|w - c|`` with the first index taking
    a tie (the reference's ``round_to_nearest_pole_sim``). Walks the K
    centroids instead of materializing ``(out, in, K)``."""
    best = (weight - lut[:, :1]).abs()
    codes = torch.zeros(weight.shape, dtype=torch.uint8, device=weight.device)
    for k in range(1, lut.shape[1]):
        d = (weight - lut[:, k: k + 1]).abs()
        closer = d < best
        best = torch.where(closer, d, best)
        codes[closer] = k
    return codes


def nearest_to_zero(lut: torch.Tensor) -> torch.Tensor:
    """Per channel, the centroid nearest zero (first one on a tie): the
    value the dense path dequantizes a zeroed outlier slot to. lut
    ``(out, K)`` -> ``(out,)``."""
    idx = lut.abs().argmin(dim=1, keepdim=True)
    return lut.gather(1, idx)[:, 0]


@dataclasses.dataclass
class SparseCOO:
    """Flat COO over output rows, padded to a static nnz, as numpy arrays
    (the checkpoint's ``sp_rows``, ``sp_cols``, ``sp_vals``).

    rows/cols index (out, in) of the torch-orientation W. Padding entries
    have ``vals == 0`` (rows/cols 0)."""

    rows: np.ndarray  # int32 (nnz_pad,)
    cols: np.ndarray  # int32 (nnz_pad,)
    vals: np.ndarray  # float32 (nnz_pad,)
    nnz: int
    out_features: int
    in_features: int

    @staticmethod
    def from_dense(outlier_matrix: torch.Tensor, pad_to: Optional[int] = None,
                   pad_multiple: int = 512) -> "SparseCOO":
        """From a dense (out, in) matrix of outlier values (0 = absent):
        the nonzeros in row-major order (sorted by row, then column),
        padded to ``pad_to`` or to the next multiple of ``pad_multiple``
        (at least one multiple)."""
        out_features, in_features = outlier_matrix.shape
        idx = torch.nonzero(outlier_matrix)  # row-major order
        vals = outlier_matrix[idx[:, 0], idx[:, 1]].float()
        nnz = idx.shape[0]
        if pad_to is None:
            pad_to = max(pad_multiple,
                         -(-nnz // pad_multiple) * pad_multiple)
        if pad_to < nnz:
            raise ValueError(f"pad_to={pad_to} < nnz={nnz}")
        pr = np.zeros(pad_to, np.int32)
        pc = np.zeros(pad_to, np.int32)
        pv = np.zeros(pad_to, np.float32)
        idx = idx.cpu().numpy()
        pr[:nnz], pc[:nnz] = idx[:, 0], idx[:, 1]
        pv[:nnz] = vals.cpu().numpy()
        return SparseCOO(pr, pc, pv, nnz, out_features, in_features)

    @staticmethod
    def from_csr(crow, col, val, in_features: int,
                 pad_multiple: int = 512) -> "SparseCOO":
        """From the reference's CSR buffers (``rows`` = row pointers,
        ``cols``, ``vals``; tensors or numpy, on any device), entries kept
        in their CSR order, padded to the next multiple of
        ``pad_multiple`` (at least one multiple)."""
        crow, col, val = (t if isinstance(t, torch.Tensor)
                          else torch.from_numpy(np.asarray(t))
                          for t in (crow, col, val))
        out_features = crow.numel() - 1
        nnz = val.numel()
        rows = torch.repeat_interleave(
            torch.arange(out_features, device=crow.device),
            (crow[1:] - crow[:-1]).long())
        pad_to = max(pad_multiple, -(-nnz // pad_multiple) * pad_multiple)
        pr = np.zeros(pad_to, np.int32)
        pc = np.zeros(pad_to, np.int32)
        pv = np.zeros(pad_to, np.float32)
        pr[:nnz] = rows.cpu().numpy()
        pc[:nnz] = col.cpu().numpy()
        pv[:nnz] = val.float().cpu().numpy()
        return SparseCOO(pr, pc, pv, nnz, out_features, in_features)
