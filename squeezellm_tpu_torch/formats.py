"""Packed-weight, LUT and sparse-outlier formats, read in PyTorch.

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
"""

from __future__ import annotations

import torch

# Codes packed per int32 word.
CODES_PER_WORD = {2: 16, 3: 10, 4: 8, 8: 4}


def n_words(in_features: int, bits: int) -> int:
    """Number of packed int32 words along the input dim."""
    cpw = CODES_PER_WORD[bits]
    return (in_features + cpw - 1) // cpw


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
