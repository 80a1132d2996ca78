"""K11: transposed 4-bit LUT GEMV, the decode path of a linear that carries
``qweight_t`` (``models.fuse.attach_decode_luts(transposed=True)``).

``y = x @ W`` for x (M <= 8, in) with ``W[i, o] = lut[o, code]``, the code
the 4 bits ``(i % 8) * 4`` of ``qweight_t[o, i // 8]``: the packed words
stored transposed, (out, n_words), so that a channel's words are
contiguous. f32 out. The CUDA kernel (``csrc/lut_matmul_t.cu``) replaces
the TPU kernel ``_lut_matmul_t_kernel`` of
``squeezellm_tpu/ops/pallas_ops.py`` (``lut_matmul_t``); it reads the
(out, 16) LUT, not the TPU's period-16 wide table. Its bound on the H100
and how the design meets it are noted in the CUDA source.

Modes as K1's: ``exact`` f32 throughout (f32 FMAs on the CUDA cores);
``bf16`` rounds x and the LUT to bf16 before the products (as the TPU's
one-pass MXU does) and accumulates in f32 (the tensor cores). The sparse
sidecar is not folded here: ``quant_linear`` adds K12's sum
(``ops/spmv``) after it, as the JAX package adds ``gather_spmv``'s.

:func:`plan` splits the packed words over blocks when a layer has too few
128-channel tiles to fill the card; it reads the layer's shape only, so a
row's result does not depend on the other rows of the call.
"""

from __future__ import annotations

import functools

import torch

from squeezellm_tpu_torch import _build, formats
from squeezellm_tpu_torch.ops import plain_ops
from squeezellm_tpu_torch.ops.lut_matmul import (MODES, SMS, _check,
                                                 _counters, _round_bf16,
                                                 grown)

MAX_ROWS = 8  # quant_linear takes this route at 8 rows and fewer
COLS = 128  # output channels a block (kCols in csrc/lut_matmul_t.cu)
SPAN = 16  # packed words a block's ring step (kSpan)
MAX_SPLIT_WORDS = 128  # packed words a block at most (kMaxSplitWords)
BLOCKS_PER_SM = 2  # the kernel's shared memory lets 2 blocks share an SM


@functools.lru_cache(maxsize=None)
def plan(in_f: int, out_f: int) -> tuple:
    """(splits, words_per_split) for an (in_f -> out_f) layer: enough
    blocks to give every SM two, no block more than MAX_SPLIT_WORDS words
    (its x chunk lives in shared memory), splits of whole SPANs. A function
    of the shape only."""
    spans = -(-formats.n_words(in_f, 4) // SPAN)
    tiles = -(-out_f // COLS)
    splits = max(-(-spans * SPAN // MAX_SPLIT_WORDS),
                 min(spans, -(-SMS * BLOCKS_PER_SM // tiles)))
    per = -(-spans // splits)
    return -(-spans // per), per * SPAN


_WORKSPACE = {}


def _workspace(device, n: int) -> torch.Tensor:
    """The k-split's f32 partials on `device`, kept between calls: each
    launch writes and reads its own part within itself, in stream order."""
    return grown(_WORKSPACE, device, n, lambda m: torch.empty(
        m, dtype=torch.float32, device=device))


def lut_matmul_t_plain(x: torch.Tensor, qweight_t: torch.Tensor,
                       lut: torch.Tensor, *,
                       mode: str = "exact") -> torch.Tensor:
    """The plain PyTorch version of K11: x (M, in) -> y (M, out) f32."""
    lut_d = _round_bf16(lut.float()) if mode == "bf16" else lut.float()
    xd = _round_bf16(x.float()) if mode == "bf16" else x.float()
    w = plain_ops.dequantize(qweight_t.t(), lut_d, 4, x.shape[-1])
    return torch.matmul(xd, w)


def lut_matmul_t(x: torch.Tensor, qweight_t: torch.Tensor, lut: torch.Tensor,
                 *, mode: str = "exact") -> torch.Tensor:
    """K11 on a CUDA tensor, its plain version on a CPU tensor.

    x: (M, in) f32 or bf16, M in 1..8; qweight_t int32 (out, n_words(in,
    4)); lut f32 (out, 16); all contiguous. Returns (M, out) f32. Counts
    its launches in ``lut_matmul_t.launches``."""
    dev = x.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"lut_matmul_t: unsupported device {x.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"lut_matmul_t takes x (1..{MAX_ROWS}, in), got "
                         f"{tuple(x.shape)}")
    M, in_f = x.shape
    out_f = qweight_t.shape[0]
    _check(x, (M, in_f), (torch.float32, torch.bfloat16), "x", dev)
    _check(qweight_t, (out_f, formats.n_words(in_f, 4)), (torch.int32,),
           "qweight_t", dev)
    _check(lut, (out_f, 16), (torch.float32,), "lut", dev)
    if dev == "cpu":
        return lut_matmul_t_plain(x, qweight_t, lut, mode=mode)
    splits, per = plan(in_f, out_f)
    y = torch.empty((M, out_f), dtype=torch.float32, device=x.device)
    ws = cnt = None
    if splits > 1:
        ws = _workspace(x.device, splits * M * out_f)
        cnt = _counters(x.device, -(-out_f // COLS))
    err = _build.lib().slt_lut_matmul_t(
        x.data_ptr(), int(x.dtype == torch.bfloat16), qweight_t.data_ptr(),
        lut.data_ptr(), y.data_ptr(), ws.data_ptr() if ws is not None
        else None, cnt.data_ptr() if cnt is not None else None, M, in_f,
        out_f, int(mode == "bf16"), splits, per,
        _build.stream_ptr(x.device))
    _build.check(err, "lut_matmul_t")
    lut_matmul_t.launches += 1
    return y


lut_matmul_t.launches = 0
