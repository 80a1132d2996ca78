"""The control's rounding, the same for every family: what the program
holds at its configuration's precision (bf16), taken to the precision
below it."""

from __future__ import annotations

import torch


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3, each row scaled to its range (448)."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
