"""Percentiles, frozen here so that a change to the program cannot move
them."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence


def pct(xs: Sequence[float], p: float) -> Optional[float]:
    """The p-quantile of xs as ``serve-bench`` took it
    (``squeezellm_tpu_torch/cli.py``): the sorted sample's element at
    ``int(p * n)``, the last one at most; None for no sample."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else None


def median(xs: Sequence[float]) -> Optional[float]:
    return statistics.median(xs) if xs else None
