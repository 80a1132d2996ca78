"""What every traffic kind shares: the requests, their sizes and their
token ids.

Sizes come in rounds of ``ROUND`` requests. Every round holds the same
multiset: prompt lengths at the ``ROUND`` mid-quantiles of the mix's
prompt distribution, output lengths likewise, paired and ordered by a
fixed permutation per round. The run's seed rotates that sequence by
``seed % ROUND`` places and draws the token ids: every seed asks for the
same work, in another order, with the same neighbours. When the seed
shuffled each round instead, two runs of one seed agreed within 1% on the
95th percentile of time to first token while six seeds spread over
+-11% (``mistral-7b-w4.docqa``): the order of long prompts, not the card,
set the tail.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List, Optional

import numpy as np

NORMAL = statistics.NormalDist()
ROUND = 32  # requests a round of sizes


def quantile(dist: dict, u: float) -> int:
    """The u-quantile of a length distribution, rounded and clipped:
    ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
    ``{"dist": "uniform", "min", "max"}``."""
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "lognormal":
        x = math.exp(math.log(dist["median"]) + dist["sigma"]
                     * NORMAL.inv_cdf(u))
    elif dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return int(min(hi, max(lo, round(x))))


def _nonneg(seed: int) -> int:
    return int(seed) % 2**64


@dataclasses.dataclass
class Request:
    index: int           # place in the run's sequence of requests
    prompt_len: int
    max_new: int
    due: float           # when it was sent (closed) or due (open)
    noticed: float = 0.0  # when the loop first saw it
    rid: Optional[int] = None
    admitted: Optional[float] = None
    first: Optional[float] = None  # first tokens landed
    last: Optional[float] = None   # latest tokens landed
    landed: int = 0
    done: Optional[float] = None
    failed: bool = False
    tokens: Optional[List[int]] = None  # served tokens, once done


class Sizes:
    """(prompt length, output length) of the i-th request of a run."""

    def __init__(self, mix: dict, seed: int):
        self.k = ROUND
        self.offset = _nonneg(seed) % self.k
        us = [(i + 0.5) / self.k for i in range(self.k)]
        self.prompts = [quantile(mix["prompt"], u) for u in us]
        self.outputs = [quantile(mix["output"], u) for u in us]
        self._round = {}

    def _pairs(self, r: int):
        if r not in self._round:
            rng = np.random.default_rng([0, r])
            pair, order = rng.permutation(self.k), rng.permutation(self.k)
            self._round = {r: [(self.prompts[i], self.outputs[pair[i]])
                               for i in order]}
        return self._round[r]

    def __call__(self, index: int):
        j = index + self.offset
        return self._pairs(j // self.k)[j % self.k]


def prompt_tokens(seed: int, index: int, length: int,
                  vocab: int) -> List[int]:
    """The i-th request's prompt: ids uniform over the vocabulary (two
    prompts share no page-long prefix but by a chance of vocab**-128)."""
    rng = np.random.default_rng([_nonneg(seed), 2, index])
    return rng.integers(0, vocab, length).tolist()
