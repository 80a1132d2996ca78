"""Open loop: requests due on a schedule, whether or not earlier ones have
finished. Mix keys: ``rate`` (requests a second while on), optional
``burst`` ``{"on_s", "off_s"}`` (arrivals only during the on periods, at
``rate``), ``ramp_s`` (seconds after the start at which the window may
open), and the lengths as for ``closed``.

Gaps between arrivals are the mid-quantiles of an exponential of mean
1 / rate, one round of them at a time in a fixed order, rotated by the
seed as the sizes are (``pbench.mixes``), so every seed offers the same
arrivals in another order. A
request's times count from when it was due; the loop sees it only between
its windows, and how late it saw each one is reported (``lateness``).
"""

from __future__ import annotations

import math

import numpy as np

from pbench.mixes import Request, Sizes, _nonneg


class Traffic:
    def __init__(self, mix: dict, seed: int, start: float):
        self.sizes = Sizes(mix, seed)
        self.rate = float(mix["rate"])
        self.burst = mix.get("burst")
        self.ramp = float(mix.get("ramp_s", 2.0))
        self.start = start
        self.offset = _nonneg(seed) % self.sizes.k
        k = self.sizes.k
        self.gaps = [-math.log(1 - (i + 0.5) / k) / self.rate
                     for i in range(k)]
        self.sent = 0
        self.on_time = 0.0  # arrival clock, counting on periods only
        self.lateness = []
        self._next = self._arrival()

    def _wall(self, tau: float) -> float:
        if not self.burst:
            return self.start + tau
        on, off = self.burst["on_s"], self.burst["off_s"]
        return self.start + (tau // on) * (on + off) + tau % on

    def _arrival(self) -> float:
        k = self.sizes.k
        r, j = divmod(self.sent + self.offset, k)
        order = np.random.default_rng([0, 3, r]).permutation(k)
        self.on_time += self.gaps[order[j]]
        return self._wall(self.on_time)

    def due(self, now: float):
        out = []
        while self._next <= now:
            plen, n = self.sizes(self.sent)
            out.append(Request(index=self.sent, prompt_len=plen, max_new=n,
                               due=self._next, noticed=now))
            self.lateness.append(now - self._next)
            self.sent += 1
            self._next = self._arrival()
        return out

    def finished(self, req: Request, now: float) -> None:
        pass

    def ready(self, started: int, slots: int, now: float) -> bool:
        return now - self.start >= self.ramp

    def next_due(self, now: float):
        return self._next

    def report(self) -> dict:
        late = sorted(self.lateness)
        return {"rate": self.rate, "sent": self.sent,
                "lateness_p50_s": late[len(late) // 2] if late else None,
                "lateness_max_s": late[-1] if late else None}


def make(mix: dict, seed: int, start: float) -> Traffic:
    return Traffic(mix, seed, start)
