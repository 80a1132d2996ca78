"""Closed loop: ``clients`` clients with zero think time. Each sends its
next request the moment its last one finishes (or is refused), so a
slower system receives less load. Mix keys: ``clients``, ``prompt``,
``output`` (length distributions, ``pbench.mixes.quantile``).
"""

from __future__ import annotations

from pbench.mixes import Request, Sizes


class Traffic:
    def __init__(self, mix: dict, seed: int, start: float):
        self.clients = mix["clients"]
        self.sizes = Sizes(mix, seed)
        self.sent = 0
        self._queue = [self._send(start) for _ in range(self.clients)]

    def _send(self, now: float) -> Request:
        plen, out = self.sizes(self.sent)
        self.sent += 1
        return Request(index=self.sent - 1, prompt_len=plen, max_new=out,
                       due=now)

    def due(self, now: float):
        out, self._queue = self._queue, []
        for r in out:
            r.noticed = now
        return out

    def finished(self, req: Request, now: float) -> None:
        self._queue.append(self._send(now))

    def ready(self, started: int, slots: int, now: float) -> bool:
        """Every client has a request in flight, the slots are full, and
        each of those requests has its first tokens (``started``)."""
        return started >= min(self.clients, slots)

    def next_due(self, now: float):
        return None

    def report(self) -> dict:
        return {"clients": self.clients, "sent": self.sent}


def make(mix: dict, seed: int, start: float) -> Traffic:
    return Traffic(mix, seed, start)
