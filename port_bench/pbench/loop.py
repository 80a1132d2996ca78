"""The client loop the window drives: the structure of the port's
``_SlotEngine.run``, with arrival times.

Each iteration (1) admits the requests that are due, up to the free slots,
through ``add_requests`` (one call a group of equal output length: the
call takes one ``max_new_tokens``, and each request passes its own);
(2) steps one decode window (``step_window``); (3) streams the window's
tokens back to their clients, and a closed loop's client sends its next
request. The loop runs, untimed, until the traffic says it is ready (a
closed loop: every client has a request in flight, the slots are full,
and each of those requests has its first tokens); then the window opens.
The ramp's requests are admitted together, one after another, and would
otherwise lend the window a time to first token that only the start
makes: in a 45 s trial they were 16 of ~190 and set the 95th percentile
(1.92 s against 0.37 s for the requests of the window's second half). It closes at the first iteration that ends
``seconds`` or more after it opened. Tokens count where they land: a
request sent before the window counts only for what lands inside it.

Each call into the program runs inside a ``record_function`` span, and
its host interval is kept (``Span``), with what the call was given.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from torch.profiler import record_function

from pbench import mixes


@dataclasses.dataclass
class Span:
    t0: float
    t1: float
    traced: bool
    prompts: Optional[List[int]] = None   # an admission's prompt lengths
    steps: int = 0                        # a decode window's steps
    contexts: Optional[List[int]] = None  # keys of each slot at its first
    tokens: int = 0                       # tokens the window landed


@dataclasses.dataclass
class Loop:
    opened: float
    closed: float
    requests: List[mixes.Request]
    admissions: List[Span]
    windows: List[Span]
    decode_steps: int  # growth of the engine's decode-step count in it
    traffic: dict

    def inside(self, t: Optional[float]) -> bool:
        return t is not None and self.opened < t <= self.closed

    @property
    def seconds(self) -> float:
        return self.closed - self.opened


def drive(eng, traffic, *, window: int, slots: int, seconds: float,
          seed: int, vocab: int, tracer=None,
          clock=time.perf_counter) -> Loop:
    queue: List[mixes.Request] = []
    inflight: Dict[int, mixes.Request] = {}
    requests: List[mixes.Request] = []
    admissions: List[Span] = []
    windows: List[Span] = []
    opened = closed = None
    steps0 = 0
    while closed is None:
        now = clock()
        new = traffic.due(now)
        queue.extend(new)
        requests.extend(new)
        n = min(len(queue), eng.free_slots())
        if n:
            take, queue = queue[:n], queue[n:]
            groups: Dict[int, List[mixes.Request]] = {}
            for r in take:
                groups.setdefault(r.max_new, []).append(r)
            traced = tracer is not None and tracer.active
            t0 = clock()
            admitted = []
            with record_function("pb.admission"):
                for max_new, group in groups.items():
                    prompts = [mixes.prompt_tokens(seed, r.index,
                                                   r.prompt_len, vocab)
                               for r in group]
                    try:
                        rids = eng.add_requests(prompts, max_new)
                    except (ValueError, RuntimeError):
                        for r in group:
                            r.failed = True
                            traffic.finished(r, clock())
                        continue
                    for r, rid in zip(group, rids):
                        r.rid = rid
                        inflight[rid] = r
                        admitted.append(r)
            t1 = clock()
            for r in admitted:
                r.admitted = t1
            admissions.append(Span(t0, t1, traced,
                                   prompts=[r.prompt_len for r in admitted]))
        started = sum(r.first is not None for r in inflight.values())
        if opened is None and traffic.ready(started, slots, clock()):
            opened = clock()
            steps0 = eng.stats["decode_steps"]
        if not inflight:
            nxt = traffic.next_due(clock())
            if nxt is not None:
                time.sleep(min(0.01, max(0.0, nxt - clock())))
            continue
        contexts = [r.prompt_len + r.landed for r in inflight.values()]
        traced = tracer is not None and tracer.active
        t0 = clock()
        with record_function("pb.decode_window"):
            out = eng.step_window(window)
        t1 = clock()
        with record_function("pb.client"):
            k = landed = 0
            for rid, res in out.items():
                r = inflight[rid]
                got = len(res["new_tokens"])
                k = max(k, got)
                if r.first is None:
                    r.first = t1
                r.last = t1
                r.landed += got
                landed += got
                if res["done"]:
                    r.done = t1
                    r.tokens = list(res["tokens"])
                    del inflight[rid]
                    traffic.finished(r, t1)
        windows.append(Span(t0, t1, traced, steps=k, contexts=contexts,
                            tokens=landed))
        if opened is not None:
            if tracer is not None:
                tracer.tick(t1, opened)
            if t1 - opened >= seconds:
                closed = t1
    if tracer is not None:
        tracer.stop()
    return Loop(opened=opened, closed=closed, requests=requests,
                admissions=admissions, windows=windows,
                decode_steps=eng.stats["decode_steps"] - steps0,
                traffic=traffic.report())
