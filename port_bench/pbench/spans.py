"""The program's own spans in the traced sub-window, and what they show.

``squeezellm_tpu_torch.tracing.span`` records the parts of the program as
host events named ``slm.<part>`` on the profiler's clock (nested: an
admission's ``admit.stage``, ``prefill``, ``admit.scatter`` and
``admit.seed``; inside ``prefill`` the forward's ``linear.<route>``,
``attn``, ``kv``, ``norm``, ``rope``, ``act`` and ``head``; a decode
window's ``window.upload``, ``window.launch``, ``window.sync`` and
``window.collect``). :func:`extract` keeps them beside
``trace.extract``'s events, and :func:`reduce` adds to
``trace.reduce``'s result, whose keys it leaves as they are:

* ``busy_by_program_span_s``: device seconds by
  ``<harness label>/<innermost program span>`` open when the host
  launched the work (its runtime call, by correlation id, as
  ``trace.reduce`` finds the harness span); work launched with no
  program span open is left out;
* ``host_by_program_span_s``: each span's self time on the host (its
  children's time taken out);
* ``open_by_program_span_s``: the time a span of each name is open, its
  children's time included;
* ``idle_by_program_span_s``: device idle time while a span of each name
  is open, at any depth;
* ``idle_gaps``: each idle gap split by the harness span and the
  innermost program span open, labelled ``<harness label>/<span>``, or
  the harness label alone where no program span is open (all labels,
  largest first: those under one harness label sum to its figure in
  ``trace.reduce``'s ``idle_gaps``).

With no program span in the events (a program without spans), the
result is ``trace.reduce``'s, unchanged.

A replayed CUDA graph runs no Python, so the work of a replayed decode
step falls under ``window.launch`` whole.

``prefill_linears`` and ``prefill_attention`` count the work of the
spans that the admission's rooflines read, as ``work.Work.prefill``
counts a whole prompt.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

from pbench import trace, weights, work

PREFIX = "slm."

Interval = Tuple[int, int]


def program_spans(prof) -> List[Tuple[str, int, int]]:
    """(name without the prefix, start, end) in ns of every host event
    named ``slm.*`` in a finished profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(PREFIX) and "CUDA" not in str(e.device_type()):
            out.append((name[len(PREFIX):], trace._ns(e, "start"),
                        trace._ns(e, "end")))
    return out


def extract(prof) -> dict:
    """``trace.extract``'s events with the program's spans under
    ``program``."""
    return dict(trace.extract(prof), program=program_spans(prof))


class _Timeline:
    """A label at every instant, from change points ``(t, label)`` in
    time order (at equal times the last one holds); ``before`` before
    the first."""

    def __init__(self, points, before=None):
        self.times = [t for t, _ in points]
        self.labels = [label for _, label in points]
        self.before = before

    def at(self, t: int):
        i = bisect.bisect_right(self.times, t) - 1
        return self.labels[i] if i >= 0 else self.before

    def split(self, a: int, b: int) -> Dict[object, int]:
        """ns of [a, b) under each label."""
        out: Dict[object, int] = collections.Counter()
        i = bisect.bisect_right(self.times, a)
        cur, t = (self.labels[i - 1] if i else self.before), a
        while i < len(self.times) and self.times[i] < b:
            out[cur] += self.times[i] - t
            cur, t = self.labels[i], self.times[i]
            i += 1
        out[cur] += b - t
        return out


def _innermost(spans) -> List[Tuple[int, Optional[str]]]:
    """Change points of the innermost span open (None: none), from spans
    that nest, as the spans of one thread do."""
    points: List[Tuple[int, Optional[str]]] = []
    stack: List[Tuple[int, str]] = []  # (end, name), innermost last

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            points.append((end, stack[-1][1] if stack else None))

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_until(a)
        stack.append((b, name))
        points.append((a, name))
    close_until(float("inf"))
    return points


def _harness_points(spans) -> List[Tuple[int, Optional[str]]]:
    points = []
    for name, a, b in sorted(spans, key=lambda s: s[1]):
        points += [(a, trace._label(name)), (b, None)]
    return points


def _combined(harness, program) -> _Timeline:
    """(harness label, innermost program span) at every instant."""
    merged = sorted([(t, 0, label) for t, label in harness]
                    + [(t, 1, label) for t, label in program],
                    key=lambda p: p[0])
    cur: List[Optional[str]] = [None, None]
    points = []
    for t, which, label in merged:
        cur[which] = label
        points.append((t, tuple(cur)))
    return _Timeline(points, before=(None, None))


def _name(harness: Optional[str], span: Optional[str]) -> str:
    h = harness or "loop"
    return f"{h}/{span}" if span else h


def _clip(intervals, w0: int, w1: int) -> List[Interval]:
    return [(max(a, w0), min(b, w1)) for a, b in intervals
            if min(b, w1) > max(a, w0)]


def _overlap(xs: List[Interval], ys: List[Interval]) -> int:
    """ns that two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(ev: dict, top: int = 10) -> Optional[dict]:
    """``trace.reduce(ev, top)`` and the program spans' keys (module
    docstring)."""
    r = trace.reduce(ev, top)
    program = ev.get("program")
    if r is None or not program:
        return r
    w0, w1 = next((a, b) for n, a, b in ev["spans"] if n == trace.TRACED)
    harness = [s for s in ev["spans"] if s[0] in trace.SPANS]
    inner = _Timeline(_innermost(program))
    both = _combined(_harness_points(harness), _innermost(program))

    busy = collections.defaultdict(list)
    clipped = []
    for _, a, b, corr in ev["device"]:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        launch = ev["runtime"].get(corr)
        h, p = both.at(launch if launch is not None else a)
        if p:
            busy[_name(h, p)].append((a, b))
    idle, prev = [], w0
    for a, b in trace.union(clipped) + [(w1, w1)]:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)

    gaps: Dict[str, int] = collections.Counter()
    for a, b in idle:
        for (h, p), ns in both.split(a, b).items():
            gaps[_name(h, p)] += ns
    by_name = collections.defaultdict(list)
    for name, a, b in program:
        by_name[name].append((a, b))
    opened, idle_in = {}, {}
    for name, spans in by_name.items():
        spans = trace.union(_clip(spans, w0, w1))
        opened[name] = trace._length(spans) / 1e9
        idle_in[name] = _overlap(spans, idle) / 1e9
    host = {p: ns / 1e9 for p, ns in inner.split(w0, w1).items() if p}

    r.update(
        busy_by_program_span_s={k: trace._length(trace.union(v)) / 1e9
                                for k, v in busy.items()},
        host_by_program_span_s=host,
        open_by_program_span_s=opened,
        idle_by_program_span_s=idle_in,
        idle_gaps=[[n, ns / 1e9] for n, ns in gaps.most_common()],
    )
    return r


def prefill_linears(cfg: dict, n: int):
    """(bytes, flops) of the decoder's quantized linears over a prompt of
    n tokens: the packed weights as ``work.Work`` counts them (no head,
    embeddings or norms) and the bf16 rows in and out of each linear;
    2 x the multiply-adds."""
    q = weights.quant(cfg)
    bits, topx, opt = q["bits"], q["topx"], weights.is_opt(cfg)
    nbytes = macs = 0
    for o, i in weights.linear_shapes(cfg).values():
        nnz = weights.sidecar_count(o, i, q["sparsity"])
        nbytes += (o * i * bits / 8 + o * 2**bits * 4 + nnz * 8
                   + (o + 1) * 4 + i * topx * 4 + topx * 4
                   + (o * 4 if opt else 0) + n * (i + o) * 2)
        macs += o * i
    layers = cfg["num_hidden_layers"]
    return layers * nbytes, 2 * n * layers * macs


def prefill_attention(cfg: dict, n: int):
    """(bytes, flops) of a causal prefill's attention over n tokens (no
    cached prefix): q, k and v read and the output written once in bf16;
    4 x heads x head_dim x the keys each query attends (the sliding
    window's cap included), every layer."""
    hd, layers = weights.head_dim(cfg), cfg["num_hidden_layers"]
    heads, kv = cfg["num_attention_heads"], weights.kv_heads(cfg)
    keys = work.attended_sum(n, cfg.get("sliding_window"))
    nbytes = layers * n * (2 * heads + 2 * kv) * hd * 2
    return nbytes, 4 * heads * hd * layers * keys
