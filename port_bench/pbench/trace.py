"""The traced sub-window: ``torch.profiler`` over a few steady seconds of
the window, events kept in memory, and their reduction.

The harness wraps each of its calls into the program in a
``record_function`` span (``pb.admission``, ``pb.decode_window``, the
client bookkeeping ``pb.client``) and the traced sub-window in
``pb.traced``. A device operation (kernel, copy, set) belongs to the span
in which the host launched it: its runtime call is found by correlation
id, and where none is found, by the operation's own start.
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, Optional, Tuple

SPANS = ("pb.admission", "pb.decode_window", "pb.client")
TRACED = "pb.traced"


def base_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity,
    template arguments, parameters and trailing numbering (a frozen copy of
    ``squeezellm_tpu_torch.utils.profiling.base_name``, which also drops
    ``(anonymous namespace)::``: the port's kernels live in one, and the
    copy named them all "")."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name.strip())
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return re.sub(r"[.\d]+$", "", name) or name


def _label(span: str) -> str:
    return span[len("pb."):]


START_SHARE = 0.4  # where in the window the profiler starts
SECONDS = 4.0      # how long it traces


class Tracer:
    """Starts the profiler ``START_SHARE`` of the way into a window of
    ``window_s``, at a loop iteration's end, and stops it ``SECONDS``
    later (or when the window closes)."""

    def __init__(self, window_s: float):
        self.start_s, self.seconds = START_SHARE * window_s, SECONDS
        self.prof = None
        self.span = None
        self.t0 = None
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self, torch) -> None:
        """Start and stop the profiler once in set-up, so that its first
        start's cost stays out of the window."""
        with self._profile():
            torch.ones(1).add_(1)

    def tick(self, now: float, opened: float) -> None:
        from torch.profiler import record_function

        if self.done:
            return
        if self.prof is None and now - opened >= self.start_s:
            self.prof = self._profile()
            self.prof.__enter__()
            self.span = record_function(TRACED)
            self.span.__enter__()
            self.t0 = now
        elif self.prof is not None and now - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is not None and not self.done:
            self.span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.done = True

    def events(self):
        return extract(self.prof) if self.prof is not None else None


def _ns(e, which: str) -> int:
    """An event's start or end in ns (``start_ns``/``end_ns``, or from
    the microsecond fields of older profilers)."""
    if hasattr(e, which + "_ns"):
        return int(getattr(e, which + "_ns")())
    start = e.start_us() * 1000
    return int(start if which == "start" else start + e.duration_us() * 1000)


def extract(prof) -> dict:
    """The events the reduction reads, as plain tuples: the harness's
    spans (name, start, end), runtime launches (correlation id -> start)
    and device operations (name, start, end, correlation id), all in ns
    of the profiler's clock. A device event is one on a CUDA device that
    is not an annotation; a launch is a host call of the CUDA API
    (``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cuLaunchKernel``, ...)."""
    spans, runtime, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = "CUDA" in str(e.device_type())
        if name.startswith("pb."):
            if not on_device:
                spans.append((name, _ns(e, "start"), _ns(e, "end")))
        elif on_device:
            device.append((name, _ns(e, "start"), _ns(e, "end"),
                           e.correlation_id()))
        elif name.startswith(("cuda", "cu")) and not name.startswith(
                "cudnn"):
            runtime[e.correlation_id()] = _ns(e, "start")
    return {"spans": spans, "runtime": runtime, "device": device}


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _length(intervals) -> int:
    return sum(b - a for a, b in intervals)


class _Spans:
    """The harness's spans, in order (they do not overlap: the loop makes
    one call at a time), searched by bisection."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [a for _, a, _ in self.spans]

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.spans[i][2]:
            return self.spans[i][0]
        return None

    def split(self, a: int, b: int) -> Dict[str, int]:
        """ns of [a, b) under each span (``loop`` where none is open)."""
        out: Dict[str, int] = collections.Counter()
        covered = 0
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        while i < len(self.spans) and self.spans[i][1] < b:
            name, s0, s1 = self.spans[i]
            lo, hi = max(a, s0), min(b, s1)
            if hi > lo:
                out[_label(name)] += hi - lo
                covered += hi - lo
            i += 1
        if b - a > covered:
            out["loop"] += b - a - covered
        return out


def reduce(ev: dict, top: int = 10) -> Optional[dict]:
    """busy and window seconds, busy seconds by the span that launched the
    work, device operations by base name and idle gaps by the span that
    was open; None when the trace holds no traced window or no device
    operation."""
    traced = [(a, b) for n, a, b in ev["spans"] if n == TRACED]
    if not traced or not ev["device"]:
        return None
    w0, w1 = traced[0]
    spans = _Spans([s for s in ev["spans"] if s[0] in SPANS])
    by_label = collections.defaultdict(list)
    by_name = collections.Counter()
    matched = 0
    clipped = []
    for name, a, b, corr in ev["device"]:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        launch = ev["runtime"].get(corr)
        matched += launch is not None
        span = spans.at(launch if launch is not None else a)
        by_label[_label(span) if span else "loop"].append((a, b))
        by_name[base_name(name)] += b - a
        clipped.append((a, b))
    if not clipped:
        return None
    busy = union(clipped)
    gaps = collections.Counter()
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.update(spans.split(prev, a))
        prev = max(prev, b)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": _length(busy) / 1e9,
        "busy_by_span_s": {k: _length(union(v)) / 1e9
                           for k, v in by_label.items()},
        "device_ops": [[n, ns / 1e9] for n, ns in by_name.most_common(top)],
        "idle_gaps": [[n, ns / 1e9] for n, ns in gaps.most_common(top)],
        "launches_matched": matched / len(clipped),
        "device_events": len(clipped),
    }
