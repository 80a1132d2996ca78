"""Profiler-trace summary: a per-kernel self-time table from a
``torch.profiler`` Chrome trace.

The counterpart of the JAX package's ``utils/profiling.py``, which reads
the TPU runtime's Perfetto trace; the reference prints a torch.profiler
self-time table after its benchmark (``--torch_profile``). This reads the
trace that ``benchmark --profile DIR`` writes (``export_chrome_trace``):
the device kernel events (category ``kernel``), grouped by base name, so
that the workflow stays "read the table" instead of "open a trace
viewer".
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
from typing import List, Tuple


def _find_traces(trace_dir: str) -> List[str]:
    files = glob.glob(os.path.join(trace_dir, "**", "*.json"),
                      recursive=True)
    files += glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                       recursive=True)
    return sorted(files, key=os.path.getmtime)


def base_name(name: str) -> str:
    """A kernel's name without its return type, ``(anonymous
    namespace)::`` (where the port's kernels live), template arguments,
    parameters and trailing numbering: ``void (anonymous
    namespace)::gemv_kernel<true, 4>(float const*, ...)`` ->
    ``gemv_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name.strip())
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return re.sub(r"[.\d]+$", "", name) or name


def summarize_trace(trace_dir: str,
                    top: int = 25) -> List[Tuple[str, float, int]]:
    """Device kernel time by base name in the newest trace under
    trace_dir: [(base name, total ms, launches)], the longest first, at
    most `top` rows; [] when there is no trace or no kernel in it."""
    files = _find_traces(trace_dir)
    if not files:
        return []
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        events = json.load(f).get("traceEvents", [])
    total = collections.Counter()
    counts = collections.Counter()
    for e in events:
        if (e.get("ph") != "X" or e.get("cat") != "kernel"
                or "dur" not in e):
            continue
        base = base_name(e.get("name", ""))
        total[base] += float(e["dur"])
        counts[base] += 1
    return [(n, us / 1e3, counts[n]) for n, us in total.most_common(top)]


def print_trace_summary(trace_dir: str, top: int = 25) -> None:
    rows = summarize_trace(trace_dir, top)
    if not rows:
        print(f"(no device kernel events found under {trace_dir})")
        return
    total = sum(ms for _, ms, _ in rows)
    print(f"{'kernel':40s} {'total ms':>10s} {'count':>8s} {'%':>6s}")
    print("-" * 68)
    for name, ms, cnt in rows:
        print(f"{name[:40]:40s} {ms:10.3f} {cnt:8d} {100 * ms / total:6.1f}")
    print("-" * 68)
    print(f"{'total (listed)':40s} {total:10.3f}")
