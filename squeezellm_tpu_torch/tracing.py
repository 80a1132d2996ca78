"""Spans of the program on the profiler's clock.

``span(name)`` marks a part of the program (an admission's staging, the
prefill forward, a linear's route, a decode window's sync) as a host
interval named ``slm.<name>`` in a ``torch.profiler`` trace, on the same
clock as the kernels, copies and sets launched inside it: a trace reader
puts each device operation down to the innermost span open when the host
launched it (its runtime call, by correlation id), and each idle gap to
the span open while the device waited.

The profiler that is running is the only switch. With none running,
``span`` returns one shared null context after a flag check (~0.4 us on
a CPU host), so the untraced program pays nothing else. With one running,
it records a function-scope event (``_RecordFunctionFast``), not a
``record_function`` user annotation: the profiler mirrors user annotations
onto the device timeline as ``gpu_user_annotation`` events, which a reader
of device events would take for device work, while a function-scope
event stays on the host.

A CUDA graph replay runs no Python, so no span splits a replayed step:
inside a replay, device time is named by its kernels alone. Spans inside
a step body run when the body runs eagerly, warms up or is captured.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "slm."

_OFF = contextlib.nullcontext()
_enabled = torch._C._autograd._profiler_enabled
_Record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context that records ``slm.<name>`` while a profiler runs, and
    the shared null context otherwise."""
    if not _enabled():
        return _OFF
    return _Record(PREFIX + name)
