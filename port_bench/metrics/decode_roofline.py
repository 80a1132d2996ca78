"""The least time of the traced decode windows' work (``pbench.work``:
each step's bytes over the HBM rate or its FLOPs over the bf16 peak,
whichever is larger), over the device time of the work launched inside
the ``step_window`` spans, in %."""

LAYER = "kernels in decode"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "tpot_p95_ms"


def read(run):
    tr = run.trace
    busy = tr and tr["busy_by_span_s"].get("decode_window")
    spans = [s for s in run.loop.windows if s.traced and s.steps]
    if not busy or not spans:
        return None
    bound = sum(run.work.window_steps(s.contexts, s.steps)[2] for s in spans)
    return 100.0 * bound / busy
