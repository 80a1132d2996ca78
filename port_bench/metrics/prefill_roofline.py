"""The least time of the traced admissions' prefills (``pbench.work``),
over the device time of the work launched inside the admission spans,
in %."""

from pbench import work

LAYER = "kernels in admission"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "output_tok_s"


def read(run):
    tr = run.trace
    busy = tr and tr["busy_by_span_s"].get("admission")
    prompts = [p for a in run.loop.admissions if a.traced for p in a.prompts]
    if not busy or not prompts:
        return None
    bound = sum(work.bound_s(*run.work.prefill(p)) for p in prompts)
    return 100.0 * bound / busy
