"""Wall ms inside ``step_window`` calls in the window, over the growth of
the engine's ``stats["decode_steps"]``."""

LAYER = "step programs"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_counter", "tpot_p95_ms"


def read(run):
    lp = run.loop
    if not lp.decode_steps:
        return None
    busy = sum(w.t1 - w.t0 for w in lp.windows if lp.inside(w.t1))
    return busy * 1e3 / lp.decode_steps
