"""Host ms inside the harness's span around each admission call
(``add_requests``), over the requests it admitted, in the window."""

LAYER = "serving loop"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "output_tok_s"


def read(run):
    lp = run.loop
    spans = [a for a in lp.admissions if lp.inside(a.t1)]
    n = sum(len(a.prompts) for a in spans)
    return sum(a.t1 - a.t0 for a in spans) * 1e3 / n if n else None
