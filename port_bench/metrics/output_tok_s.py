"""Tokens landed at clients in the window (unfinished requests' tokens
too), over the window's seconds."""

UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(run):
    lp = run.loop
    return sum(w.tokens for w in lp.windows if lp.inside(w.t1)) / lp.seconds
