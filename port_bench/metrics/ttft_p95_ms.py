"""95th percentile, over every request whose first tokens landed in the
window, of that landing less the time its client sent it (or, in an open
loop, the time it was due): the wait for a slot included."""

from pbench import stats

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    lp = run.loop
    return stats.pct([(r.first - r.due) * 1e3 for r in lp.requests
                      if lp.inside(r.first)], 0.95)
