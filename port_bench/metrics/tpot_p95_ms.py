"""95th percentile, over the requests that finished in the window, of
(last landing - first landing) / (tokens - 1)."""

from pbench import stats

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    lp = run.loop
    return stats.pct([(r.last - r.first) / (r.landed - 1) * 1e3
                      for r in lp.requests
                      if lp.inside(r.done) and r.landed > 1], 0.95)
