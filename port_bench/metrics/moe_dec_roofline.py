"""The least time of the traced decode windows' expert reads (the
family's ``Work.moe_decode``: E (1 - (1 - k / E)^rows) experts a layer of
packed bytes, the active experts' FLOPs; over the HBM rate or the bf16
peak, whichever is larger, a step of each window's rows), over the device
time of K13's decode kernel (``moe_dec_kernel``) in the traced sub-window,
in %. None where the configuration has no experts or the kernel did not
run."""

from pbench import work

LAYER = "kernels in decode"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "tpot_p95_ms"
KERNEL = "moe_dec_kernel"


def read(run):
    tr, moe = run.trace, getattr(run.work, "moe_decode", None)
    busy = tr and dict(tr["device_ops"]).get(KERNEL)
    spans = [s for s in run.loop.windows if s.traced and s.steps]
    if not busy or moe is None or not spans:
        return None
    bound = sum(s.steps * work.bound_s(*moe(len(s.contexts)))
                for s in spans)
    return 100.0 * bound / busy
