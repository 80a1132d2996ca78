"""The least time of the traced admissions' expert work (the family's
``Work.moe_prefill`` of each prompt), over the device time of K13's
prefill kernel (``moe_mma_kernel``) in the traced sub-window, in %. None
where the configuration has no experts or the kernel did not run."""

from pbench import work

LAYER = "kernels in admission"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "output_tok_s"
KERNEL = "moe_mma_kernel"


def read(run):
    tr, moe = run.trace, getattr(run.work, "moe_prefill", None)
    busy = tr and dict(tr["device_ops"]).get(KERNEL)
    prompts = [p for a in run.loop.admissions if a.traced for p in a.prompts]
    if not busy or moe is None or not prompts:
        return None
    bound = sum(work.bound_s(*moe(p)) for p in prompts)
    return 100.0 * bound / busy
