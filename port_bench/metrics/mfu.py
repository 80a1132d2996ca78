"""The model FLOPs the window processed (``pbench.work``: every decode
row of every step and every prefill row, attention over the keys actually
attended), over the window's seconds and the card's bf16 peak, in %."""

from pbench import work

LAYER = "model step"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "output_tok_s"


def read(run):
    lp, w = run.loop, run.work
    flops = sum(w.window_steps(s.contexts, s.steps)[1]
                for s in lp.windows if lp.inside(s.t1))
    flops += sum(w.prefill(p)[1] for a in lp.admissions
                 if lp.inside(a.t1) for p in a.prompts)
    return 100.0 * flops / lp.seconds / work.BF16_FLOP_S
