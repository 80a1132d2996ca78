"""Faults planted under a run's timed path, for the check's own tests:
each breaks what the program serves, and ``correct`` must come out
false. Each is given the engine before its warm-up, so that the step
programs are made, and on a card captured, with the fault inside: they
wrap the engine's decode step programs, or the model's decode step that
they call. A fault between chips has no place in a one-chip cell."""

from __future__ import annotations

import torch


def _wrap(eng, after):
    model = eng.model
    orig = model.decode_step

    def step(token, pos, cache, **kw):
        return after(orig, token, pos, cache, kw)

    model.decode_step = step


def state_unchanged(eng):
    """The decode step returns its state as it found it: the KV pool, the
    positions and the current tokens (its tokens still come out)."""
    b, make = eng._bufs, eng._program

    def program(name):
        step = make(name)

        def unchanged():
            kv = [c[k] for c in b.caches for k in ("pk", "pv")]
            saved = [t.clone() for t in kv]
            pos, cur = b.pos.clone(), b.cur.clone()
            step()
            for t, s in zip(kv, saved):
                t.copy_(s)
            b.pos.copy_(pos)
            b.cur.copy_(cur)
        return unchanged

    eng._program = program


def half_batch(eng):
    """Half of the slots left out: their logits are the mean of the
    others'."""
    def after(orig, token, pos, cache, kw):
        lg = orig(token, pos, cache, **kw)
        h = (lg.shape[0] + 1) // 2
        lg[h:] = lg[:h].mean(0, keepdim=True)
        return lg
    _wrap(eng, after)


def token_altered(eng):
    """Every slot's token altered where it is produced: the id after the
    best one wins."""
    def after(orig, token, pos, cache, kw):
        lg = orig(token, pos, cache, **kw)
        other = (lg[:, -1].argmax(-1) + 1) % lg.shape[-1]
        rows = torch.arange(lg.shape[0], device=lg.device)
        lg[rows, -1, other] = lg.max() + 1
        return lg
    _wrap(eng, after)
