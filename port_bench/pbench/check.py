"""What decides ``correct``: the served tokens of a sample of finished
requests against the plain reference.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests the loop finished, the longest among
them and at least as many as the cell has slots, is run through the
reference once, teacher-forced over each prompt and its served tokens:
the ``logits`` of the configuration's family (``pbench.spec.family``).
For each served token the reference's logits say how far its logit
lies below the reference's best one; the widest such gap
(``max_logit_gap``) is held to the cell's limit. Greedy tokens of a
sound program lie within rounding of the best (random weights make near
ties, so a sound token can lie a little below it); a token computed
wrongly, or altered, lies far below. Every sampled request must also have
served its whole output (``short_requests``, limit 0).

The control (``judge(..., control=True)``) puts the reference in the
program's place at the precision below the configuration's: activations
and the KV cache in float8 e4m3 where the configuration states bf16. It
does not decode: at each position of the same prompts and served tokens
it takes the token the lower precision puts first, and those tokens are
judged as served ones are, under the same limit.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from pbench import mixes, spec
from reference.rounding import fp8


def sample(requests: List[mixes.Request], seed: int, served: int,
           count: int):
    """The longest finished request (prompt and output), then others drawn
    from the seed, until the sample holds ``served`` served tokens and
    ``count`` requests (the cell's slots: at full width a sample of 3 of
    16 slots missed a fault in half of them)."""
    done = [r for r in requests if r.tokens is not None]
    if not done:
        return []
    done.sort(key=lambda r: (-(r.prompt_len + len(r.tokens)), r.index))
    picked, rest = [done[0]], done[1:]
    rng = np.random.default_rng([mixes._nonneg(seed), 4])
    order = rng.permutation(len(rest))
    total = len(done[0].tokens)
    for i in order:
        if total >= served and len(picked) >= count:
            break
        picked.append(rest[i])
        total += len(rest[i].tokens)
    return picked


def _sequences(reqs, seed: int, vocab: int):
    seqs, starts = [], []
    for r in reqs:
        prompt = mixes.prompt_tokens(seed, r.index, r.prompt_len, vocab)
        seqs.append(prompt + r.tokens[:-1])
        starts.append(r.prompt_len - 1)
    return seqs, starts


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each position's best reference logit less the given token's."""
    return ref_logits.max(-1).values - ref_logits.gather(
        1, tokens[:, None])[:, 0]


def judge(cfg: dict, reqs, seed: int, vocab: int, device,
          limit: float, control: bool = False) -> dict:
    """The numbers compared, each with its limit, and the verdict. With
    ``control`` the judged tokens are the float8 reference's first
    choices at the served tokens' positions."""
    short = sum(len(r.tokens) != r.max_new for r in reqs)
    out = {"sampled_requests": len(reqs),
           "served_tokens": sum(len(r.tokens) for r in reqs)}
    if not reqs:
        return {**out, "correct": False,
                "checks": {"sampled_requests": {"value": 0, "limit": 1}}}
    seqs, starts = _sequences(reqs, seed, vocab)
    fam = spec.family(cfg)
    got = fam.logits(cfg, seed, seqs, starts, device)
    if control:
        low = fam.logits(cfg, seed, seqs, starts, device, act=fp8)
        judged = [b.argmax(-1) for b in low]
    else:
        judged = [torch.tensor(r.tokens, device=device) for r in reqs]
    worst = max(float(gaps(lg, t).max()) for lg, t in zip(got, judged))
    checks = {"max_logit_gap": {"value": worst, "limit": limit},
              "short_requests": {"value": short, "limit": 0}}
    ok = worst <= limit and short == 0
    return {**out, "correct": ok, "checks": checks}
