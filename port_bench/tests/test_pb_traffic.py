"""Both traffic kinds are deterministic for a seed, and every seed asks
for the same sizes in another order."""

from __future__ import annotations

import collections

import pytest

from pbench import mixes, spec

MIX = {"prompt": {"dist": "lognormal", "median": 256, "sigma": 0.8,
                  "min": 64, "max": 1024},
       "output": {"dist": "uniform", "min": 16, "max": 64}}


def _closed(seed, n):
    t = spec.traffic_kind("closed").make(dict(MIX, clients=4), seed, 0.0)
    out = []
    while len(out) < n:
        for r in t.due(1.0):
            out.append((r.prompt_len, r.max_new))
            t.finished(r, 1.0)
    return out[:n]


def _open(seed, n):
    t = spec.traffic_kind("open").make(
        dict(MIX, rate=50.0, burst={"on_s": 1.0, "off_s": 0.5}), seed, 0.0)
    reqs = t.due(60.0)[:n]
    return [(r.prompt_len, r.max_new, round(r.due, 9)) for r in reqs]


@pytest.mark.parametrize("make", [_closed, _open])
def test_deterministic_for_a_seed(make):
    assert make(2**31 + 11, 64) == make(2**31 + 11, 64)
    assert make(2**31 + 11, 64) != make(5, 64)


@pytest.mark.parametrize("make", [_closed, _open])
def test_same_sizes_in_another_order(make):
    """Seeds 3 and 5 (offsets 3 and 5 in a round of 32): the second's
    sequence is the first's, two places on; a whole round holds the same
    sizes whatever the seed."""
    assert mixes.ROUND == 32
    a, b = make(3, 64), make(5, 64)
    sa, sb = [tuple(x[:2]) for x in a], [tuple(x[:2]) for x in b]
    assert sb[:-2] == sa[2:] and sa != sb
    assert collections.Counter(sa[29:61]) == collections.Counter(sb[27:59])


def test_open_loop_gaps_and_bursts():
    t = spec.traffic_kind("open").make(
        dict(MIX, rate=50.0, burst={"on_s": 1.0, "off_s": 0.5}), 7, 0.0)
    due = [r.due for r in t.due(10.0)]
    assert due == sorted(due)
    # no arrival inside an off period
    assert all((d % 1.5) < 1.0 for d in due)
    # 50 a second while on: ~6.7 on-seconds in 10 s
    assert 250 < len(due) < 420
    assert t.report()["lateness_max_s"] >= 0


def test_prompt_tokens_deterministic_and_distinct():
    a = mixes.prompt_tokens(2**31 + 5, 3, 200, 32000)
    assert a == mixes.prompt_tokens(2**31 + 5, 3, 200, 32000)
    assert a[:128] != mixes.prompt_tokens(2**31 + 5, 4, 200, 32000)[:128]
    assert min(a) >= 0 and max(a) < 32000


def test_quantiles_within_bounds():
    q = [mixes.quantile(MIX["prompt"], (i + 0.5) / 32) for i in range(32)]
    assert q == sorted(q) and q[0] == 64 and q[-1] == 1024
