"""The end-to-end readers take rates and tails over the whole window, and
the trace's reduction attributes device time to the span that launched
it."""

from __future__ import annotations

import types

import pytest

from pbench import loop, mixes, spec, stats, trace


def _run(requests, windows, opened=10.0, closed=20.0):
    lp = loop.Loop(opened=opened, closed=closed, requests=requests,
                   admissions=[], windows=windows, decode_steps=0,
                   traffic={})
    return types.SimpleNamespace(loop=lp, trace=None, work=None,
                                 peak_bytes=0, setup_s=1.0)


def _req(i, due, first, last, landed, done=None):
    return mixes.Request(index=i, prompt_len=10, max_new=landed, due=due,
                         first=first, last=last, landed=landed, done=done)


def test_ttft_over_all_requests_in_the_window():
    # 100 requests whose first tokens land in the window, ttft 1..100 ms,
    # and two outside it (before the opening, after the close)
    reqs = [_req(i, 10.5, 10.5 + (i + 1) / 1e3, 11.0, 2)
            for i in range(100)]
    reqs += [_req(100, 9.0, 9.9, 9.9, 1), _req(101, 19.0, 25.0, 25.0, 1)]
    got = spec.metric_reader("ttft_p95_ms").read(_run(reqs, []))
    assert got == pytest.approx(96.0)  # sorted[int(0.95 * 100)]
    assert stats.pct(list(range(1, 101)), 0.95) == 96


def test_saturated_ttft_reads_as_the_end_to_end_one():
    """``ttft_p95_ms.saturated`` is ``ttft_p95_ms``'s reading, per layer."""
    reqs = [_req(i, 10.5, 10.5 + (i + 1) / 1e3, 11.0, 2)
            for i in range(40)]
    run = _run(reqs, [])
    got = spec.metric_reader("ttft_p95_ms.saturated").read(run)
    assert got == spec.metric_reader("ttft_p95_ms").read(run) \
        == pytest.approx(39.0)  # sorted[int(0.95 * 40)]


def test_tpot_over_requests_finished_in_the_window():
    reqs = [_req(0, 10.0, 11.0, 12.0, 11, done=12.0),   # 100 ms
            _req(1, 10.0, 11.0, 11.5, 11, done=11.5),   # 50 ms
            _req(2, 1.0, 2.0, 3.0, 11, done=3.0)]       # before: out
    got = spec.metric_reader("tpot_p95_ms").read(_run(reqs, []))
    assert got == pytest.approx(100.0)


def test_rate_over_the_window():
    ws = [loop.Span(t - 0.1, t, False, tokens=n)
          for t, n in ((9.5, 1000), (12.0, 300), (15.0, 500), (20.0, 200),
                       (21.0, 999))]
    got = spec.metric_reader("output_tok_s").read(_run([], ws))
    assert got == pytest.approx(1000 / 10.0)


def test_trace_reduction():
    ms = 1_000_000
    ev = {"spans": [("pb.traced", 0, 100 * ms),
                    ("pb.admission", 0, 30 * ms),
                    ("pb.decode_window", 30 * ms, 90 * ms),
                    ("pb.client", 90 * ms, 95 * ms)],
          # launched at 5 ms (admission) but run 35-40 ms; launched in the
          # window at 40 ms, run 45-85 ms; one with no runtime record
          "runtime": {1: 5 * ms, 2: 40 * ms},
          "device": [("void (anonymous namespace)::k<1>(int)", 35 * ms,
                      40 * ms, 1),
                     ("void gemv<2>(float)", 45 * ms, 85 * ms, 2),
                     ("Memset (Device)", 10 * ms, 12 * ms, 9)]}
    r = trace.reduce(ev)
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.047)
    assert r["busy_by_span_s"]["admission"] == pytest.approx(0.007)
    assert r["busy_by_span_s"]["decode_window"] == pytest.approx(0.040)
    assert dict(r["device_ops"])["k"] == pytest.approx(0.005)
    gaps = dict(r["idle_gaps"])
    assert gaps["admission"] == pytest.approx(0.028)
    assert gaps["decode_window"] == pytest.approx(0.015)
    assert gaps["client"] == pytest.approx(0.005)
    assert gaps["loop"] == pytest.approx(0.005)
    assert trace.reduce({"spans": [], "runtime": {}, "device": []}) is None
