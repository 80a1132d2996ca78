"""The program's spans in a trace: device time, host time and idle gaps
put down to them on synthetic events counted by hand, ``trace.reduce``'s
keys left as they are, and the admission's counts."""

from __future__ import annotations

import pytest

from pbench import spans, trace, work

MS = 1_000_000

HARNESS = [("pb.traced", 0, 100 * MS), ("pb.admission", 0, 30 * MS),
           ("pb.decode_window", 30 * MS, 90 * MS),
           ("pb.client", 90 * MS, 95 * MS)]
PROGRAM = [("admit.stage", 1, 5), ("prefill", 5, 25),
           ("linear.mma", 6, 10), ("kv", 11, 12), ("attn", 12, 14),
           ("admit.scatter", 25, 27), ("admit.seed", 27, 29),
           ("window.upload", 31, 32), ("window.launch", 32, 40),
           ("window.sync", 40, 88), ("window.collect", 88, 89)]
# (launched at, runs from, to): one in each of stage, linear.mma, attn,
# the prefill's own code, scatter and the window's replays; the last has
# no runtime record and runs after the client's span
OPS = [(2, 3, 4), (7, 8, 12), (13, 14, 16), (20, 20, 22), (26, 26, 28),
       (33, 35, 80), (None, 96, 97)]


def _events(program=True):
    runtime = {i: t * MS for i, (t, _, _) in enumerate(OPS) if t is not None}
    device = [(f"void (anonymous namespace)::k{i}<1>(int)", a * MS, b * MS,
               i) for i, (_, a, b) in enumerate(OPS)]
    ev = {"spans": list(HARNESS), "runtime": runtime, "device": device}
    if program:
        ev["program"] = [(n, a * MS, b * MS) for n, a, b in PROGRAM]
    return ev


def _ms(d):
    return {k: round(v * 1e3, 9) for k, v in dict(d).items()}


def test_device_host_and_idle_time_by_program_span():
    r = spans.reduce(_events())
    assert _ms(r["busy_by_program_span_s"]) == {
        "admission/admit.stage": 1, "admission/linear.mma": 4,
        "admission/attn": 2, "admission/prefill": 2,
        "admission/admit.scatter": 2, "decode_window/window.launch": 45}
    assert _ms(r["idle_gaps"]) == {
        "admission": 2, "admission/admit.stage": 3, "admission/prefill": 8,
        "admission/linear.mma": 2, "admission/attn": 2,
        "admission/admit.scatter": 1, "admission/admit.seed": 1,
        "decode_window": 2, "decode_window/window.upload": 1,
        "decode_window/window.launch": 3, "decode_window/window.sync": 8,
        "decode_window/window.collect": 1, "client": 5, "loop": 4}
    open_, idle = (_ms(r["open_by_program_span_s"]),
                   _ms(r["idle_by_program_span_s"]))
    assert (open_["prefill"], idle["prefill"]) == (20, 12)
    assert (open_["window.sync"], idle["window.sync"]) == (48, 8)
    assert (open_["linear.mma"], idle["linear.mma"]) == (4, 2)
    host = _ms(r["host_by_program_span_s"])
    assert (host["prefill"], host["linear.mma"], host["kv"]) == (13, 4, 1)
    assert sum(host.values()) == sum(b - a for n, a, b in PROGRAM
                                     if n != "prefill") + 13


def test_refined_gaps_sum_to_the_harness_figures():
    r, old = spans.reduce(_events()), trace.reduce(_events(program=False))
    sums = {}
    for label, s in r["idle_gaps"]:
        h = label.split("/")[0]
        sums[h] = sums.get(h, 0.0) + s
    assert sums == pytest.approx(dict(old["idle_gaps"]), abs=1e-12)
    assert dict(old["idle_gaps"]) == pytest.approx(
        {"admission": 0.019, "decode_window": 0.015, "client": 0.005,
         "loop": 0.004})


def test_the_harness_keys_are_left_as_they_are():
    old = trace.reduce(_events(program=False))
    new = spans.reduce(_events())
    assert {k: v for k, v in new.items() if k in old
            and k != "idle_gaps"} == {k: v for k, v in old.items()
                                      if k != "idle_gaps"}
    # no program span: trace.reduce's result, whole
    assert spans.reduce(_events(program=False)) == old
    empty = dict(_events(), program=[])
    assert spans.reduce(empty) == trace.reduce(empty)
    assert spans.reduce({"spans": [], "runtime": {}, "device": [],
                         "program": PROGRAM}) is None


def test_program_spans_that_abut_and_repeat():
    # a span that closes where the next one opens, and the same name twice
    ev = _events()
    ev["program"] = [("prefill", 5 * MS, 25 * MS),
                     ("linear.mma", 6 * MS, 8 * MS),
                     ("linear.mma", 8 * MS, 10 * MS)]
    r = spans.reduce(ev)
    assert _ms(r["open_by_program_span_s"])["linear.mma"] == 4
    assert _ms(r["busy_by_program_span_s"])["admission/linear.mma"] == 4


CFG = {"model_type": "mistral", "vocab_size": 100, "hidden_size": 64,
       "intermediate_size": 128, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2,
       "sliding_window": 8,
       "quant": {"bits": 4, "sparsity": 0.01, "topx": 2}}


def test_prefill_counts_by_hand():
    # q 64x64, k 32x64, v 32x64, o 64x64, gate/up 128x64, down 64x128
    shapes = [(64, 64), (32, 64), (32, 64), (64, 64), (128, 64), (128, 64),
              (64, 128)]
    packed = sum(o * i / 2 + o * 16 * 4 + round(o * i * 0.01) * 8
                 + (o + 1) * 4 + i * 2 * 4 + 2 * 4 for o, i in shapes)
    assert spans.prefill_linears(CFG, 3) == (
        2 * (packed + 3 * 1024 * 2), 2 * 3 * 2 * 36864)
    w = work.Work(CFG)
    assert w.weight_bytes == 2 * (packed + 2 * 64 * 4) + 100 * 64 * 2
    # 10 tokens under a window of 8: 36 + 2 * 8 keys
    assert spans.prefill_attention(CFG, 10) == (
        2 * 10 * (8 + 4) * 16 * 2, 4 * 4 * 16 * 2 * 52)
