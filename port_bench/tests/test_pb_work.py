"""The byte and operation counts against a hand count on a tiny
configuration."""

from __future__ import annotations

import pytest

from pbench import work

CFG = {"model_type": "mistral", "vocab_size": 100, "hidden_size": 64,
       "intermediate_size": 128, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2,
       "sliding_window": 8,
       "quant": {"bits": 4, "sparsity": 0.01, "topx": 2}}


def test_hand_count():
    w = work.Work(CFG)
    # q 64x64, k 32x64, v 32x64, o 64x64, gate/up 128x64, down 64x128
    shapes = [(64, 64), (32, 64), (32, 64), (64, 64), (128, 64), (128, 64),
              (64, 128)]
    assert w.layer_macs == sum(o * i for o, i in shapes) == 36864
    packed = 0
    for o, i in shapes:
        nnz = round(o * i * 0.01)
        packed += (o * i / 2 + o * 16 * 4 + nnz * 8 + (o + 1) * 4
                   + i * 2 * 4 + 2 * 4)
    assert w.weight_bytes == 2 * (packed + 2 * 64 * 4) + 100 * 64 * 2
    assert w.kv_row == 2 * 2 * 16 * 2
    # one decode step, contexts 5 and 12 (the window caps 12 at 8)
    nb, fl = w.decode_step([5, 12])
    keys = 5 + 8
    assert fl == 2 * 2 * (2 * 36864 + 100 * 64) + 4 * 4 * 16 * 2 * keys
    assert nb == (w.weight_bytes + 2 * 64 * 2 + 2 * w.kv_row * (keys + 2)
                  + 2 * 100 * 4)
    # a prompt of 10: keys 1..8, then 8, 8
    nb, fl = w.prefill(10)
    keys = 36 + 16
    assert work.attended_sum(10, 8) == keys
    assert fl == 2 * 10 * 2 * 36864 + 2 * 100 * 64 + 4 * 4 * 16 * 2 * keys
    assert nb == w.weight_bytes + 10 * 128 + 2 * w.kv_row * 10 + 400


def test_window_steps_and_bound():
    w = work.Work(CFG)
    nb, fl, bound = w.window_steps([3, 4], 3)
    parts = [w.decode_step([3 + j, 4 + j]) for j in range(3)]
    assert nb == sum(p[0] for p in parts) and fl == sum(p[1] for p in parts)
    assert bound == pytest.approx(sum(work.bound_s(*p) for p in parts))
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12) == pytest.approx(1.0)
    assert work.attended_sum(5, None) == 15
