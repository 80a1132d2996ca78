"""``weights.raw_linear``: one linear in the dense families' recipe, from
a generator of its own (seed, tag); and ``weights.head_dim``."""

from __future__ import annotations

import math

import pytest
import torch

from pbench import weights
from test_pb_families import digest

QUANT = {"bits": 4, "sparsity": 0.0045, "topx": 4}
OUT, IN = 96, 160


def _lin(seed=7, tag="e3.up", quant=QUANT, gain=1.0, **kw):
    return weights.raw_linear(seed, tag, OUT, IN, quant, gain, "cpu", **kw)


@pytest.mark.parametrize("bits", [3, 4])
def test_recipe(bits):
    q = dict(QUANT, bits=bits)
    lin = _lin(quant=q)
    k = 2**bits
    codes = lin["codes"]
    assert codes.shape == (OUT, IN) and codes.dtype == torch.uint8
    # each code equally often in a row (in % k == 0), spread where not
    counts = torch.stack([(codes == c).sum(1) for c in range(k)], 1)
    assert int(counts.max() - counts.min()) <= (0 if IN % k == 0 else 1)
    lut = lin["lut"]
    assert lut.shape == (OUT, k) and lut.dtype == torch.float32
    assert bool((lut[:, 1:] >= lut[:, :-1]).all())
    assert float(lut.mean(1).abs().max()) < 1e-6
    # the sidecar: its count, sorted by row then column, no slot twice
    n = weights.sidecar_count(OUT, IN, q["sparsity"])
    slots = lin["sp_rows"] * IN + lin["sp_cols"]
    assert slots.numel() == n == lin["sp_vals"].numel()
    assert bool((slots[1:] > slots[:-1]).all())
    assert int(lin["sp_rows"].max()) < OUT and int(lin["sp_cols"].max()) < IN
    idx = lin["topx_idx"]
    assert idx.numel() == q["topx"] and bool((idx[1:] > idx[:-1]).all())
    assert lin["topx_w"].shape == (IN, q["topx"])
    assert "bias" not in lin


def test_scales_follow_the_gain():
    a, b = _lin(gain=1.0), _lin(gain=0.5)
    ratio = float(b["lut"].std() / a["lut"].std())
    assert ratio == pytest.approx(0.5, rel=1e-5)
    assert float(a["lut"].std()) == pytest.approx(1 / math.sqrt(IN), rel=0.2)
    bias = _lin(bias_std=0.02)["bias"]
    assert bias.shape == (OUT,) and float(bias.std()) == pytest.approx(
        0.02, rel=0.3)


def test_same_seed_and_tag_same_bits():
    assert digest(_lin()) == digest(_lin())
    assert digest(_lin(bias_std=0.02)) == digest(_lin(bias_std=0.02))
    others = {digest(_lin(tag="e3.gate")), digest(_lin(seed=8)),
              digest(_lin(seed=2**40 + 7))}
    assert digest(_lin()) not in others and len(others) == 3


def test_head_dim_reads_the_key():
    cfg = {"hidden_size": 2304, "num_attention_heads": 32}
    assert weights.head_dim(cfg) == 72
    assert weights.head_dim(dict(cfg, head_dim=128)) == 128
    assert weights.head_dim(dict(cfg, head_dim=None)) == 72
