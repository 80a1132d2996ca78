"""The plain reference against the port's plain path (f32, exact mode) on
tiny configurations: a Mistral-like one (GQA 2:1, a window shorter than
the sequence, rope) and an OPT one (learned positions, LayerNorm,
biases); and the reference loads nothing of the port or of JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import HARNESS, TINY
from pbench import mixes, port
from reference import model as ref


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_matches_port_plain_path(name):
    cfg = TINY[name]
    seqs = [mixes.prompt_tokens(9, i, 120, cfg["vocab_size"])
            for i in range(2)]
    want = torch.stack(ref.logits(cfg, 4, seqs, [0, 0], "cpu"))
    model = port.build_model(cfg, 4, "cpu")
    with torch.no_grad():
        got = model.forward(torch.tensor(seqs), dtype=torch.float32,
                            mode="exact", plain=True)
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < 1e-5


def test_window_and_fp8_change_the_result():
    cfg = TINY["tiny-llama"]
    seq = [mixes.prompt_tokens(9, 0, 120, cfg["vocab_size"])]
    base = ref.logits(cfg, 4, seq, [100], "cpu")[0]
    wide = ref.logits(dict(cfg, sliding_window=4096), 4, seq, [100],
                      "cpu")[0]
    low = ref.logits(cfg, 4, seq, [100], "cpu", act=ref.fp8)[0]
    assert float((base - wide).abs().max()) > 1e-3
    assert float((base - low).abs().max()) > 1e-2


def test_reference_imports_neither_port_nor_jax():
    """Every module under ``reference/``, with the check that runs it."""
    mods = sorted(n[:-3] for n in os.listdir(os.path.join(HARNESS,
                                                          "reference"))
                  if n.endswith(".py") and n != "__init__.py")
    assert "model" in mods
    code = ("import sys; sys.path.insert(0, %r); %s; import pbench.check; "
            "print(sorted({m.split('.')[0] for m in "
            "sys.modules} & {'squeezellm_tpu_torch', 'squeezellm_tpu', "
            "'jax', 'jaxlib', 'flax'}))"
            % (HARNESS, "; ".join("import reference." + m for m in mods)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=dict(os.environ,
                                                         PYTHONPATH=""))
    assert json.loads(out.stdout.strip().replace("'", '"')) == []
