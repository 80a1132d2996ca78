"""CPU tests of the port's benchmark harness (``python -m pytest
port_bench/tests -q``). Tests marked ``gpu`` need a card and skip here;
on the card: ``python -m pytest port_bench/tests -q -m gpu``."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HARNESS)
for p in (REPO, HARNESS):
    if p not in sys.path:
        sys.path.insert(0, p)

SERVE_BF16 = {"activations": "bfloat16", "kv_cache": "bfloat16",
              "mode": "bf16"}
QUANT = {"bits": 4, "sparsity": 0.0045, "topx": 4}
TINY = {
    "tiny-llama": {
        "model_type": "mistral", "vocab_size": 512, "hidden_size": 128,
        "intermediate_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 1024, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "sliding_window": 48,
        "tie_word_embeddings": False, "quant": QUANT, "serve": SERVE_BF16},
    "tiny-opt": {
        "model_type": "opt", "vocab_size": 512, "hidden_size": 128,
        "ffn_dim": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
        "max_position_embeddings": 256, "do_layer_norm_before": True,
        "word_embed_proj_dim": 128, "quant": QUANT, "serve": SERVE_BF16,
        "weights": {"embed_std": 0.1}},
}
TINY_MIX = {"kind": "closed", "clients": 4,
            "prompt": {"dist": "uniform", "min": 8, "max": 80},
            "output": {"dist": "uniform", "min": 6, "max": 20}}
TINY_CELL = {"slots": 3, "pages": 4, "max_seq": 112, "window": 4,
             "check": {"served_tokens": 150}}
# the tiny cells' limits, from their readings on the CPU over 13 seeds:
# served 0-0.054 (LLaMA) and 0.006-0.059 (OPT), the float8 control
# 0.35-0.66 and 0.65-1.17
TINY_LIMIT = {"tiny-llama": 0.15, "tiny-opt": 0.2}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture
def cuda():
    """Skips the test when no CUDA card is present (decided here, never
    while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tree(root, serve=None):
    """A checkout of the harness under ``root`` whose BENCHMARK.json also
    holds the tiny cells (``tiny-llama.chat``, ``tiny-opt.chat``), added
    as files only."""
    shutil.copytree(HARNESS, os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, cfg in TINY.items():
        cfg = dict(cfg, serve=serve or cfg["serve"])
        _dump(os.path.join(root, "port_bench", "configs", name + ".json"),
              cfg)
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"port_bench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": name + ".chat", "config": name,
                                   "traffic": "tinymix", "chips": 1,
                                   "why": "test"})
        cell = dict(TINY_CELL, check=dict(TINY_CELL["check"],
                                          max_logit_gap=TINY_LIMIT[name]))
        _dump(os.path.join(root, "port_bench", "workloads",
                           name + ".chat.json"), cell)
    _dump(os.path.join(root, "port_bench", "traffic", "tinymix.json"),
          TINY_MIX)
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return bench


@pytest.fixture
def tree(tmp_path):
    make_tree(str(tmp_path))
    return str(tmp_path)
