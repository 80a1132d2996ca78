"""Tensor parallelism on the card, on a tiny LLaMA (`torch_tp_workers.
card_tokens`): two ranks, the dense and paged TP engines' greedy tokens
through the kernels equal to their plain path's and to each other's,
with K1 launched on every rank.

* `test_tp_ranks_on_the_card`: the machine's backend rule
  (`parallel.multihost.backend_for`): on one card both ranks share it over
  gloo, steps eager, and an engine asked for graphs there is refused;
* `test_tp_graphed_over_nccl`: a card a rank over NCCL, steps captured
  as CUDA graphs with their collectives; needs two cards.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. On the card:
``python -m pytest tests/test_torch_tp_gpu.py -m gpu``."""

import dataclasses

import pytest
import torch

from squeezellm_tpu_torch.models import llama
from squeezellm_tpu_torch.parallel import multihost
import torch_tp_workers as workers

pytestmark = pytest.mark.gpu

CONFIG = dataclasses.asdict(llama.LlamaConfig(
    vocab_size=512, hidden_size=256, intermediate_size=384, n_layers=2,
    n_heads=4, n_kv_heads=2, max_seq=128))
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 1, 2], [3, 4, 5, 6], [8, 8, 1, 2],
           [7] * 12]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from squeezellm_tpu_torch import _build

    _build.build()  # once, before the ranks load it
    return torch.device("cuda")


def _check(ranks):
    for r in ranks[1:]:
        assert {k: v for k, v in r.items() if k != "device"} == {
            k: v for k, v in ranks[0].items() if k != "device"}
    for rank in ranks:
        for kind in ("dense", "paged"):
            (got, k1), (want, k1_plain) = rank[kind, False], rank[kind, True]
            assert got == want, kind
            assert k1 > 0 and k1_plain == 0, kind


def test_tp_ranks_on_the_card(dev, tmp_path):
    backend = multihost.backend_for("cuda", 2)
    ranks = multihost.launch(workers.card_tokens, 2,
                             args=(CONFIG, PROMPTS, backend == "nccl"),
                             device="cuda",
                             init_file=str(tmp_path / "rendezvous"),
                             join_timeout_s=600)
    _check(ranks)
    assert all(r["backend"] == backend for r in ranks)
    if backend == "gloo":
        assert [r["device"] for r in ranks] == ["cuda:0", "cuda:0"]
        assert all(r["refused"] for r in ranks)


def test_tp_graphed_over_nccl(dev, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL refuses two ranks on one device, "
                    "and gloo's collectives cannot be captured")
    ranks = multihost.launch(workers.card_tokens, 2,
                             args=(CONFIG, PROMPTS, True), device="cuda",
                             init_file=str(tmp_path / "rendezvous"),
                             join_timeout_s=600)
    _check(ranks)
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:1"]
    assert all(r["backend"] == "nccl" for r in ranks)
