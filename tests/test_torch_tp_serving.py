"""Tensor-parallel serving on the CPU, the counterpart of
tests/test_tp_serving.py: `serving.TPContinuousBatchEngine` and
`TPPagedContinuousBatchEngine` on launched gloo ranks (one launch a tp,
every scenario in it) against the port's single-device engines on the same
tiny LLaMA (2% sidecar, top-X; GQA, one kv head a rank, at tp=2):

* dense: greedy through run() with more requests than slots (staggered
  joins) in windows of 4, joins and a cancel between steps, per-request
  sampling with a stop token, prompt-lookup speculation;
* paged: greedy with a shared prefix page, joins and a cancel,
  speculation, an int8 pool with chunked admission (`prefill_chunk`);
* at tp=4 (4 kv heads, one a rank): dense and paged greedy;
* every rank emits the same tokens, equal to the single-device engine's;
* `python -m squeezellm_tpu_torch serve-bench --tp 2 --device cpu` on a
  tiny saved checkpoint, dense and `--paged --speculative`: one command
  starts the ranks, rank 0 alone prints, naming gloo and eager steps;
* `serve --tp 2` answering two HTTP completions with the single-device
  engine's greedy tokens, then stopped by SIGINT.
"""

import http.client
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from squeezellm_tpu import checkpoint as jcheckpoint
from squeezellm_tpu_torch import checkpoint, serving
from squeezellm_tpu_torch.parallel import multihost
from squeezellm_tpu_torch.sampling import SamplingParams
from test_torch_tp import llama_config, make_tree, port_tree
import torch_tp_workers as workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 240
RNG = np.random.default_rng(4)
SHARED = RNG.integers(0, 256, 16).tolist()  # one full page of 16 rows
PHRASE = RNG.integers(0, 256, 5).tolist()
PROMPTS = [[1, 2, 3], [7, 9], [11, 13, 17, 19], [23], SHARED + [5],
           SHARED + [9, 4]]
SPEC_PROMPTS = [PHRASE * 5, RNG.integers(0, 256, 8).tolist()]
STAGGER = [[3, 5, 7, 9], [2, 4], SHARED + [1], [8, 8, 8]]
SAMPLED = dict(temperature=0.8, top_k=20)
DENSE = dict(slots=2, max_seq=64)
PAGED = dict(slots=2, max_seq=64, n_pages=24, page_size=16,
             cache_dtype=torch.float32)


def scenarios(tp, stop):
    """(name, engine kind, engine kwargs, run kwargs, prompts)."""
    greedy = dict(max_new_tokens=8, window=4)
    out = [("dense greedy", "dense", DENSE, greedy, PROMPTS),
           ("paged greedy", "paged", PAGED, greedy, PROMPTS)]
    if tp == 4:
        return out
    return out + [
        ("dense sampled, stop", "dense", dict(DENSE, seed=11),
         dict(max_new_tokens=6, window=4, sampling=SAMPLED,
              stop_tokens=[stop]), PROMPTS[:3]),
        ("dense speculative", "dense", dict(DENSE, speculative=(3, 2)),
         dict(max_new_tokens=10), SPEC_PROMPTS),
        ("staggered dense", "dense", dict(DENSE, slots=3),
         dict(max_new_tokens=6), STAGGER),
        ("staggered paged", "paged", dict(PAGED, slots=3),
         dict(max_new_tokens=6), STAGGER),
        ("paged speculative", "paged", dict(PAGED, speculative=(3, 2)),
         dict(max_new_tokens=10), SPEC_PROMPTS),
        ("paged int8, chunked", "paged",
         dict(PAGED, cache_dtype="int8", prefill_chunk=8),
         dict(max_new_tokens=8, window=4), PROMPTS),
    ]


def single_device(tree, name, kind, ekw, rkw, prompts):
    """The single-device engine's tokens for a scenario (speculation
    leaves greedy's tokens as they are, so speculative scenarios are held
    to greedy)."""
    cls = (serving.ContinuousBatchEngine if kind == "dense"
           else serving.PagedContinuousBatchEngine)
    ekw = {k: v for k, v in ekw.items() if k != "speculative"}
    rkw = dict(rkw)
    if "sampling" in rkw:
        rkw["sampling"] = SamplingParams(**rkw["sampling"])
    with torch.no_grad():
        eng = cls(workers.port_model(tree), **ekw)
        if name.startswith("staggered"):
            return workers.run_staggered(eng, prompts, rkw["max_new_tokens"])
        res = eng.run(prompts, **rkw)
    return {rid: [int(t) for t in v] for rid, v in res.items()}


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engines_match_single_device(tp, tmp_path):
    config = llama_config(tp)
    tree = port_tree("llama", config, *make_tree("llama", config, 4,
                                                 seed=tp, density=0.02,
                                                 topx=3))
    # the stop token: one the sampled run emits mid-way
    free = single_device(tree, "sampled", "dense", dict(DENSE, seed=11),
                         dict(max_new_tokens=6, window=4, sampling=SAMPLED),
                         PROMPTS[:3])
    stop = free[0][2]
    cases = scenarios(tp, stop)
    ranks = multihost.launch(workers.serve_cases, tp,
                             args=(tree, cases, tp),
                             init_file=str(tmp_path / "rendezvous"),
                             join_timeout_s=JOIN_S)
    for r in range(1, tp):  # every rank emits the same tokens
        assert ranks[r] == ranks[0], f"rank {r}"
    for name, kind, ekw, rkw, prompts in cases:
        want = single_device(tree, name, kind, ekw, rkw, prompts)
        assert ranks[0][name] == want, name
        stats = ranks[0][name + " stats"]
        if "speculative" in ekw:
            assert stats["spec_windows"] > 0, name
    got = ranks[0].get("dense sampled, stop")
    if got is not None:
        assert got[0][-1] == stop and len(got[0]) == 3
        assert got != {r: free[r] for r in got}  # the stop cut one short


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    config = llama_config(2)
    specs, params = make_tree("llama", config, 4, seed=9, density=0.02,
                              topx=3)
    d = str(tmp_path_factory.mktemp("tp_ckpt"))
    jcheckpoint.save_quantized(d, "llama", config, specs, params)
    return d


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


@pytest.mark.parametrize("flags,name", [
    ((), "TPContinuousBatchEngine"),
    (("--paged", "--page-size", "16", "--speculative", "3", "2", "--fuse"),
     "TPPagedContinuousBatchEngine")])
def test_serve_bench_tp_command(ckpt, flags, name):
    res = subprocess.run(
        [sys.executable, "-m", "squeezellm_tpu_torch", "serve-bench",
         "--model", ckpt, "--device", "cpu", "--tp", "2", "--requests", "5",
         "--max-new-tokens", "4", "--slots", "2", "--seqlen", "64",
         "--window", "4", *flags],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=JOIN_S)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1  # rank 0 alone prints
    out = json.loads(lines[0])
    assert out["engine"] == name and out["tp"] == 2
    assert out["backend"] == "gloo" and out["graphs"] is False
    assert out["total_tokens"] == 5 * 4 and out["throughput_tok_s"] > 0


def _complete(port, prompt, max_tokens):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/completions", json.dumps(
        {"prompt_tokens": prompt, "max_tokens": max_tokens}))
    resp = conn.getresponse()
    assert resp.status == 200
    return json.loads(resp.read())["tokens"]


def test_serve_tp_answers_http(ckpt):
    proc = subprocess.Popen(
        [sys.executable, "-m", "squeezellm_tpu_torch", "serve", "--model",
         ckpt, "--device", "cpu", "--tp", "2", "--slots", "2", "--seqlen",
         "64", "--port", "0"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()  # rank 0's first line
        assert line.startswith("{"), proc.stderr.read()[-3000:]
        info = json.loads(line)
        assert info["tp"] == 2 and info["backend"] == "gloo"
        port = int(info["listening"].rsplit(":", 1)[1])
        prompts = [[5, 6, 7, 5, 6], [11, 3]]
        got = [_complete(port, p, 6) for p in prompts]
        _, model = checkpoint.load_quantized(ckpt, "cpu")
        eng = serving.ContinuousBatchEngine(model, slots=2, max_seq=64)
        with torch.no_grad():
            want = [eng.run([p], max_new_tokens=6)[i]
                    for i, p in enumerate(prompts)]
        assert got == [[int(t) for t in w] for w in want]
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
