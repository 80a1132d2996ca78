"""The port's serving commands and profile table on the CPU, and which K1
kernel a verify window asks for:

* `serve-bench` on a tiny saved checkpoint, dense, `--paged`,
  `--kv-dtype int8` and `--speculative`, printing the JAX command's keys;
  `--tp 2` with an int8 dense cache refused, as the JAX command refuses it
  (tests/test_torch_tp_serving.py runs `--tp 2`);
* `serve` as a user starts it (`python -m squeezellm_tpu_torch serve`),
  answering a completion with the engine's greedy tokens and /health;
* `benchmark --profile DIR` writing its trace, and
  `utils.profiling.summarize_trace` on a small synthetic trace file
  against a hand-counted table;
* a verify window of at most 16 rows (`Engine`'s prompt-lookup and draft
  windows, a dense slot window at 2 slots) asks K1 for the GEMV, as a
  decode step does; a 40-row window (8 slots x 5) does not.
"""

import http.client
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from squeezellm_tpu import checkpoint as jcheckpoint
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu_torch import checkpoint, cli, engine, serving, synthetic
from squeezellm_tpu_torch.models import fuse, llama
from squeezellm_tpu_torch.ops import quant_linear as tql
from squeezellm_tpu_torch.utils import profiling
from test_torch_model import _jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JSON keys of the JAX package's serve-bench line
SERVE_BENCH_KEYS = {"engine", "requests", "slots", "total_tokens",
                    "elapsed_s", "throughput_tok_s", "ttft_s_p50",
                    "ttft_s_p95", "request_latency_s_p50",
                    "request_latency_s_p95"}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    config = jllama.LlamaConfig(vocab_size=128, hidden_size=128,
                                intermediate_size=256, n_layers=2, n_heads=4,
                                n_kv_heads=2, max_seq=64)
    specs, params = _jax_tree(config, 4, seed=5)
    d = str(tmp_path_factory.mktemp("serve_ckpt"))
    jcheckpoint.save_quantized(d, "llama", config, specs, params)
    return d


def _serve_bench(ckpt, capsys, *flags):
    cli.main(["serve-bench", "--model", ckpt, "--device", "cpu",
              "--requests", "5", "--max-new-tokens", "4", "--slots", "2",
              "--seqlen", "64", "--window", "4", *flags])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags,name", [
    ((), "ContinuousBatchEngine"),
    (("--paged", "--page-size", "16"), "PagedContinuousBatchEngine"),
    (("--kv-dtype", "int8"), "ContinuousBatchEngine"),
    (("--speculative", "3", "2", "--prefill-chunk", "8"),
     "ContinuousBatchEngine"),
    (("--paged", "--page-size", "16", "--speculative", "3", "2"),
     "PagedContinuousBatchEngine")])
def test_serve_bench(ckpt, capsys, flags, name):
    out = _serve_bench(ckpt, capsys, *flags)
    assert set(out) == SERVE_BENCH_KEYS
    assert out["engine"] == name and out["total_tokens"] == 5 * 4
    assert out["throughput_tok_s"] > 0
    assert 0 < out["ttft_s_p50"] <= out["request_latency_s_p95"]


def test_serve_bench_refuses_tensor_parallel(ckpt):
    # the one tensor-parallel configuration the JAX ladder refuses: an
    # int8 cache on the dense engine (before any rank is started)
    with pytest.raises(SystemExit, match="tensor-parallel"):
        cli.main(["serve-bench", "--model", ckpt, "--device", "cpu",
                  "--tp", "2", "--kv-dtype", "int8"])


def test_serve_command_answers(ckpt):
    """The serve command as a user starts it: it prints where it listens,
    answers a completion with the dense engine's greedy tokens, and
    /health."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "squeezellm_tpu_torch", "serve", "--model",
         ckpt, "--device", "cpu", "--port", "0", "--slots", "2",
         "--seqlen", "64", "--window", "4"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        port = int(line["listening"].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt_tokens": [5, 6, 7],
                                 "max_tokens": 6}))
        got = json.loads(conn.getresponse().read())
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    _, model = checkpoint.load_quantized(ckpt, "cpu")
    (want,) = serving.ContinuousBatchEngine(model, slots=2, max_seq=64).run(
        [[5, 6, 7]], max_new_tokens=6).values()
    assert got["tokens"] == [int(t) for t in want]
    assert health == {"status": "ok", "free_slots": 2, "served": 1}


def test_benchmark_profile_writes_a_trace(ckpt, tmp_path, capsys):
    d = str(tmp_path / "prof")
    cli.main(["benchmark", "--model", ckpt, "--device", "cpu", "--tokens",
              "6", "--seqlen", "16", "--profile", d])
    out = capsys.readouterr().out
    assert os.path.exists(os.path.join(d, "trace.json"))
    # no kernel runs on the CPU: the table says so
    assert f"(no device kernel events found under {d})" in out
    assert json.loads(out[out.index("{"):])["tokens"] == 6


def test_summarize_trace_counts_kernels_by_base_name(tmp_path, capsys):
    def x(name, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7,
                "ts": 0, "dur": dur}

    events = [x("void gemv_kernel<true, 4>(float const*, int)", 10.0),
              x("void gemv_kernel<false, 3>(float const*, int)", 20.0),
              x("gemv_kernel", 30.0),
              x("void decode_attn_kernel<float>(float*)", 5.0),
              x("void decode_attn_kernel<__nv_bfloat16>(float*)", 5.0),
              x("aten::mm", 100.0, cat="cpu_op"),
              x("Memcpy HtoD (Pageable -> Device)", 50.0, cat="gpu_memcpy"),
              {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
              {"ph": "M", "name": "process_name", "pid": 1,
               "args": {"name": "GPU 0"}}]
    old = tmp_path / "sub" / "old.json"
    old.parent.mkdir()
    old.write_text(json.dumps({"traceEvents": [x("stale_kernel", 1.0)]}))
    os.utime(old, (1, 1))  # the newest trace is read
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    rows = profiling.summarize_trace(str(tmp_path))
    assert [(n, round(ms, 6), c) for n, ms, c in rows] == [
        ("gemv_kernel", 0.06, 3), ("decode_attn_kernel", 0.01, 2)]
    assert profiling.summarize_trace(str(tmp_path), top=1) == rows[:1]
    profiling.print_trace_summary(str(tmp_path))
    lines = capsys.readouterr().out.splitlines()
    assert lines[2].split() == ["gemv_kernel", "0.060", "3", "85.7"]
    assert lines[3].split() == ["decode_attn_kernel", "0.010", "2", "14.3"]
    assert lines[-1].split()[-1] == "0.070"
    assert profiling.summarize_trace(str(tmp_path / "none")) == []


def test_verify_windows_ask_k1_for_the_decode_steps_kernel(monkeypatch):
    """bf16 mode: `Engine`'s prompt-lookup and draft-model windows (5 rows)
    and a dense slot window at 2 slots (10 rows) ask K1 for the GEMV, as
    the decode step does (the JAX package runs every call of up to 16 rows
    through one kernel); a window at 8 slots (40 rows) and a prompt (its 8
    rows, then its last row's lm_head) keep the tensor-core kernel."""
    calls = []
    inner = tql.lut_matmul

    def spy(x, *args, variant=None, **kw):
        calls.append((x.shape[0], variant))
        return inner(x, *args, variant=variant, **kw)

    monkeypatch.setattr(tql, "lut_matmul", spy)
    cfg = llama.LlamaConfig(vocab_size=64, hidden_size=64,
                            intermediate_size=96, n_layers=1, n_heads=2,
                            n_kv_heads=1, max_seq=64)
    model = fuse.fuse_for_decode(synthetic.quantized_llama(
        cfg, 4, sparsity=0.02, topx=2, device="cpu"))
    kw = dict(dtype=torch.bfloat16, cache_dtype=torch.bfloat16, mode="bf16")
    prompt = np.array([[3, 4, 5, 6, 3, 4, 5, 6]])

    def run(fn):
        calls.clear()
        with torch.no_grad():
            fn()
        return set(calls)

    eng = engine.Engine(model, **kw)
    for host_loop in (False, True):
        assert run(lambda: eng.generate_speculative(
            prompt, 6, draft_len=4, host_loop=host_loop)) == {
                (8, None), (1, None), (5, "gemv")}
        draft = engine.Engine(engine.truncate_for_draft(model, 1), **kw)
        assert run(lambda: eng.generate_draft_speculative(
            prompt, 6, draft, draft_len=4, host_loop=host_loop)) == {
                (8, None), (1, None), (5, "gemv"), (1, "gemv")}

    def window(slots):
        e = serving.ContinuousBatchEngine(model, slots=slots, max_seq=32,
                                          speculative=(4, 2), **kw)
        e.add_requests([[1, 2, 3]] * slots, 8)
        return run(e.step_spec_window)

    assert window(2) == {(10, "gemv")}
    assert window(8) == {(40, None)}
    e = serving.ContinuousBatchEngine(model, slots=8, max_seq=32, **kw)
    e.add_requests([[1, 2, 3]] * 8, 8)
    assert run(e.step) == {(8, "gemv")}

    # window_gemv=False keeps every window on the mode's kernel, and
    # leaves the decode steps (the draft's) on the GEMV
    eng = engine.Engine(model, **kw, window_gemv=False)
    assert run(lambda: eng.generate_speculative(prompt, 6, draft_len=4)) \
        == {(8, None), (1, None), (5, None)}
    assert run(lambda: eng.generate_draft_speculative(
        prompt, 6, draft, draft_len=4, host_loop=True)) == {
            (8, None), (1, None), (5, None), (1, "gemv")}
    for cls, extra in ((serving.ContinuousBatchEngine, {}),
                       (serving.PagedContinuousBatchEngine,
                        dict(n_pages=8, page_size=16))):
        e = cls(model, slots=2, max_seq=32, speculative=(4, 2),
                window_gemv=False, **extra, **kw)
        e.add_requests([[1, 2, 3]] * 2, 8)
        assert run(e.step_spec_window) == {(10, None)}
