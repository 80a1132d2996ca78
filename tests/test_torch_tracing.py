"""The program's spans (``squeezellm_tpu_torch.tracing``): nothing but a
flag check without a profiler; under one, the admission's steps, the
forward's parts and a decode window's phases, nested as the engines run
them, on the CPU with the kernels' plain versions."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from squeezellm_tpu_torch import serving, synthetic, tracing
from squeezellm_tpu_torch.models import fuse, llama, opt

ADMISSION = ["admit.stage", "prefill", "admit.scatter", "admit.seed"]
WINDOW = ["window.upload", "window.launch", "window.sync", "window.collect"]


def _model(family):
    if family == "llama":
        cfg = llama.LlamaConfig(vocab_size=64, hidden_size=64,
                                intermediate_size=96, n_layers=2, n_heads=2,
                                n_kv_heads=1, max_seq=64)
        model = synthetic.quantized_llama(cfg, 4, sparsity=0.02, topx=2,
                                          device="cpu")
    else:
        cfg = opt.OPTConfig(vocab_size=64, hidden_size=64, ffn_dim=96,
                            n_layers=2, n_heads=2, max_seq=64)
        model = synthetic.quantized_opt(cfg, 4, sparsity=0.02, topx=2,
                                        device="cpu")
    return fuse.fuse_for_decode(model)


MODELS = {f: _model(f) for f in ("llama", "opt")}


def _engine(family, kind="paged"):
    kw = dict(slots=2, dtype=torch.bfloat16, mode="bf16", max_seq=48)
    if kind == "paged":
        return serving.PagedContinuousBatchEngine(
            MODELS[family], n_pages=8, page_size=16,
            cache_dtype=torch.bfloat16, **kw)
    return serving.ContinuousBatchEngine(MODELS[family],
                                         cache_dtype=torch.bfloat16, **kw)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 64, n).tolist()


def _spans(prof):
    """(name without the prefix, start, end) of every ``slm.`` event, in
    the order they opened."""
    out = [(e.name()[len(tracing.PREFIX):], e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(tracing.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _top(spans):
    """The spans no other span contains, in order."""
    return [s for s in spans
            if not any(o is not s and o[1] <= s[1] and s[2] <= o[2]
                       for o in spans)]


def _inside(spans, outer):
    return {s[0] for s in spans
            if s is not outer and outer[1] <= s[1] and s[2] <= outer[2]}


def test_span_is_one_null_context_without_a_profiler(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    off = tracing.span("prefill")
    assert off is tracing.span("window.sync")
    with off:
        pass

    def refuse(name):
        raise AssertionError(f"a span recorded {name} with no profiler")

    monkeypatch.setattr(tracing, "_Record", refuse)
    eng = _engine("llama")
    with torch.no_grad():
        eng.add_requests([_prompt(20)], 3)
        eng.step_window(3)


@pytest.mark.parametrize("family", ["llama", "opt"])
@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_admission_and_window_spans_nest(family, kind):
    eng = _engine(family, kind)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.add_requests([_prompt(20)], 4)
        eng.step_window(3)
    spans = _spans(prof)
    top = _top(spans)
    assert [s[0] for s in top] == ADMISSION + WINDOW
    parts = {"linear.mma", "attn", "kv", "norm", "act", "head"}
    if family == "llama":
        parts.add("rope")
    assert _inside(spans, top[1]) == parts
    # the decode step runs eagerly on the CPU: K1's decode route, no K3
    inner = _inside(spans, top[5])
    assert {"linear.dec", "norm", "act", "head"} <= inner
    assert not inner & {"linear.mma", "attn", "kv"}
    assert not _inside(spans, top[6])  # the sync holds nothing


def test_a_cohort_prefills_once_and_scatters_each_row():
    eng = _engine("opt")
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.add_requests([_prompt(20, 1), _prompt(20, 2)], 4)
    assert [s[0] for s in _top(_spans(prof))] == [
        "admit.stage", "prefill", "admit.scatter", "admit.seed",
        "admit.scatter", "admit.seed"]


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_served_tokens_equal_with_the_profiler_on_and_off(family):
    prompts = [_prompt(n, n) for n in (9, 20, 20, 33)]

    def serve():
        with torch.no_grad():
            return _engine(family).run(prompts, max_new_tokens=6, window=4)

    off = serve()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = serve()
    assert on == off and len(on) == len(prompts)
    assert _spans(prof)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_capture_under_a_profiler_on_the_card(dev):
    # the step programs are captured while the profiler runs: the spans
    # inside their bodies are recorded on the host and break nothing, and
    # none of them is mirrored onto the device's timeline
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=384, n_layers=2, n_heads=4,
                            n_kv_heads=2, max_seq=128)
    model = fuse.fuse_for_decode(synthetic.quantized_llama(
        cfg, 4, sparsity=0.01, topx=3, seed=3, device=dev))
    prompts = [_prompt(n, n) for n in (9, 20, 20, 33)]

    def serve():
        eng = serving.PagedContinuousBatchEngine(
            model, slots=2, n_pages=16, page_size=16, dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16, mode="bf16", max_seq=64)
        with torch.no_grad():
            out = eng.run(prompts, max_new_tokens=6, window=4)
        torch.cuda.synchronize()
        assert all(s.graph is not None for s in eng._steps.values())
        return out

    off = serve()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        on = serve()
    assert on == off
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(tracing.PREFIX)]
    assert {"window.launch", "linear.mma", "attn"} <= {
        e.name()[len(tracing.PREFIX):] for e in events}
    assert not [e for e in events if "CUDA" in str(e.device_type())]
