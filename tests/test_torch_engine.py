"""The rest of the port's `engine.py` against the JAX package's (backend
"xla", f32, CPU) on tiny LLaMA and OPT trees carried across:

* `generate_speculative` (prompt lookup) in both loops and
  `generate_draft_speculative` (a second model, `truncate_for_draft`, the
  target itself) in both loops: the JAX package's tokens and `spec_stats`
  over the cases of `tests/test_speculative.py` and
  `tests/test_draft_speculative.py`, and the same refusals;
* `prefill` at a device start (K3's offset and the cache write read from a
  tensor) equal to it at an int and within 1e-4 of the JAX package's
  continuation prefill, f32 and int8 caches;
* `generate` with top-k 1 against JAX greedy; sampled tokens as a pure
  function of (seed, row, position), with graphs on and off;
* `benchmark(window=)`'s keys, the step programs' persistent state
  (`graphs.StepGraph` runs eagerly on the CPU over the same buffers) and
  the launch counts a replay adds;
* the `generate` command: the JAX command's tokens, statistics and
  refusals.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from squeezellm_tpu import checkpoint as jcheckpoint
from squeezellm_tpu import cli as jcli
from squeezellm_tpu import engine as jengine
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.models import opt as jopt
from squeezellm_tpu_torch import carry, cli, engine, graphs
from squeezellm_tpu_torch.ops import lut_matmul
from test_torch_model import _jax_tree, _module_meta
from test_torch_opt import _opt_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # logits, f32 on both sides
CONFIGS = {
    "llama": jllama.LlamaConfig(vocab_size=128, hidden_size=64,
                                intermediate_size=128, n_layers=2,
                                n_heads=4, n_kv_heads=2, max_seq=96),
    "opt": jopt.OPTConfig(vocab_size=128, hidden_size=64, ffn_dim=128,
                          n_layers=2, n_heads=4, max_seq=96),
}
REPEATS = [3, 4, 5, 6, 3, 4, 5, 6, 3, 4]


@functools.lru_cache(maxsize=None)
def _tree(kind, seed, n_layers=2, bits=4, vocab=128):
    config = dataclasses.replace(CONFIGS[kind], n_layers=n_layers,
                                 vocab_size=vocab)
    build = _opt_tree if kind == "opt" else _jax_tree
    specs, params = build(config, bits, seed=seed)
    return config, specs, params


@functools.lru_cache(maxsize=None)
def _pair(kind, seed, n_layers=2, bits=4, vocab=128, cache="f32"):
    """(the JAX engine, the port's model) of one random tree."""
    config, specs, params = _tree(kind, seed, n_layers, bits, vocab)
    jeng = jengine.Engine(kind, config, specs,
                          jax.tree.map(jnp.asarray, params), backend="xla",
                          cache_dtype="int8" if cache == "int8"
                          else jnp.float32)
    model = carry.from_tree(kind, dataclasses.asdict(config),
                            _module_meta(specs), params, "cpu")
    return jeng, model


def _spec_case(jeng, eng, prompt, max_new, **kw):
    p = np.asarray(prompt, np.int64)[None]
    want = jeng.generate_speculative(p.astype(np.int32), max_new, **kw)
    got = eng.generate_speculative(p, max_new, **kw)
    np.testing.assert_array_equal(got, want)
    assert eng.spec_stats == jeng.spec_stats
    return got


# ---------------------------------------------------------------------------
# prompt-lookup speculation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt", [REPEATS, [17, 91, 2], [8]])
@pytest.mark.parametrize("draft_len,ngram", [(8, 2), (4, 3), (1, 1)])
@pytest.mark.parametrize("host_loop", [False, True])
def test_speculative_matches_jax(prompt, draft_len, ngram, host_loop):
    """Tokens and spec_stats of each loop equal the JAX package's loop's,
    and the tokens equal the port's greedy generate."""
    jeng, model = _pair("llama", 0)
    eng = engine.Engine(model)
    got = _spec_case(jeng, eng, prompt, 12, draft_len=draft_len,
                     ngram=ngram, host_loop=host_loop)
    np.testing.assert_array_equal(
        got, eng.generate(np.asarray([prompt]), 12))
    assert eng.spec_stats["windows"] >= 1


@pytest.mark.parametrize("kind,prompt,max_new,draft_len", [
    ("llama", [3, 4, 5, 6] * 4, 20, 8),  # repetitive: drafts accepted
    ("opt", [5, 6, 7, 5, 6, 7, 5, 6], 10, 4),
])
def test_speculative_accepts_and_spans_families(kind, prompt, max_new,
                                                draft_len):
    jeng, model = _pair(kind, 1 if kind == "opt" else 0)
    eng = engine.Engine(model)
    for host_loop in (False, True):
        _spec_case(jeng, eng, prompt, max_new, draft_len=draft_len, ngram=2,
                   host_loop=host_loop)
    if kind == "llama":
        st = eng.spec_stats
        assert st["accepted"] > 0 and st["windows"] < max_new


@pytest.mark.parametrize("host_loop", [False, True])
def test_speculative_refuses_what_does_not_fit(host_loop):
    _, model = _pair("llama", 0)
    eng = engine.Engine(model)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate_speculative(np.array([[1, 2, 3]]), 96, draft_len=8,
                                 host_loop=host_loop)
    with pytest.raises(ValueError, match="single-stream"):
        eng.generate_speculative(np.ones((2, 3), np.int64), 4,
                                 host_loop=host_loop)


# ---------------------------------------------------------------------------
# draft-model speculation
# ---------------------------------------------------------------------------


def _draft_case(target, draft, prompt, max_new, draft_len, host_loop):
    (jt, mt), (jd, md) = target, draft
    p = np.asarray(prompt, np.int64)[None]
    eng = engine.Engine(mt)
    dr = eng if md is mt else engine.Engine(md)
    want = jt.generate_draft_speculative(p.astype(np.int32), max_new,
                                         jt if jd is None else jd,
                                         draft_len=draft_len,
                                         host_loop=host_loop)
    got = eng.generate_draft_speculative(p, max_new, dr, draft_len=draft_len,
                                         host_loop=host_loop)
    np.testing.assert_array_equal(got, want)
    assert eng.spec_stats == jt.spec_stats
    return eng


@pytest.mark.parametrize("prompt,draft_len", [
    ([3, 4, 5, 6, 3, 4], 8), ([17, 91, 2], 3), ([8], 1)])
@pytest.mark.parametrize("host_loop", [False, True])
def test_draft_spec_matches_jax(prompt, draft_len, host_loop):
    """A different random draft (1 layer, 3 bits): the JAX package's
    tokens and stats in each loop."""
    _draft_case(_pair("llama", 0), _pair("llama", 7, n_layers=1, bits=3),
                prompt, 12, draft_len, host_loop)


@pytest.mark.parametrize("host_loop", [False, True])
def test_truncate_for_draft_matches_jax(host_loop):
    """The port's early-exit draft against the JAX package's on the same
    tree: the same tokens and stats; every tensor shared with the
    target."""
    config, specs, params = _tree("llama", 0)
    jt, mt = _pair("llama", 0)
    jd = jengine.Engine("llama", *jengine.truncate_for_draft(
        config, specs, jax.tree.map(jnp.asarray, params), 1),
        backend="xla")
    md = engine.truncate_for_draft(mt, 1)
    assert md.config.n_layers == 1 and len(md.layers) == 1
    assert md.layers[0] is mt.layers[0] and md.lm_head is mt.lm_head
    assert md.embed.data_ptr() == mt.embed.data_ptr()
    assert len(mt.layers) == 2 and mt.config.n_layers == 2
    _draft_case((jt, mt), (jd, md), [2, 4, 6, 8, 2, 4, 6], 16, 5,
                host_loop)
    for bad in (0, 3):
        with pytest.raises(ValueError, match="draft layer count"):
            engine.truncate_for_draft(mt, bad)


def test_draft_spec_self_draft_and_loops_agree():
    """The target as its own draft: the JAX package's acceptance, fewer
    windows than tokens; device and host loops agree on the stats."""
    target = _pair("llama", 0)
    eng = _draft_case(target, (None, target[1]), [5, 9, 1], 21, 4, False)
    st = dict(eng.spec_stats)
    assert st["accepted"] > 0 and st["windows"] < 21
    draft = _pair("llama", 3, n_layers=1)
    a = _draft_case(target, draft, [2, 4, 6, 8, 2, 4, 6], 16, 5, False)
    b = _draft_case(target, draft, [2, 4, 6, 8, 2, 4, 6], 16, 5, True)
    assert a.spec_stats == b.spec_stats


def test_draft_spec_guards_and_opt():
    _, mt = _pair("llama", 0)
    eng = engine.Engine(mt)
    p = np.array([[1, 2, 3]])
    other_vocab = engine.Engine(_pair("llama", 1, n_layers=1, vocab=64)[1])
    with pytest.raises(ValueError, match="vocabulary"):
        eng.generate_draft_speculative(p, 8, other_vocab)
    draft = engine.Engine(_pair("llama", 2, n_layers=1)[1])
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate_draft_speculative(p, 96, draft, draft_len=8)
    for host_loop in (False, True):
        _draft_case(_pair("opt", 1), _pair("opt", 9, n_layers=1),
                    [5, 6, 7, 5, 6, 7], 10, 4, host_loop)


# ---------------------------------------------------------------------------
# prefill at a device start: K3's offset and the cache write on the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,cache", [("llama", "f32"), ("llama", "int8"),
                                        ("opt", "f32")])
def test_prefill_at_a_device_start(kind, cache):
    """A continuation prefill whose start is a tensor equals the one at an
    int (logits and every cache tensor) and the JAX package's verify
    window; so does a one-token continuation (the decode route)."""
    jeng, model = _pair(kind, 5, cache=cache)
    cache_dtype = "int8" if cache == "int8" else torch.float32
    eng = engine.Engine(model, cache_dtype=cache_dtype)
    prompt = np.array([[7, 3, 99, 12, 41, 8, 5]])
    for window in ([[17, 2, 63, 11]], [[17]]):
        w = np.asarray(window)
        jc = jeng.new_cache(1)
        _, jc = jeng._prefill(jeng.params, jnp.asarray(prompt, jnp.int32),
                              jc)
        want, _ = jeng._verify(jeng.params, jnp.asarray(w, jnp.int32),
                               jnp.asarray(prompt.shape[1], jnp.int32), jc)
        runs = []
        for start in (7, torch.tensor(7),
                      torch.tensor([7], dtype=torch.int32)):
            c = eng.new_cache(1)
            model.prefill(torch.as_tensor(prompt), c)
            logits = model.prefill(torch.as_tensor(w), c, start=start,
                                   all_logits=True)
            runs.append((logits, c))
        np.testing.assert_allclose(runs[0][0].numpy(), np.asarray(want),
                                   rtol=0, atol=ATOL)
        for logits, c in runs[1:]:
            assert torch.equal(logits, runs[0][0])
            for a, b in zip(c, runs[0][1]):
                assert all(torch.equal(a[n], b[n]) for n in a)


# ---------------------------------------------------------------------------
# generate: greedy, sampled; the persistent state
# ---------------------------------------------------------------------------


def test_generate_top_k_1_is_jax_greedy():
    jeng, model = _pair("llama", 0)
    p = np.array([[3, 17, 42, 8, 99]])
    want = jeng.generate(p.astype(np.int32), 10)
    for graphed in (True, False):
        got = engine.Engine(model, graphs=graphed).generate(
            p, 10, temperature=0.7, top_k=1, seed=4)
        np.testing.assert_array_equal(got, want)


def test_sampled_tokens_are_a_function_of_seed_row_and_position():
    _, model = _pair("llama", 0)
    p = np.array([[3, 17, 42], [5, 6, 7]])
    kw = dict(temperature=0.9, top_k=20, top_p=0.9)
    eng = engine.Engine(model)
    a = eng.generate(p, 12, seed=11, **kw)
    np.testing.assert_array_equal(eng.generate(p, 12, seed=11, **kw), a)
    eager = engine.Engine(model, graphs=False)
    np.testing.assert_array_equal(eager.generate(p, 12, seed=11, **kw), a)
    # row 0 of the batch is the same prompt generated alone: the stream is
    # keyed by row index, not by the batch
    np.testing.assert_array_equal(eng.generate(p[:1], 12, seed=11, **kw),
                                  a[:1])
    assert not np.array_equal(eng.generate(p, 12, seed=12, **kw), a)
    assert not np.array_equal(a, eng.generate(p, 12))
    with pytest.raises(ValueError, match="top_k"):
        eng.generate(p, 2, temperature=0.5, top_k=65)


def test_benchmark_reports_its_windows():
    _, model = _pair("llama", 0)
    stats = engine.Engine(model).benchmark(np.arange(10)[None] * 7 % 128,
                                           max_seq=32, window=4)
    assert {"tokens", "median_latency_s", "mean_latency_s",
            "max_window_latency_s", "tokens_per_s", "device", "graphs",
            "param_bytes", "achieved_gb_s"} <= set(stats)
    assert stats["tokens"] == 10 and stats["device"] == "cpu"
    assert (stats["max_window_latency_s"] >= stats["median_latency_s"] > 0
            and stats["mean_latency_s"] > 0)
    assert "hbm_roofline_util" not in stats  # no card, no peak to read
    assert not stats["graphs"]  # a CPU step runs eagerly


def test_step_programs_keep_one_persistent_state():
    """Two calls of one key share the cache and buffers and give a fresh
    eager engine's tokens; another key replaces them."""
    _, model = _pair("llama", 0)
    eng = engine.Engine(model)
    p = np.array([[9, 8, 7, 6]])
    a = eng.generate(p, 8)
    key, st, steps = eng._state
    ptr = st.cache[0]["k"].data_ptr()
    b = eng.generate(np.array([[1, 2]]), 8)
    assert eng._state[1] is st and st.cache[0]["k"].data_ptr() == ptr
    assert isinstance(steps["step"], graphs.StepGraph)
    assert not steps["step"].capture  # the CPU runs the body eagerly
    fresh = engine.Engine(model, graphs=False)
    np.testing.assert_array_equal(a, fresh.generate(p, 8))
    np.testing.assert_array_equal(b, fresh.generate(np.array([[1, 2]]), 8))
    eng.generate(np.array([[1, 2], [3, 4]]), 4)
    assert eng._state[0] != key
    eng.release()
    assert eng._state is None


def test_step_graph_counts_one_step_a_call():
    """The counters' increase a StepGraph records is one step's, and the
    counts it leaves are those of the steps it ran."""
    fn = lut_matmul.lut_matmul

    def body():
        fn.launches += 2
        fn.variant_launches["gemv"] += 1

    before = graphs.read_counts()
    step = graphs.StepGraph(body, "cpu")
    step()
    step()
    assert step.delta == {(0, "launches"): 2,
                          (0, "variant_launches"): {"gemv": 1}}
    assert graphs.count_increase(before, graphs.read_counts()) == {
        (0, "launches"): 4, (0, "variant_launches"): {"gemv": 2}}
    graphs.add_counts(step.delta, -2)
    assert graphs.count_increase(before, graphs.read_counts()) == {}


# ---------------------------------------------------------------------------
# the generate command
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    config, specs, params = _tree("llama", 0)
    d = str(tmp_path_factory.mktemp("engine_ckpt"))
    jcheckpoint.save_quantized(d, "llama", config, specs, params)
    return d


def _jax_cli(ckpt, args, capsys):
    jcli.main(["generate", ckpt, "--backend", "xla", *args])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_cli(ckpt, args, capsys):
    cli.main(["generate", "--model", ckpt, "--device", "cpu", *args])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


PROMPT_ARGS = ["--prompt-tokens", "3,4,5,6,3,4,5,6", "--max-new-tokens",
               "10"]


def test_cli_generate_matches_the_jax_command(ckpt, capsys):
    assert (_port_cli(ckpt, PROMPT_ARGS, capsys)
            == _jax_cli(ckpt, PROMPT_ARGS, capsys))
    draft = [*PROMPT_ARGS, "--draft-layers", "1", "--draft-len", "3"]
    assert _port_cli(ckpt, draft, capsys) == _jax_cli(ckpt, draft, capsys)
    # the module's entry point, as a user runs it
    spec = [*PROMPT_ARGS, "--speculative", "--draft-len", "4", "--ngram",
            "2"]
    res = subprocess.run(
        [sys.executable, "-m", "squeezellm_tpu_torch", "generate",
         "--model", ckpt, "--device", "cpu", *spec], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == _jax_cli(ckpt, spec, capsys)
    assert got["spec_stats"]["windows"] >= 1
    sampled = [*PROMPT_ARGS, "--temperature", "0.8", "--top-k", "5",
               "--top-p", "0.9", "--seed", "3"]
    got = _port_cli(ckpt, sampled, capsys)
    assert got == _port_cli(ckpt, sampled, capsys)
    _, model = _pair("llama", 0)
    want = engine.Engine(model).generate(
        np.array([[3, 4, 5, 6, 3, 4, 5, 6]]), 10, temperature=0.8, top_k=5,
        top_p=0.9, seed=3)
    assert got["tokens"] == want[0].tolist()


@pytest.mark.parametrize("flags", [
    ["--speculative", "--temperature", "0.5"],
    ["--draft-layers", "1", "--temperature", "0.5"],
    ["--draft-layers", "1", "--draft-model", "DIR"],
])
def test_cli_generate_refuses_what_the_jax_command_refuses(ckpt, flags):
    flags = [ckpt if f == "DIR" else f for f in flags]
    with pytest.raises(SystemExit):
        jcli.main(["generate", ckpt, "--backend", "xla", *PROMPT_ARGS,
                   *flags])
    with pytest.raises(SystemExit):
        cli.main(["generate", "--model", ckpt, "--device", "cpu",
                  *PROMPT_ARGS, *flags])
