"""The port's dense-slot serving slice against the JAX package on tiny
quantized LLaMA and OPT models with carried weights (f32 activations, CPU):

* `verify_window` over a dense cache (f32 and int8): logits within 1e-4 of
  max |logit|, the cache rows as `update_kv_window` writes them (int8
  scales with the JAX package's head padding removed), and an inactive
  slot that writes nothing;
* `ContinuousBatchEngine`: greedy tokens per request identical to the JAX
  engine's (`backend="xla"`) for `step`, `step_window(8)`,
  `speculative=(3, 2)` and `prefill_chunk`, each run admitting a
  same-length cohort, f32 and int8 caches (speculation and chunking keep
  greedy's tokens, so all four are held to the JAX engine's greedy run); a
  cancel, then a new admission into the freed slot;
* a sampled run that depends only on the seed and the request id, and a
  cohort validated before any id is reserved.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from squeezellm_tpu import serving as jserving
from squeezellm_tpu.models import common as jcommon
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.models import opt as jopt
from squeezellm_tpu_torch import carry, serving
from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.ops import decode_attn
from squeezellm_tpu_torch.sampling import SamplingParams
from test_torch_model import _jax_tree, _module_meta
from test_torch_opt import _opt_tree

TOL = 1e-4  # logits, relative to max |logit|
MAX_SEQ = 60
MAX_NEW = 6
CONFIGS = {
    "llama": jllama.LlamaConfig(vocab_size=256, hidden_size=128,
                                intermediate_size=256, n_layers=2, n_heads=4,
                                n_kv_heads=2, max_seq=64),
    "opt": jopt.OPTConfig(vocab_size=256, hidden_size=128, ffn_dim=256,
                          n_layers=2, n_heads=4, max_seq=64),
}
JMODS = {"llama": jllama, "opt": jopt}
PHRASE = [9, 8, 7, 6, 5]
# a one-token prompt, a long one (chunked at 8), a repeated phrase (prompt
# lookup finds it), and same-length prompts: the first three of length 4
# are admitted as one cohort
PROMPTS = [[11, 13, 17, 19], [3, 1, 4, 1], [2, 7, 1, 8], [23],
           list(range(40, 59)), PHRASE * 4, [1, 2, 3]]
CANCEL_PROMPTS = [list(range(100, 121)), list(range(130, 139)),
                  list(range(150, 163))]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def family(request):
    """One random quantized tree of a model family: the JAX side's specs
    and params, and a factory of the port's model carried from them."""
    model_type = request.param
    config = CONFIGS[model_type]
    build = _opt_tree if model_type == "opt" else _jax_tree
    specs, params = build(config, 4, seed=21)

    def port_model():
        return carry.from_tree(model_type, dataclasses.asdict(config),
                               _module_meta(specs), params, "cpu")

    return dict(type=model_type, config=config, specs=specs,
                jparams=jax.tree.map(jnp.asarray, params),
                port_model=port_model, jax_runs={})


def _jax_engine(fam, cache, **kw):
    return jserving.ContinuousBatchEngine(
        fam["type"], fam["config"], fam["specs"], fam["jparams"], slots=3,
        backend="xla", max_seq=MAX_SEQ,
        cache_dtype="int8" if cache == "int8" else jnp.float32, **kw)


def _port_engine(fam, cache, **kw):
    kw.setdefault("slots", 3)
    return serving.ContinuousBatchEngine(
        fam["port_model"](), max_seq=MAX_SEQ,
        cache_dtype="int8" if cache == "int8" else torch.float32, **kw)


def _cancel_scenario(eng):
    """Admit two requests, step twice, cancel the first, admit a third into
    the freed slot, run to the end."""
    a = eng.add_request(CANCEL_PROMPTS[0], MAX_NEW)
    b = eng.add_request(CANCEL_PROMPTS[1], MAX_NEW)
    eng.step()
    eng.step()
    assert eng.cancel(a) and not eng.cancel(a)
    c = eng.add_request(CANCEL_PROMPTS[2], MAX_NEW)
    results = {}
    while any(s.active for s in eng._slots):
        for rid, r in eng.step().items():
            if r["done"]:
                results[rid] = [int(t) for t in r["tokens"]]
    assert sorted(results) == [b, c]
    return [results[b], results[c]]


def _jax_tokens(fam, cache, scenario):
    """The JAX engine's greedy tokens, computed once per (family, cache):
    one engine serves the run and then the cancel scenario. Speculation
    and chunked admission leave greedy tokens as they are in both
    packages, so the port's speculative and chunked runs are held to the
    same tokens."""
    runs = fam["jax_runs"]
    if (cache, scenario) not in runs:
        eng = _jax_engine(fam, cache)
        res = eng.run(PROMPTS, max_new_tokens=MAX_NEW, window=1)
        runs[cache, "run"] = {r: [int(t) for t in v] for r, v in res.items()}
        runs[cache, "cancel"] = _cancel_scenario(eng)
    return runs[cache, scenario]


@pytest.mark.parametrize("how,cache", [
    ("step", "f32"), ("step", "int8"), ("window", "f32"), ("window", "int8"),
    ("spec", "f32"), ("spec", "int8"), ("chunk", "f32"), ("chunk", "int8")])
def test_engine_tokens_equal_jax(family, how, cache):
    want = _jax_tokens(family, cache, "run")
    kw = {"spec": dict(speculative=(3, 2)),
          "chunk": dict(prefill_chunk=8)}.get(how, {})
    eng = _port_engine(family, cache, **kw)
    k2 = [decode_attn.decode_attention, decode_attn.decode_attention_q8]
    before = [f.launches for f in k2]
    got = eng.run(PROMPTS, max_new_tokens=MAX_NEW,
                  window=8 if how == "window" else 1)
    assert [f.launches for f in k2] == before  # CPU: plain versions
    assert sorted(got) == list(range(len(PROMPTS)))
    for rid in want:
        assert got[rid] == want[rid], f"request {rid}"
    assert (eng._pos == -1).all() and eng.free_slots() == 3
    st = eng.stats
    # the first cohort (three prompts of length 4) in one prefill, the
    # other four alone; chunked at 8, the prompts of 19 and 20 take three
    assert st["prefills"] == (9 if how == "chunk" else 5)
    if how == "spec":
        assert st["spec_windows"] > 0 and st["decode_steps"] == 0
        assert 0 < st["accepted"] < st["drafted"]
    if how == "window":
        assert st["decode_steps"] >= MAX_NEW


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_cancel_and_new_admission_equal_jax(family, cache):
    want = _jax_tokens(family, cache, "cancel")
    eng = _port_engine(family, cache)
    assert _cancel_scenario(eng) == want
    assert eng.free_slots() == 3


def test_cache_rows_round_as_the_jax_engine(family):
    for cache, rows in (("f32", 64), ("int8", 128)):
        eng = _port_engine(family, cache)
        assert eng.cache[0]["k"].shape[:2] == (3, rows)
        assert ("ks" in eng.cache[0]) == (cache == "int8")


def test_sampled_run_depends_on_seed_and_request_only(family):
    """A sampled run repeats, does not depend on the window slicing or on
    the order and slots of admission, and differs from greedy."""
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95)
    prompts = PROMPTS[:5]

    def run(seed=7, window=1, slots=3, order=None):
        eng = _port_engine(family, "f32", seed=seed, slots=slots)
        pending, out = list(order or range(len(prompts))), {}
        while pending or any(s.active for s in eng._slots):
            while pending and eng.free_slots():
                j = pending.pop(0)
                eng.add_request(prompts[j], MAX_NEW, sampling=sp, _rid=j)
            res = eng.step_window(window) if window > 1 else eng.step()
            for rid, r in res.items():
                if r["done"]:
                    out[rid] = r["tokens"]
        return out

    ref = run()
    assert run() == ref
    assert run(window=4) == ref
    assert run(slots=2, order=[4, 2, 0, 3, 1]) == ref
    assert run(seed=8) != ref
    greedy = _port_engine(family, "f32").run(prompts, max_new_tokens=MAX_NEW)
    assert greedy != ref
    # a sampled run() steps decode windows even with speculation on
    spec = _port_engine(family, "f32", seed=7, speculative=(3, 2))
    assert spec.run(prompts, max_new_tokens=MAX_NEW, sampling=sp) == {
        r: ref[r] for r in range(len(prompts))}
    assert spec.stats["spec_windows"] == 0


def test_cohort_is_validated_before_anything_is_admitted(family):
    """The JAX engine reserves request ids before the prompts are validated,
    so one bad prompt leaves the cohort half admitted (ADVICE.md,
    `serving.py:178`); the port checks every prompt first."""
    eng = _port_engine(family, "f32")
    good = [1, 2, 3]
    for bad, err in (([4] * 58, "exceeds max_seq"), ([], "empty prompt")):
        with pytest.raises(ValueError, match=err):
            eng.add_requests([good, bad, good], MAX_NEW)
        assert eng._next_id == 0 and eng.free_slots() == 3
        assert eng.stats["prefills"] == 0
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_requests([good], 0)
    with pytest.raises(RuntimeError, match="free slots"):
        eng.add_requests([good] * 4, MAX_NEW)
    spec = _port_engine(family, "f32", speculative=(3, 2))
    with pytest.raises(ValueError, match="speculative window reserve"):
        spec.add_requests([good, [4] * 51], MAX_NEW)  # 51 + 6 + 4 > 60
    assert spec._next_id == 0 and spec.free_slots() == 3
    assert eng.add_requests([good, [4] * 51], MAX_NEW) == [0, 1]
    with pytest.raises(RuntimeError, match="speculative"):
        eng.step_spec_window()


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_dense_verify_window_matches_jax(family, cache):
    """Three slots prefilled to different lengths, then two verify windows
    of 4 tokens per slot (the second attends what the first wrote) with
    one slot inactive in the first: logits of the active slots within 1e-4
    of max |logit|; the cache rows as the JAX package holds them; the
    inactive slot's rows untouched."""
    c = family["config"]
    jmod = JMODS[family["type"]]
    model = family["port_model"]()
    rng = np.random.default_rng(3)
    S, W = 64, 4
    dt = "int8" if cache == "int8" else torch.float32
    jdt = "int8" if cache == "int8" else jnp.float32
    pc = common.init_kv_cache(3, S, c.n_layers, c.n_kv_heads, c.head_dim,
                              dt, "cpu")
    jc = jcommon.init_kv_cache(3, S, c.n_layers, c.n_kv_heads, c.head_dim,
                               jdt)
    # the same rows in both caches: the JAX prefill's of 17 tokens a slot;
    # the slots then stand at three positions, the rows beyond each stale
    # (as a slot's earlier request leaves them)
    toks = rng.integers(0, c.vocab_size, (3, 17))
    _, jc = jmod.prefill(c, family["specs"], family["jparams"],
                         jnp.asarray(toks), jc, backend="xla")
    for lp, lj in zip(pc, jc):
        for name in lp:
            arr = np.asarray(lj[name])
            if name in ("ks", "vs"):
                arr = arr[:, :c.n_kv_heads]
            lp[name].copy_(torch.from_numpy(arr.copy()))
    idle_before = {n: t[1].clone() for n, t in pc[0].items()}
    pos = np.array([9, 17, 5])
    for win in range(2):
        toks = rng.integers(0, c.vocab_size, (3, W))
        ppos = pos.copy()
        if win == 0:
            ppos[1] = -1  # inactive: writes nothing
        got = model.verify_window(torch.from_numpy(toks),
                                  torch.from_numpy(ppos), pc)
        want, jc_new = jmod.verify_window(
            c, family["specs"], family["jparams"], jnp.asarray(toks),
            jnp.asarray(pos), jc, backend="xla")
        want = np.asarray(want)
        live = [0, 2] if win == 0 else [0, 1, 2]
        assert got.shape == (3, W, c.vocab_size)
        assert (np.abs(got.numpy()[live] - want[live]).max()
                <= TOL * np.abs(want).max())
        if win == 0:
            for n, t in pc[0].items():
                assert torch.equal(t[1], idle_before[n])
            # the JAX engine has no inactive slot: bring its slot 1 back
            jc = [{k: v.at[1].set(o[k][1]) for k, v in new.items()}
                  for new, o in zip(jc_new, jc)]
        else:
            jc = jc_new
        pos = pos + W
    for lp, lj in zip(pc, jc):
        for name in lp:
            a = lp[name].numpy()
            b = np.asarray(lj[name])
            if name in ("ks", "vs"):
                np.testing.assert_allclose(a, b[:, :c.n_kv_heads],
                                           rtol=1e-5, atol=0)
            elif cache == "int8":
                assert np.abs(a.astype(np.int32)
                              - b.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_update_kv_window_writes_each_slots_rows():
    """Slot b's window lands at rows [pos[b], pos[b] + s); a slot at -1
    writes nothing; an int8 cache gets the rows' codes and scales."""
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, "int8"):
        cache = common.init_kv_cache(3, 16, 1, 2, 4, dtype, "cpu")[0]
        k = torch.randn(3, 3, 2, 4, generator=g)
        v = torch.randn(3, 3, 2, 4, generator=g)
        common.update_kv_window(cache, k, v, torch.tensor([2, -1, 13]))
        for name, new in (("k", k), ("v", v)):
            if dtype == "int8":
                from squeezellm_tpu_torch.ops import kv_quant

                new_c, sc = kv_quant.quantize_rows(new)
                want = new_c.reshape(3, 3, 8)
                assert torch.equal(cache[name + "s"][0, :, 2:5],
                                   sc[0, ..., 0].t())
                assert not cache[name + "s"][1].any()
            else:
                want = new.reshape(3, 3, 8)
            assert torch.equal(cache[name][0, 2:5], want[0])
            assert torch.equal(cache[name][2, 13:16], want[2])
            assert not cache[name][1].any()
            assert not cache[name][0, :2].any()
            assert not cache[name][0, 5:].any()
    m = common.window_mask(2, 6, torch.tensor([1, 3]), sliding_window=2)
    assert m.shape == (2, 1, 2, 6)
    assert m[0, 0, 0].tolist() == [True, True, False, False, False, False]
    assert m[1, 0, 1].tolist() == [False, False, False, True, True, False]
