"""The port's paged serving slice against the JAX package on tiny quantized
LLaMA and OPT models with carried weights (f32 activations, CPU):

* `prefill(start=, all_logits=)` on a dense cache (f32 and int8) and
  `verify_window` over a page pool: logits within 1e-4 of max |logit|,
  cache rows as the JAX package writes them;
* `PagedContinuousBatchEngine`: greedy tokens per request identical to the
  JAX engine's for `step`, `step_window`, `speculative=(3, 2)` and
  `prefill_chunk`, f32 and int8 pools, with a prefix-sharing hit, a cancel,
  page recycling and a `max_seq` that is not a page multiple;
* the pool's bookkeeping, and the three faults the JAX engine's cohort
  admission has (validation after ids are reserved, pages leaked by a
  half-allocated group, a compile per cohort shape), which the port must
  not have.
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
from squeezellm_tpu_torch.ops import paged_attn
from squeezellm_tpu_torch.sampling import SamplingParams
from test_torch_model import _jax_tree, _module_meta
from test_torch_opt import _opt_tree

TOL = 1e-4  # logits, relative to max |logit|
PS = 8
MAX_SEQ = 60  # not a multiple of the page size
MAX_NEW = 6
CONFIGS = {
    "llama": jllama.LlamaConfig(vocab_size=256, hidden_size=128,
                                intermediate_size=256, n_layers=2, n_heads=4,
                                n_kv_heads=2, max_seq=64),
    "opt": jopt.OPTConfig(vocab_size=256, hidden_size=128, ffn_dim=256,
                          n_layers=2, n_heads=4, max_seq=64),
}
JMODS = {"llama": jllama, "opt": jopt}

BASE = list(range(40, 58))  # 18 tokens: two full pages and two more
PHRASE = [9, 8, 7, 6, 5]
# a one-token prompt, a prefix pair (the second hits the first's pages), a
# repeated phrase (prompt lookup finds it), same-length prompts (a cohort)
PROMPTS = [[1, 2, 3], BASE + [5], [11, 13, 17, 19], [23], BASE + [5, 6],
           PHRASE * 4, [3, 1, 4, 1], [2, 7, 1, 8]]
# the cancel scenario's prompts share no page with PROMPTS
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
    return jserving.PagedContinuousBatchEngine(
        fam["type"], fam["config"], fam["specs"], fam["jparams"], slots=3,
        n_pages=40, page_size=PS, backend="xla", max_seq=MAX_SEQ,
        cache_dtype="int8" if cache == "int8" else jnp.float32, **kw)


def _port_engine(fam, cache, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("n_pages", 40)
    return serving.PagedContinuousBatchEngine(
        fam["port_model"](), page_size=PS, max_seq=MAX_SEQ,
        cache_dtype="int8" if cache == "int8" else torch.float32, **kw)


def _cancel_scenario(eng):
    """Admit two requests, step twice, cancel the first, admit a third into
    the freed slot and pages, run to the end."""
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
    """The JAX engine's tokens, computed once per (family, pool, scenario).
    The non-speculative engine serves the plain run and then the cancel
    scenario (whose prompts share nothing with the first run's)."""
    runs = fam["jax_runs"]
    if (cache, scenario) not in runs:
        if scenario in ("run", "cancel"):
            eng = _jax_engine(fam, cache)
            res = eng.run(PROMPTS, max_new_tokens=MAX_NEW)
            runs[cache, "run"] = {r: [int(t) for t in v]
                                  for r, v in res.items()}
            runs[cache, "cancel"] = _cancel_scenario(eng)
        else:
            kw = (dict(speculative=(3, 2)) if scenario == "spec"
                  else dict(prefill_chunk=8))
            res = _jax_engine(fam, cache, **kw).run(PROMPTS,
                                                    max_new_tokens=MAX_NEW)
            runs[cache, scenario] = {r: [int(t) for t in v]
                                     for r, v in res.items()}
    return runs[cache, scenario]


@pytest.mark.parametrize("how,cache", [
    ("step", "f32"), ("step", "int8"), ("window", "f32"), ("window", "int8"),
    ("spec", "f32"), ("spec", "int8"), ("chunk", "f32")])
def test_engine_tokens_equal_jax(family, how, cache):
    scenario = {"step": "run", "window": "run"}.get(how, how)
    want = _jax_tokens(family, cache, scenario)
    kw = {"spec": dict(speculative=(3, 2)),
          "chunk": dict(prefill_chunk=8)}.get(how, {})
    eng = _port_engine(family, cache, **kw)
    decode = [paged_attn.paged_decode_attention,
              paged_attn.paged_decode_attention_q8,
              paged_attn.paged_verify_attention,
              paged_attn.paged_verify_attention_q8]
    before = [f.launches for f in decode]
    got = eng.run(PROMPTS, max_new_tokens=MAX_NEW,
                  window=4 if how == "window" else 1)
    assert [f.launches for f in decode] == before  # CPU: plain versions
    assert sorted(got) == list(range(len(PROMPTS)))
    for rid in want:
        assert got[rid] == want[rid], f"request {rid}"
    # every page is free or cached by the prefix registry; none referenced
    assert eng.pool.pages_in_use() == 0
    cached = set(eng.pool._registry.values())
    assert sorted(set(eng.pool._free) | cached) == list(range(40))
    assert not set(eng.pool._free) & cached
    assert (eng._pos == -1).all() and not eng._pt.any()
    if how == "spec":
        st = eng.stats
        assert st["spec_windows"] > 0 and st["decode_steps"] == 0
        assert 0 < st["accepted"] < st["drafted"]


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_cancel_and_recycling_equal_jax(family, cache):
    want = _jax_tokens(family, cache, "cancel")
    eng = _port_engine(family, cache)
    assert _cancel_scenario(eng) == want
    assert eng.pool.pages_in_use() == 0


def test_prefix_sharing_reuses_pages(family):
    """The second prompt with the same two full pages reuses them (two
    references each) and prefills its suffix only; tokens equal those of
    an engine that shares nothing."""
    eng = _port_engine(family, "f32")
    a, b = BASE + [99], BASE + [101, 102]
    rid_a = eng.add_request(a, 4)
    assert eng._slot_shared[0] == 0
    pages_a = list(eng._slot_pages[0])
    rid_b = eng.add_request(b, 4)
    assert eng._slot_shared[1] == 2
    assert eng._slot_pages[1][:2] == pages_a[:2]
    assert eng._slot_pages[1][2] != pages_a[2]  # the last page is its own
    assert all(eng.pool._ref[p] == 2 for p in pages_a[:2])
    assert eng.pool.pages_in_use() == 3 + 3 - 2
    results = {}
    while any(s.active for s in eng._slots):
        for rid, r in eng.step().items():
            if r["done"]:
                results[rid] = r["tokens"]
    for rid, prompt in ((rid_a, a), (rid_b, b)):
        alone = _port_engine(family, "f32", slots=1).run([prompt], 4)
        assert results[rid] == alone[0]


def test_pool_exhaustion_rolls_back(family):
    """A request the pool cannot hold leaves no page referenced, shared
    pages included."""
    eng = _port_engine(family, "f32", n_pages=5)
    eng.add_request(BASE + [1], 3)  # 3 pages, 2 registered
    free_before = sorted(eng.pool._free)
    refs_before = dict(eng.pool._ref)
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.add_request(BASE + [2], 3 * PS)  # shares 2, needs 4 more
    assert sorted(eng.pool._free) == free_before
    assert eng.pool._ref == refs_before
    assert eng.free_slots() == 2


def test_cohort_pool_exhaustion_leaks_nothing(family):
    """The JAX engine's cohort admission leaks the pages of a half-allocated
    request when the pool runs out (ADVICE.md, `serving.py:1429`); the port
    allocates page by page into a list the rollback sees."""
    eng = _port_engine(family, "f32", n_pages=5)
    cohort = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]  # 2 x 3 pages
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.add_requests(cohort, 12)
    assert sorted(eng.pool._free) == list(range(5))
    assert eng.pool._ref == {} and eng.free_slots() == 3
    # the engine still serves what fits
    assert sorted(eng.run(cohort, max_new_tokens=2)) == [1 + 1, 1 + 2]


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
        assert eng.pool._ref == {} and len(eng.pool._free) == 40
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_requests([good], 0)
    spec = _port_engine(family, "f32", speculative=(3, 2))
    with pytest.raises(ValueError, match="speculative window reserve"):
        spec.add_requests([good, [4] * 51], MAX_NEW)  # 51 + 6 + 4 > 60
    assert spec._next_id == 0 and spec.free_slots() == 3
    assert eng.add_requests([good, [4] * 51], MAX_NEW) == [0, 1]


def test_cohorts_of_any_size_share_one_code_path(family):
    """The JAX engine compiles afresh for every cohort shape (ADVICE.md,
    `serving.py:1450`), which has no counterpart in eager PyTorch: cohorts
    of 2 and of 3 same-length prompts go through the same batched prefill,
    one call each, and give the tokens of single admissions."""
    calls = []
    eng = _port_engine(family, "f32")
    prefill = eng.model.prefill
    eng.model.prefill = lambda tokens, *a, **k: (
        calls.append(tuple(tokens.shape)), prefill(tokens, *a, **k))[1]
    p = [[3, 1, 4, 1], [2, 7, 1, 8], [5, 9, 2, 6]]
    got2 = eng.run(p[:2], max_new_tokens=3)
    got3 = eng.run(p, max_new_tokens=3)
    assert calls == [(2, 4), (3, 4)]
    for i in range(2):
        assert got2[i] == got3[2 + i]
    single = _port_engine(family, "f32", slots=1).run(p, max_new_tokens=3)
    assert [got3[2 + i] for i in range(3)] == [single[i] for i in range(3)]


def test_sampled_run_depends_on_seed_and_request_only(family):
    """A sampled run repeats, does not depend on the window slicing or on
    the order and slots of admission, and differs from greedy."""
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95)
    prompts = PROMPTS[:5]

    def run(seed=7, window=1, slots=3, order=None):
        eng = _port_engine(family, "f32", seed=seed, slots=slots)
        order = order or list(range(len(prompts)))
        out = {}
        # the request id is given explicitly, so an admission order maps
        # to the same streams
        pending = list(order)
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
    mixed = _port_engine(family, "f32", seed=7)
    mixed.add_request(prompts[0], MAX_NEW, sampling=sp, _rid=0)
    mixed.add_request(prompts[1], MAX_NEW, _rid=1)  # greedy beside sampled
    out = {}
    while any(s.active for s in mixed._slots):
        for rid, r in mixed.step().items():
            if r["done"]:
                out[rid] = r["tokens"]
    assert out[0] == ref[0] and out[1] == greedy[1]


def test_inactive_slot_does_not_write_page_zero(family):
    """Inside a decode window an inactive slot keeps pos = -1 and writes
    nothing through its zeroed page table into page 0, which the active
    slot owns."""
    eng = _port_engine(family, "f32", slots=2, n_pages=8)
    prompt = list(range(3, 3 + PS + 2))
    rid = eng.add_request(prompt, 8)
    assert eng._slot_pages[0][0] == 0  # the first page handed out
    results = {}
    while any(s.active for s in eng._slots):
        for r, res in eng.step_window(8).items():
            if res["done"]:
                results[r] = res["tokens"]
    alone = _port_engine(family, "f32", slots=1).run([prompt], 8)
    assert results[rid] == alone[0]


def test_engine_refuses_a_window_the_kernels_cannot_take(family):
    with pytest.raises(ValueError, match="verify kernels' window"):
        _port_engine(family, "f32", speculative=(8, 2))
    eng = _port_engine(family, "f32")
    with pytest.raises(RuntimeError, match="speculative"):
        eng.step_spec_window()


# ---------------------------------------------------------------------------
# The model's new entry points
# ---------------------------------------------------------------------------


def _dense_caches(fam, cache, rows=64):
    c = fam["config"]
    dt = "int8" if cache == "int8" else torch.float32
    jdt = "int8" if cache == "int8" else jnp.float32
    return (common.init_kv_cache(1, rows, c.n_layers, c.n_kv_heads,
                                 c.head_dim, dt, "cpu"),
            jcommon.init_kv_cache(1, rows, c.n_layers, c.n_kv_heads,
                                  c.head_dim, jdt))


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("start", [0, 16, 37])
def test_prefill_start_and_all_logits_match_jax(family, start, cache):
    """A continuation prefill of 11 tokens from `start` over a cache that
    holds rows [0, start): every position's logits and the last one's
    within 1e-4 of max |logit|; the cache rows [0, start + 11) as the JAX
    package holds them (int8 codes within one step, where a 1e-7
    difference upstream crosses a rounding boundary)."""
    c = family["config"]
    jmod = JMODS[family["type"]]
    model = family["port_model"]()
    rng = np.random.default_rng(start)
    tokens = rng.integers(0, c.vocab_size, (1, start + 11))
    pc, jc = _dense_caches(family, cache)
    tt = torch.from_numpy(tokens)
    if start:
        model.prefill(tt[:, :start], pc)
        _, jc = jmod.prefill(c, family["specs"], family["jparams"],
                             jnp.asarray(tokens[:, :start]), jc,
                             backend="xla")
    got_all = model.prefill(tt[:, start:], [dict(l) for l in _clone(pc)],
                            start=start, all_logits=True)
    got = model.prefill(tt[:, start:], pc, start=start)
    want_all, jc = jmod.prefill(c, family["specs"], family["jparams"],
                                jnp.asarray(tokens[:, start:]), jc,
                                backend="xla", start=start, all_logits=True)
    want_all = np.asarray(want_all)
    lim = TOL * np.abs(want_all).max()
    assert got_all.shape == (1, 11, c.vocab_size) and got.shape[1] == 1
    assert np.abs(got_all.numpy() - want_all).max() <= lim
    assert np.abs(got.numpy()[0, 0] - want_all[0, -1]).max() <= lim
    n = start + 11
    for lp, lj in zip(pc, jc):
        for name in ("k", "v"):
            a, b = lp[name][0, :n].numpy(), np.asarray(lj[name])[0, :n]
            if cache == "int8":
                assert np.abs(a.astype(np.int32) - b.astype(np.int32)
                              ).max() <= 1
                np.testing.assert_allclose(
                    lp[name + "s"][0, :, :n].numpy(),
                    np.asarray(lj[name + "s"])[0, :c.n_kv_heads, :n],
                    rtol=1e-5)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            assert not lp[name][0, n:].any()  # rows beyond stay untouched


def _clone(cache):
    return [{k: v.clone() for k, v in layer.items()} for layer in cache]


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_verify_window_and_paged_decode_match_jax(family, cache):
    """Two verify windows of 4 tokens per slot (the second attends what
    the first wrote, and crosses a page), then a decode step, over a page
    pool with an inactive slot: logits within 1e-4 of max |logit|."""
    c = family["config"]
    jmod = JMODS[family["type"]]
    model = family["port_model"]()
    rng = np.random.default_rng(2)
    W, P = 4, 12
    pool = common.init_paged_pool(c.n_layers, P, PS, c.n_kv_heads,
                                  c.head_dim,
                                  "int8" if cache == "int8" else torch.float32,
                                  "cpu")
    jpool = jserving.PagedKVPool(c.n_layers, P, c.n_kv_heads, PS, c.head_dim,
                                 "int8" if cache == "int8" else jnp.float32)
    pt = np.array([[5, 2, 9], [0, 0, 0], [7, 1, 4]], np.int32)
    caches = [dict(layer, pt=torch.from_numpy(pt)) for layer in pool]
    jcaches = [dict(layer, pt=jnp.asarray(pt)) for layer in jpool.pools]
    pos = np.array([0, -1, 0])
    for step in range(3):
        width = W if step < 2 else 1
        toks = rng.integers(0, c.vocab_size, (3, width))
        if step < 2:
            got = model.verify_window(torch.from_numpy(toks),
                                      torch.from_numpy(pos), caches)
            want, jcaches = jmod.verify_window(
                c, family["specs"], family["jparams"], jnp.asarray(toks),
                jnp.asarray(pos), jcaches, backend="xla")
        else:
            got = model.decode_step(torch.from_numpy(toks),
                                    torch.from_numpy(pos), caches)
            want, jcaches = jmod.decode_step(
                c, family["specs"], family["jparams"], jnp.asarray(toks),
                jnp.asarray(pos), jcaches, backend="xla")
        want = np.asarray(want)[[0, 2]]
        assert got.shape == (3, width, c.vocab_size)
        assert (np.abs(got.numpy()[[0, 2]] - want).max()
                <= TOL * np.abs(want).max())
        pos = np.where(pos < 0, pos, pos + width)
    # the inactive slot wrote nothing: page 0 is still empty
    assert not pool[0]["pk"][0].any()
    ported = carry.pools_from_jax(
        [{k: np.asarray(v) for k, v in layer.items() if k != "pt"}
         for layer in jcaches], c.n_kv_heads, "cpu")
    for mine, theirs in zip(pool, ported):
        assert set(mine) == set(theirs)
        for name in mine:
            assert mine[name].shape == theirs[name].shape
            if mine[name].dtype == torch.int8:
                assert (mine[name].int() - theirs[name].int()
                        ).abs().max() <= 1
            else:
                torch.testing.assert_close(mine[name], theirs[name],
                                           rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="dense-slot"):
        model.verify_window(torch.zeros(1, 2, dtype=torch.long),
                            torch.zeros(1, dtype=torch.long),
                            _dense_caches(family, cache)[0])
