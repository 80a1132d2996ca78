"""The port's int8 KV cache against the JAX package: `quantize_rows` bit
for bit, K5's plain version against the fused Pallas q8 decode kernel in
interpret mode, and a tiny LLaMA and a tiny OPT run by `Engine` with
`cache_dtype="int8"` on both sides (f32 activations)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from squeezellm_tpu import engine as jengine
from squeezellm_tpu.models import common as jcommon
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.models import opt as jopt
from squeezellm_tpu.ops import decode_attn as jda
from squeezellm_tpu.ops import kv_quant as jkv
from squeezellm_tpu_torch import carry, engine
from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.ops import decode_attn, kv_quant
from test_torch_model import _jax_tree, _module_meta
from test_torch_opt import _opt_tree


def _rows(rng):
    """Seeded rows with the corner cases: an all-zero row, a row whose
    quotients land on .5 ties, a row with one huge entry, tiny rows."""
    x = rng.standard_normal((6, 5, 64)).astype(np.float32)
    x[0, 0] = 0.0
    # max 127 -> scale exactly 1 -> x / s = x: ties at k + 0.5
    x[1, 1] = np.concatenate([[127.0, -127.0],
                              np.arange(62, dtype=np.float32) - 30.5])
    x[2, 2, 7] = 3.0e4
    x[3] *= 1e-20
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_identical_to_jax(dtype):
    x = _rows(np.random.default_rng(0))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = kv_quant.quantize_rows(xt)
    qj, sj = jkv.quantize_rows(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (6, 5, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))
    assert not q[0, 0].any() and float(s[0, 0]) == np.float32(1e-12)
    if dtype == "float32":  # the ties went to even
        np.testing.assert_array_equal(
            q[1, 1, 2:].numpy(), np.round(x[1, 1, 2:]).astype(np.int8))
    np.testing.assert_array_equal(
        kv_quant.dequantize_rows(q, s).numpy(),
        np.asarray(jkv.dequantize_rows(qj, sj)))
    assert (kv_quant.QMAX, kv_quant.EPS) == (jkv._QMAX, jkv._EPS)
    assert kv_quant.RQMAX == jkv._RQMAX


def _history(rng, B, S, Hkv, hd):
    """A quantized history: codes (B, S, Hkv*hd) and the port's (B, Hkv, S)
    scales."""
    q, s = kv_quant.quantize_rows(
        torch.from_numpy(rng.standard_normal((B, S, Hkv, hd))
                         .astype(np.float32)))
    return q.reshape(B, S, Hkv * hd), s[..., 0].transpose(1, 2).contiguous()


@pytest.mark.parametrize("g,window,rope", [(1, None, True), (2, None, True),
                                           (2, 24, True), (2, None, False)])
def test_decode_attention_q8_matches_pallas(g, window, rope):
    """Output within 1e-5; codes and scales equal (the JAX sidecar's head
    rows padded to 8 are cut off), except the roped k row, whose f32 rope
    may differ in the last bit between the two frameworks and so move a
    code by one step. A mid, a zero-length and a full slot."""
    rng = np.random.default_rng(g * 10 + (window or 0) + rope)
    B, Hkv, S, hd = 3, 2, 96, 64
    H = g * Hkv
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    ck, sk = _history(rng, B, S, Hkv, hd)
    cv, sv = _history(rng, B, S, Hkv, hd)
    lengths = np.array([40, 0, S], np.int32)
    kw, jkw = {}, {}
    if rope:
        cos, sin = jcommon.rope_cos_sin(
            jnp.asarray(np.maximum(lengths - 1, 0)), hd, 10000.0)
        jkw = dict(rope_cos=cos, rope_sin=sin)
        kw = dict(rope_cos=torch.from_numpy(np.array(cos)),
                  rope_sin=torch.from_numpy(np.array(sin)))

    hkv8 = jda.q8_sidecar_shape(Hkv, S)[0]

    def padded(s):
        out = np.zeros((B, hkv8, S), np.float32)
        out[:, :Hkv] = s.numpy()
        return jnp.asarray(out)

    want, wck, wcv, wsk, wsv = jda.dense_decode_attention_q8(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy()), padded(sk),
        padded(sv), jnp.asarray(lengths), sliding_window=window,
        interpret=True, **jkw)

    before = decode_attn.decode_attention_q8.launches
    got = decode_attn.decode_attention_q8(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        ck, cv, sk, sv, torch.from_numpy(lengths), sliding_window=window,
        **kw)
    assert decode_attn.decode_attention_q8.launches == before  # CPU: plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert not got[1].any()  # the zero-length slot
    np.testing.assert_array_equal(cv.numpy(), np.asarray(wcv))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(wsv)[:, :Hkv])
    wck, wsk = np.asarray(wck), np.asarray(wsk)[:, :Hkv]
    if rope:
        written = np.zeros((B, S), bool)
        written[[0, 2], [39, S - 1]] = True
        np.testing.assert_array_equal(ck.numpy()[~written], wck[~written])
        assert np.abs(ck.numpy().astype(np.int32)
                      - wck.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(sk.numpy(), wsk, rtol=3e-7, atol=0)
    else:
        np.testing.assert_array_equal(ck.numpy(), wck)
        np.testing.assert_array_equal(sk.numpy(), wsk)


def test_int8_cache_layout_and_insert():
    """`init_kv_cache("int8")`: int8 codes and (B, Hkv, S) f32 scales;
    prefill rows and decode rows quantize at insert with `quantize_rows`;
    `read_kv` returns codes times scale, as the JAX package's does."""
    rng = np.random.default_rng(3)
    B, S, Hkv, hd, s = 2, 32, 2, 16, 5
    for dt in ("int8", torch.int8):
        cache = common.init_kv_cache(B, S, 1, Hkv, hd, dt, "cpu")[0]
        assert cache["k"].dtype == torch.int8
        assert cache["k"].shape == (B, S, Hkv * hd)
        assert cache["ks"].shape == cache["vs"].shape == (B, Hkv, S)
    jcache = jcommon.init_kv_cache(B, S, 1, Hkv, hd, "int8")[0]
    k = rng.standard_normal((B, s, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, s, Hkv, hd)).astype(np.float32)
    common.write_kv_rows(cache, torch.from_numpy(k), torch.from_numpy(v))
    for name, new in (("k", k), ("v", v)):  # the JAX prefill's insert
        codes, scale = jkv.quantize_rows(jnp.asarray(new))
        jcache[name] = jcache[name].at[:, :s].set(codes.reshape(B, s, -1))
        jcache[name + "s"] = jcache[name + "s"].at[:, :, :s].set(
            jcommon._q8_scale_rows(scale, jcache[name + "s"].shape[1]))
    k1 = rng.standard_normal((B, 1, Hkv, hd)).astype(np.float32)
    v1 = rng.standard_normal((B, 1, Hkv, hd)).astype(np.float32)
    pos = np.array([5, 9])
    common.update_kv_cache(cache, torch.from_numpy(k1), torch.from_numpy(v1),
                           torch.from_numpy(pos))
    jcache = jcommon.update_kv_cache(jcache, jnp.asarray(k1),
                                     jnp.asarray(v1), jnp.asarray(pos))
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(jcache[name]))
        np.testing.assert_array_equal(
            cache[name + "s"].numpy(), np.asarray(jcache[name + "s"])[:, :Hkv])
    for got, want in zip(common.read_kv(cache, torch.float32, Hkv),
                         jcommon.read_kv(jcache, jnp.float32, Hkv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # an int position writes the same row of every slot
    common.update_kv_cache(cache, torch.from_numpy(k1), torch.from_numpy(v1),
                           7)
    for slot, row in ((0, 5), (1, 9)):
        for name in ("k", "v", "ks", "vs"):
            c = cache[name]
            same = (c[slot, :, 7] == c[slot, :, row] if name.endswith("s")
                    else c[slot, 7] == c[slot, row])
            assert same.all()


PROMPT = np.array([[3, 141, 59, 26, 5, 200, 17]], np.int32)
NEW_TOKENS = 12
MODELS = {
    "llama": (jllama.LlamaConfig(vocab_size=256, hidden_size=128,
                                 intermediate_size=256, n_layers=2,
                                 n_heads=4, n_kv_heads=2, max_seq=64), 4),
    "opt": (jopt.OPTConfig(vocab_size=256, hidden_size=128, ffn_dim=256,
                           n_layers=2, n_heads=4, max_seq=64), 3),
}


@pytest.mark.parametrize("model_type", sorted(MODELS))
def test_int8_engine_matches_jax(model_type):
    """Teacher-forced logits within 1e-4 of max |logit| and greedy tokens
    identical, f32 activations, int8 cache on both sides; the cache's token
    axis rounds up to 128 as the JAX engine's does."""
    config, bits = MODELS[model_type]
    build = _opt_tree if model_type == "opt" else _jax_tree
    specs, params = build(config, bits, seed=11)
    jeng = jengine.Engine(model_type, config, specs,
                          jax.tree.map(jnp.asarray, params), backend="xla",
                          cache_dtype="int8")
    model = carry.from_tree(model_type, dataclasses.asdict(config),
                            _module_meta(specs), params, "cpu")
    eng = engine.Engine(model, cache_dtype="int8")
    cache, jcache = eng.new_cache(1), jeng.new_cache(1)
    assert cache[0]["k"].shape == jcache[0]["k"].shape == (
        1, 128, config.n_kv_heads * config.head_dim)
    assert cache[0]["k"].dtype == torch.int8

    want = jeng.generate(PROMPT, NEW_TOKENS)
    np.testing.assert_array_equal(eng.generate(PROMPT, NEW_TOKENS), want)

    ids = want[:, :8]
    got = eng.teacher_forced_logits(ids).numpy()
    rows = []
    for i in range(ids.shape[1]):
        lg, jcache = jeng._decode(jeng.params, jnp.asarray(ids[:, i: i + 1]),
                                  jnp.asarray(i, jnp.int32), jcache)
        rows.append(np.asarray(lg[0, -1]))
    ref = np.stack(rows)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
