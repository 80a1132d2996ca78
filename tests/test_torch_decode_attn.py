"""K2's plain version (the port's decode attention on CPU tensors) against
the JAX package's fused Pallas decode kernel in interpret mode: rope from
cos/sin rows, cache write at row len-1, GQA, sliding window, lengths 0 and
S, f32 and bf16 caches."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from squeezellm_tpu.models import common as jcommon
from squeezellm_tpu.ops import decode_attn as jda
from squeezellm_tpu_torch.ops import decode_attn

TOL = 2e-5  # abs, outputs of magnitude ~1; both sides accumulate in f32


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("g,window,cache_dtype", [
    (1, None, "float32"), (2, None, "float32"), (2, 24, "float32"),
    (2, None, "bfloat16")])
def test_decode_attention_matches_pallas(g, window, cache_dtype):
    rng = np.random.default_rng(g * 10 + (window or 0))
    B, Hkv, S, hd = 3, 2, 64, 32
    H = g * Hkv
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k_new = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    v_new = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    ck = rng.normal(size=(B, S, Hkv * hd)).astype(np.float32)
    cv = rng.normal(size=(B, S, Hkv * hd)).astype(np.float32)
    lengths = np.array([37, 0, S], np.int32)  # mid, inactive, full cache
    cos, sin = jcommon.rope_cos_sin(jnp.asarray(np.maximum(lengths - 1, 0)),
                                    hd, 10000.0)

    jdt = jnp.bfloat16 if cache_dtype == "bfloat16" else jnp.float32
    want, wck, wcv = jda.dense_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(ck, jdt), jnp.asarray(cv, jdt), jnp.asarray(lengths),
        sliding_window=window, rope_cos=cos, rope_sin=sin, interpret=True)

    tdt = getattr(torch, cache_dtype)
    tck = torch.from_numpy(ck).to(tdt)
    tcv = torch.from_numpy(cv).to(tdt)
    got = decode_attn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tck, tcv, torch.from_numpy(lengths), sliding_window=window,
        rope_cos=torch.from_numpy(np.array(cos)),
        rope_sin=torch.from_numpy(np.array(sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    assert not got[1].any()  # inactive slot: zeros
    np.testing.assert_allclose(tck.float().numpy(), _np(wck), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tcv.float().numpy(), _np(wcv), rtol=0,
                               atol=0)


def test_decode_attention_length_beyond_cache_clamps():
    """A length past S writes row S-1 and attends all S rows, as the TPU
    kernel's n = min(len, S) does."""
    rng = np.random.default_rng(5)
    B, Hkv, S, hd = 1, 2, 32, 32
    q = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    kv = rng.normal(size=(2, B, Hkv, hd)).astype(np.float32)
    cache = rng.normal(size=(2, B, S, Hkv * hd)).astype(np.float32)
    lengths = np.array([S + 7], np.int32)
    want, wck, _ = jda.dense_decode_attention(
        jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
        jnp.asarray(cache[0]), jnp.asarray(cache[1]), jnp.asarray(lengths),
        interpret=True)
    tck, tcv = torch.from_numpy(cache[0].copy()), torch.from_numpy(cache[1].copy())
    got = decode_attn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
        tck, tcv, torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(tck.numpy(), np.asarray(wck))


def test_decode_split_count_follows_the_cache_capacity_alone():
    """K2/K5 split a slot's rows over ceil(S / CHUNK) blocks: a function
    of the cache's capacity S alone (its signature takes nothing else), so
    that a slot's bits do not depend on its cohort's size or lengths; the
    partial-state workspace of a shape is made once and reused."""
    import inspect

    assert list(inspect.signature(decode_attn.splits).parameters) == ["S"]
    C = decode_attn.CHUNK
    assert [decode_attn.splits(S) for S in (1, C, C + 1, 2048, 4096)] == [
        1, 1, 2, -(-2048 // C), -(-4096 // C)]
    acc, ml, cnt = decode_attn.workspace(torch.device("cpu"), 3, 2, 4, 32,
                                         2 * C + 5)
    assert acc.shape == (3, 2, 3, 4, 32) and ml.shape == (3, 2, 3, 4, 2)
    assert cnt.shape == (3, 2) and not cnt.any()
    again = decode_attn.workspace(torch.device("cpu"), 3, 2, 4, 32, 3 * C)
    assert all(a is b for a, b in zip(again, (acc, ml, cnt)))
