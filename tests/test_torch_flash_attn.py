"""K3's plain version (the port's flash attention on CPU tensors) against
the JAX package's Pallas flash kernel in interpret mode: causal from an
offset, GQA, sliding window, k/v taken from a longer cache."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from squeezellm_tpu.ops import flash_attn as jfa
from squeezellm_tpu_torch.ops import flash_attn

TOL = 2e-5  # abs, outputs of magnitude ~1; both sides accumulate in f32


@pytest.mark.parametrize("g,window", [(1, None), (2, None), (2, 24)])
def test_flash_offset0_matches_pallas(g, window):
    rng = np.random.default_rng(g + (window or 0))
    B, Hkv, Sq, hd = 2, 2, 48, 32
    H = g * Hkv
    q = rng.normal(size=(B, H, Sq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sq, hd)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sq, hd)).astype(np.float32)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(0, jnp.int32),
                               sliding_window=window, interpret=True)
    got = flash_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), 0,
                                     sliding_window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_flash_offset_into_cache_matches_pallas(kv_dtype):
    """q rows at [24, 40) over a 64-row cache whose rows past 40 hold
    finite garbage, never attended."""
    rng = np.random.default_rng(1)
    B, Hkv, g, Sq, Sk, hd, off = 1, 2, 2, 16, 64, 32, 24
    q = rng.normal(size=(B, Hkv * g, Sq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sk, hd)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, hd)).astype(np.float32)
    k[:, :, off + Sq:] = 1e4
    v[:, :, off + Sq:] = -1e4
    jdt = jnp.bfloat16 if kv_dtype == "bfloat16" else jnp.float32
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k, jdt),
                               jnp.asarray(v, jdt),
                               jnp.asarray(off, jnp.int32), interpret=True)
    tdt = getattr(torch, kv_dtype)
    got = flash_attn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), off)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("form", ["0-d int64", "(1,) int32"])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_offset_read_from_a_tensor_matches_pallas(form, window):
    """The offset as a tensor (the form a captured verify window reads on
    the card) gives the int offset's output, and the Pallas kernel's with
    its traced offset."""
    rng = np.random.default_rng(2)
    B, Hkv, g, Sq, Sk, hd, off = 1, 2, 2, 16, 64, 32, 37
    q = rng.normal(size=(B, Hkv * g, Sq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sk, hd)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, hd)).astype(np.float32)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(off, jnp.int32),
                               sliding_window=window, interpret=True)
    t = (torch.tensor(off) if form == "0-d int64"
         else torch.tensor([off], dtype=torch.int32))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = flash_attn.flash_attention(*args, t, sliding_window=window)
    assert torch.equal(got, flash_attn.flash_attention(
        *args, off, sliding_window=window))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError, match="offset"):
        flash_attn.flash_attention(*args, torch.tensor([1.0]))


@pytest.mark.parametrize("window", [None, 9])
def test_flash_bf16_mode_on_the_cpu_runs_the_plain_version(window):
    """mode="bf16" picks the tensor-core kernel only on the card: on CPU
    tensors K3 is its plain version (f32 products of the bf16 inputs),
    equal to the exact mode's bit for bit and within TOL of the Pallas
    kernel, and no launch is counted."""
    rng = np.random.default_rng(7)
    B, Hkv, g, Sq, Sk, hd, off = 1, 2, 2, 16, 64, 32, 21
    q, k, v = (rng.normal(size=(B, n, s, hd)).astype(np.float32)
               for n, s in ((Hkv * g, Sq), (Hkv, Sk), (Hkv, Sk)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    before = (flash_attn.flash_attention.launches,
              dict(flash_attn.flash_attention.regime_launches))
    got = flash_attn.flash_attention(tq, tk, tv, off, sliding_window=window,
                                     mode="bf16")
    assert (flash_attn.flash_attention.launches,
            flash_attn.flash_attention.regime_launches) == before
    exact = flash_attn.flash_attention_plain(tq, tk, tv, off,
                                             sliding_window=window)
    torch.testing.assert_close(got, exact, rtol=0, atol=0)
    want = jfa.flash_attention(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                                 for a in (tq, tk, tv)),
                               jnp.asarray(off, jnp.int32),
                               sliding_window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="mode"):
        flash_attn.flash_attention(tq, tk, tv, off, mode="f16")
