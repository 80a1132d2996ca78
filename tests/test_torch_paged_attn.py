"""K6-K9's plain PyTorch versions against the JAX package's paged Pallas
kernels in interpret mode, on the same seeded inputs: decode and the
W-token verify window, float and int8 pools, GQA, sliding window, rope and
none, inactive slots, a window crossing a page boundary, page tables that
are shuffled and share a prefix page, 16- and 8-row pages.

Outputs agree within 1e-5 of max |out| (f32 on both sides; the kernel sums
page by page with an online softmax, the plain version over the gathered
rows). Written pool rows are equal; with rope the k rows may differ in the
last f32 bit between the two frameworks (XLA may contract the rotation's
multiply-add), which can move an int8 code by one step. The JAX sidecar's
head rows padded to 8 are cut off before comparing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from squeezellm_tpu.models import common as jcommon
from squeezellm_tpu.ops import kv_quant as jkv
from squeezellm_tpu.ops import paged_attn as jpa
from squeezellm_tpu_torch import carry
from squeezellm_tpu_torch.ops import kv_quant, paged_attn

B, HKV, HD, MAXP = 4, 2, 64, 4

# (g, sliding window, rope, page size)
CASES = [(1, None, True, 16), (2, None, False, 16), (2, 20, True, 16),
         (4, 11, True, 8)]


def _inputs(seed, g, ps, W, index, q8):
    """Seeded q/k/v, pools with history, and a shuffled page table in which
    the two slots that write beyond their first page share it."""
    rng = np.random.default_rng(seed)
    H = g * HKV
    P = B * MAXP + 2
    pt = rng.permutation(P)[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    first = np.asarray(index) - (1 if W is None else 0)
    sharers = np.nonzero(first >= ps)[0]
    pt[sharers, 0] = pt[sharers[0], 0]
    pt[first < 0] = 0  # an inactive slot's table is zeroed
    w = W or 1
    q = rng.standard_normal((B, H, w, HD)).astype(np.float32)
    k = rng.standard_normal((B, HKV, w, HD)).astype(np.float32)
    v = rng.standard_normal((B, HKV, w, HD)).astype(np.float32)
    hist = rng.standard_normal((2, P, ps, HKV, HD)).astype(np.float32)
    if q8:
        codes, sc = jkv.quantize_rows(jnp.asarray(hist))
        pools = [np.asarray(codes[i]).reshape(P, ps, HKV * HD)
                 for i in (0, 1)]
        # (P, ps, Hkv, 1) -> the JAX sidecar (P, 8, ps)
        pools += [np.asarray(jkv.pool_pack_scales(
            jnp.swapaxes(sc[i], 1, 2))) for i in (0, 1)]
    else:
        pools = [hist[i].reshape(P, ps, HKV * HD) for i in (0, 1)]
    if W is None:
        q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    return q, k, v, pools, pt, np.asarray(index, np.int32)


def _rope_rows(first, W, dtype=jnp.float32):
    """cos/sin rows at each slot's positions, the model's values."""
    pos = np.maximum(first, 0)[:, None] + np.arange(W or 1)
    cos, sin = jcommon.rope_cos_sin(jnp.asarray(pos if W else pos[:, 0]), HD,
                                    10000.0, dtype)
    return cos, sin


def _port_pools(pools):
    """The port's tensors of the JAX pools (sidecars cut to Hkv rows)."""
    layer = dict(zip(("pk", "pv", "sk", "sv"), pools))
    d = carry.pools_from_jax([layer], HKV, "cpu")[0]
    return [d[n] for n in ("pk", "pv", "sk", "sv") if n in d]


def _compare(got, want, port_pools, jax_pools, written, rope, q8):
    """got/want outputs; pools after the call; written: bool (P, ps) of the
    rows the call wrote."""
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    jp = [np.asarray(a) for a in jax_pools]
    if q8:
        jp[2], jp[3] = jp[2][:, :HKV], jp[3][:, :HKV]
    pp = [t.numpy() for t in port_pools]
    # v rows and every row not written: equal
    np.testing.assert_array_equal(pp[1], jp[1])
    np.testing.assert_array_equal(pp[0][~written], jp[0][~written])
    if q8:
        np.testing.assert_array_equal(pp[3], jp[3])
    if not rope:
        np.testing.assert_array_equal(pp[0], jp[0])
        if q8:
            np.testing.assert_array_equal(pp[2], jp[2])
    elif q8:
        assert np.abs(pp[0].astype(np.int32) - jp[0].astype(np.int32)
                      ).max() <= 1
        np.testing.assert_allclose(pp[2], jp[2], rtol=3e-7, atol=0)
    else:
        np.testing.assert_allclose(pp[0], jp[0], rtol=0, atol=1e-6)
    assert written.any() and not np.array_equal(pp[0][written],
                                                np.zeros_like(pp[0][written]))


def _written(pt, first, W, ps, P):
    out = np.zeros((P, ps), bool)
    for b in range(B):
        if first[b] < 0:
            continue
        for w in range(W or 1):
            pos = first[b] + w
            out[pt[b, pos // ps], pos % ps] = True
    return out


@pytest.mark.parametrize("q8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("g,window,rope,ps", CASES)
def test_paged_decode_plain_matches_pallas(g, window, rope, ps, q8):
    lengths = [1, ps + 5, 0, 3 * ps]
    q, k, v, pools, pt, idx = _inputs(g * 7 + ps, g, ps, None, lengths, q8)
    jkw, kw = {}, {}
    if rope:
        cos, sin = _rope_rows(idx - 1, None)
        jkw = dict(rope_cos=cos, rope_sin=sin)
        kw = dict(rope_cos=torch.from_numpy(np.array(cos)),
                  rope_sin=torch.from_numpy(np.array(sin)))
    jfn = jpa.paged_decode_attention_q8 if q8 else jpa.paged_decode_attention
    want, *jpools = jfn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        *(jnp.asarray(p) for p in pools), jnp.asarray(pt), jnp.asarray(idx),
        page_size=ps, sliding_window=window, interpret=True, **jkw)

    fn = (paged_attn.paged_decode_attention_q8 if q8
          else paged_attn.paged_decode_attention)
    tp = _port_pools(pools)
    before = fn.launches
    got = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             *tp, torch.from_numpy(pt), torch.from_numpy(idx),
             sliding_window=window, **kw)
    assert fn.launches == before  # CPU tensors: the plain version
    assert not got[2].any()  # the zero-length slot
    _compare(got, want, tp, jpools,
             _written(pt, idx - 1, None, ps, pools[0].shape[0]), rope, q8)


@pytest.mark.parametrize("q8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("g,window,rope,ps", CASES)
def test_paged_verify_plain_matches_pallas(g, window, rope, ps, q8):
    W = 3 if ps == 8 else 5
    starts = [0, ps - 2, -1, 2 * ps + 1]  # slot 1's window crosses a page
    q, k, v, pools, pt, idx = _inputs(g * 11 + ps, g, ps, W, starts, q8)
    jkw, kw = {}, {}
    if rope:
        cos, sin = _rope_rows(idx, W)
        jkw = dict(rope_cos=cos, rope_sin=sin)
        kw = dict(rope_cos=torch.from_numpy(np.array(cos)),
                  rope_sin=torch.from_numpy(np.array(sin)))
    jfn = jpa.paged_verify_attention_q8 if q8 else jpa.paged_verify_attention
    want, *jpools = jfn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        *(jnp.asarray(p) for p in pools), jnp.asarray(pt), jnp.asarray(idx),
        page_size=ps, sliding_window=window, interpret=True, **jkw)

    fn = (paged_attn.paged_verify_attention_q8 if q8
          else paged_attn.paged_verify_attention)
    tp = _port_pools(pools)
    before = fn.launches
    got = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             *tp, torch.from_numpy(pt), torch.from_numpy(idx),
             sliding_window=window, **kw)
    assert fn.launches == before
    assert got.shape == (B, g * HKV, W, HD) and not got[2].any()
    _compare(got, want, tp, jpools,
             _written(pt, idx, W, ps, pools[0].shape[0]), rope, q8)


def test_bf16_pool_rounds_the_new_rows():
    """A bf16 pool holds the new rows rounded to bf16, and they enter
    attention as stored: the output equals the one over an f32 pool that
    holds the rounded rows."""
    ps = 16
    q, k, v, pools, pt, idx = _inputs(3, 2, ps, None, [1, ps + 5, 0, 3 * ps],
                                      False)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    bf = [torch.from_numpy(p).to(torch.bfloat16) for p in pools]
    f32 = [p.float() for p in bf]
    tail = (torch.from_numpy(pt), torch.from_numpy(idx))
    got = paged_attn.paged_decode_attention(*args, *bf, *tail)
    kr = args[1].to(torch.bfloat16).float()
    vr = args[2].to(torch.bfloat16).float()
    want = paged_attn.paged_decode_attention(args[0], kr, vr, *f32, *tail)
    assert bf[0].dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for a, b in zip(bf, f32):
        assert torch.equal(a.float(), b)


def test_pool_scale_layout():
    """The port's sidecar is (P, Hkv, ps), the JAX one's live rows."""
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((3, 8, HKV, HD)).astype(np.float32)
    _, sc = kv_quant.quantize_rows(torch.from_numpy(rows))
    packed = kv_quant.pool_pack_scales(sc)
    assert packed.shape == (3, HKV, 8)
    _, jsc = jkv.quantize_rows(jnp.asarray(rows))
    jpacked = np.asarray(jkv.pool_pack_scales(jnp.swapaxes(jsc, 1, 2)))
    assert jpacked.shape == (3, 8, 8)
    np.testing.assert_array_equal(packed.numpy(), jpacked[:, :HKV])
    assert torch.equal(kv_quant.pool_unpack_scales(packed), sc)


def test_paged_split_count_follows_the_table_capacity_alone():
    """K6-K9 split a slot's positions over ceil(maxp * ps / CHUNK) blocks:
    a function of the page table's capacity alone (its signature takes
    nothing else), so that a slot's bits do not depend on its cohort's
    size, lengths or starts; CHUNK stays within the kernel's bound."""
    import inspect
    import os
    import re

    assert list(inspect.signature(paged_attn.splits).parameters) == [
        "capacity"]
    C = paged_attn.CHUNK
    assert [paged_attn.splits(n) for n in (1, C, C + 1, 2048, 5120)] == [
        1, 1, 2, -(-2048 // C), -(-5120 // C)]
    # 16-row and 128-row pages of one capacity split alike
    assert paged_attn.splits(128 * 16) == paged_attn.splits(16 * 128)
    src = os.path.join(os.path.dirname(paged_attn.__file__), "..", "csrc",
                       "paged_attn.cu")
    with open(src) as f:
        bound = int(re.search(r"kMaxChunk = (\d+);", f.read()).group(1))
    assert 1 <= C <= bound


def test_paged_workspace_is_made_once_per_shape():
    """The partial states and counters of one call shape (B, Hkv, g * W
    rows, hd, splits) are allocated once, counters zeroed, and the same
    tensors come back for the same shape; another row count gets its own."""
    dev = torch.device("cpu")
    acc, ml, cnt = paged_attn.workspace(dev, 3, 2, 5, 64, 4)
    assert acc.shape == (3, 2, 4, 5, 64) and ml.shape == (3, 2, 4, 5, 2)
    assert acc.dtype == ml.dtype == torch.float32
    assert cnt.shape == (3, 2) and cnt.dtype == torch.int32
    assert not cnt.any()
    again = paged_attn.workspace("cpu", 3, 2, 5, 64, 4)
    assert all(a is b for a, b in zip(again, (acc, ml, cnt)))
    other = paged_attn.workspace(dev, 3, 2, 1, 64, 4)
    assert other[0].shape == (3, 2, 4, 1, 64) and other[0] is not acc


@pytest.mark.parametrize("bad", ["hd", "group", "window", "table", "scales",
                                 "index", "rope", "pool", "dtype",
                                 "strides"])
def test_wrappers_refuse_on_the_cpu_what_the_kernels_refuse(bad):
    """A CPU tensor meets the same refusals as a CUDA tensor would."""
    ps, W = 16, 3
    hd = 48 if bad == "hd" else HD
    H = 18 if bad == "group" else 2 * HKV
    W = 9 if bad == "window" else W
    dtype = torch.float16 if bad == "dtype" else torch.float32
    q = torch.zeros(B, H, W, hd, dtype=dtype)
    k = torch.zeros(B, HKV, W, hd, dtype=dtype)
    # v_new as a head-major view of a token-major tensor: other strides
    v = (torch.zeros(B, W, HKV, hd).transpose(1, 2) if bad == "strides"
         else k)
    pools = [torch.zeros(6, ps, HKV * hd) for _ in (0, 1)]
    if bad == "pool":
        pools[1] = torch.zeros(6, HKV * hd, ps).transpose(1, 2)
    pt = torch.zeros(B, MAXP, dtype=torch.int64 if bad == "table"
                     else torch.int32)
    start = torch.zeros(B, dtype=torch.int64 if bad == "index"
                        else torch.int32)
    kw = {}
    if bad == "rope":  # cos without sin
        kw = dict(rope_cos=torch.zeros(B, W, hd))
    with pytest.raises(ValueError):
        if bad == "scales":
            codes = [p.to(torch.int8) for p in pools]
            sc = [torch.zeros(6, 8, ps) for _ in (0, 1)]  # padded head rows
            paged_attn.paged_verify_attention_q8(q, k, k, *codes, *sc, pt,
                                                 start)
        else:
            paged_attn.paged_verify_attention(q, k, v, *pools, pt, start,
                                              **kw)
