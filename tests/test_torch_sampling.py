"""The port's `sample_tokens` against the JAX package's on the same seeded
logits: greedy slots equal, the kept set (top-k, exclusive-cumulative
top-p) equal, sampled frequencies within 4 sigma of the masked softmax,
and a draw that depends on (seed, request id, position) only. The two
packages' random streams differ by construction, so sampled tokens are
compared as sets and distributions, never draw by draw."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from squeezellm_tpu import sampling as jsampling
from squeezellm_tpu_torch import sampling

V = 300


def _logits(seed, B=6):
    return (np.random.default_rng(seed).standard_normal((B, V)) * 3
            ).astype(np.float32)


def _args(temp, topk, topp, rids, pos):
    return (np.asarray(temp, np.float32), np.asarray(topk, np.int32),
            np.asarray(topp, np.float32), np.asarray(rids, np.int32),
            np.asarray(pos, np.int32))


def _port(logits, args, seed):
    return sampling.sample_tokens(
        torch.from_numpy(logits), *(torch.from_numpy(a) for a in args),
        seed).numpy()


def _jax(logits, args, seed):
    return np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), *(jnp.asarray(a) for a in args), seed))


def test_params_and_constants_match_jax():
    assert sampling.MAX_TOPK == jsampling.MAX_TOPK == 64
    assert sampling.GREEDY == sampling.SamplingParams()
    for kw in (dict(top_k=65), dict(top_p=0.0), dict(top_p=1.5)):
        with pytest.raises(ValueError):
            sampling.SamplingParams(**kw)
        with pytest.raises(ValueError):
            jsampling.SamplingParams(**kw)
    p = sampling.SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
    assert (p.temperature, p.top_k, p.top_p) == (0.8, 40, 0.95)


def test_greedy_slots_equal_jax():
    """temperature <= 0 takes the argmax, whatever the other parameters;
    mixed with sampled slots in one batch."""
    logits = _logits(0)
    args = _args([0.0, -1.0, 0.0, 0.7, 0.0, 1.3], [0, 5, 64, 3, 1, 0],
                 [1.0, 0.5, 0.9, 0.8, 1.0, 1.0], range(6), [0, 3, 9, 1, 2, 7])
    got, want = _port(logits, args, 5), _jax(logits, args, 5)
    greedy = [0, 1, 2, 4]
    np.testing.assert_array_equal(got[greedy], want[greedy])
    np.testing.assert_array_equal(got[greedy], logits.argmax(-1)[greedy])
    # a top-k of 1 is greedy as well, in both
    args1 = _args([0.9] * 6, [1] * 6, [1.0] * 6, range(6), range(6))
    np.testing.assert_array_equal(_port(logits, args1, 1),
                                  logits.argmax(-1))
    np.testing.assert_array_equal(_jax(logits, args1, 1), logits.argmax(-1))


@pytest.mark.parametrize("temp,topk,topp", [
    (1.0, 5, 1.0), (0.7, 0, 0.6), (1.5, 8, 0.7), (1.0, 64, 0.35)])
def test_kept_set_equals_jax(temp, topk, topp):
    """The kept candidates: the port's mask on the logits equals the
    support of 3000 draws of the JAX function (every kept token has
    probability above 1%, so none is missed but with chance < 1e-11), and
    of 3000 draws of the port's."""
    rng = np.random.default_rng(int(temp * 10) + topk)
    n = 3000
    row = np.full(V, -30.0, np.float32)
    hot = rng.permutation(V)[:12]
    row[hot] = rng.uniform(0.0, 2.0, 12).astype(np.float32)
    logits = np.tile(row, (n, 1))
    args = _args([temp] * n, [topk] * n, [topp] * n, [3] * n, range(n))
    idx, logp, keep = sampling.candidates(
        torch.from_numpy(row[None]), torch.tensor([temp]),
        torch.tensor([topk]), torch.tensor([topp]))
    kept = set(idx[0][keep[0]].tolist())
    assert 1 <= len(kept) <= 12 and kept <= set(hot.tolist())
    assert float(torch.exp(logp[0][keep[0]]).min()) > 0.01
    assert set(_jax(logits, args, 11).tolist()) == kept
    assert set(_port(logits, args, 11).tolist()) == kept


def test_sampled_frequencies_match_the_masked_softmax():
    """20000 draws at consecutive positions of one stream: every kept
    token's count within 4 sigma of n * p, p the softmax over the kept
    candidates at the temperature."""
    n = 20000
    rng = np.random.default_rng(9)
    row = rng.standard_normal(V).astype(np.float32) * 2
    temp, topk, topp = 0.9, 20, 0.9
    idx, logp, keep = sampling.candidates(
        torch.from_numpy(row[None]), torch.tensor([temp]),
        torch.tensor([topk]), torch.tensor([topp]))
    ids = idx[0][keep[0]].numpy()
    p = torch.softmax(logp[0][keep[0]].double(), 0).numpy()
    assert 3 <= len(ids) <= topk
    args = _args([temp] * n, [topk] * n, [topp] * n, [7] * n, range(n))
    got = _port(np.tile(row, (n, 1)), args, 123)
    assert set(got.tolist()) <= set(ids.tolist())
    counts = np.array([(got == t).sum() for t in ids])
    sigma = np.sqrt(n * p * (1 - p))
    assert (np.abs(counts - n * p) <= 4 * sigma + 1).all(), (counts, n * p)


def test_draw_depends_on_seed_rid_pos_only():
    """The same (seed, rid, pos) and logits give the same token in any
    batch and any slot; another seed, rid or position gives another
    stream. No global RNG state is read."""
    logits = _logits(4, B=8)
    args = _args([1.0] * 8, [0] * 8, [1.0] * 8, [5, 9, 2, 7, 1, 0, 3, 8],
                 [4, 4, 10, 0, 99, 3, 3, 50])
    torch.manual_seed(0)
    a = _port(logits, args, 42)
    torch.manual_seed(12345)
    torch.rand(7)
    np.testing.assert_array_equal(_port(logits, args, 42), a)
    # a permuted batch, and each slot alone
    perm = np.array([3, 0, 7, 5, 1, 6, 2, 4])
    np.testing.assert_array_equal(
        _port(logits[perm], tuple(x[perm] for x in args), 42), a[perm])
    for b in range(8):
        one = _port(logits[b: b + 1], tuple(x[b: b + 1] for x in args), 42)
        assert one[0] == a[b]
    # flat logits: the draw is the stream's alone, so streams can be told
    # apart
    flat = np.zeros((64, V), np.float32)
    base = _args([1.0] * 64, [0] * 64, [1.0] * 64, [1] * 64, range(64))
    s0 = _port(flat, base, 42)
    assert len(set(s0.tolist())) > 20
    for other in (_port(flat, base, 43),
                  _port(flat, base[:3] + (base[3] + 1, base[4]), 42),
                  _port(flat, base[:4] + (base[4] + 64,), 42)):
        assert (other != s0).mean() > 0.8
    u = sampling.stream_uniforms(42, torch.arange(200), torch.arange(200))
    assert u.shape == (200, 64) and 0.0 < float(u.min())
    assert float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.01
