"""The port's perplexity path against the JAX package: the token sources,
`stride_nll` and `perplexity` on a tiny quantized LLaMA and a tiny
quantized OPT (backend 'xla', f32), K4's plain version with its dense
matmul against the Pallas big-batch path in interpret mode, the row-count
dispatch of `quant_linear_apply`, and the `eval` command line."""

import dataclasses
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
from squeezellm_tpu import data as jdata
from squeezellm_tpu import eval as jeval
from squeezellm_tpu import formats as jformats
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.models import opt as jopt
from squeezellm_tpu.ops import pallas_ops
from squeezellm_tpu_torch import carry, data
from squeezellm_tpu_torch import eval as eval_mod
from squeezellm_tpu_torch.ops import dequant_dense as tdd
from squeezellm_tpu_torch.ops import lut_matmul as tlm
from squeezellm_tpu_torch.ops import quant_linear as tql
from test_torch_model import _jax_tree, _module_meta
from test_torch_opt import _opt_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQLEN = 24
PPL_RTOL = 1e-5  # f32 on both sides, sums in another order


def test_token_sources_match_jax(tmp_path):
    for vocab, n, seed in ((32000, 4096, 0), (50272, 1000, 7)):
        np.testing.assert_array_equal(
            data.synthetic_tokens(vocab, n, seed),
            jdata.synthetic_tokens(vocab, n, seed))
    corpus = np.random.default_rng(1).integers(0, 999, 5000)
    path = str(tmp_path / "corpus.npy")
    np.save(path, corpus)
    for name in ("synthetic", path):
        kw = dict(nsamples=6, seed=3, seqlen=64, vocab_size=999)
        got, want = data.get_loaders(name, **kw), jdata.get_loaders(name, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="tokenizer"):
        data.get_loaders("wikitext2")


MODELS = {
    "llama-w3": ("llama", jllama.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256, n_layers=2,
        n_heads=4, n_kv_heads=2, max_seq=64), 3, True),
    "llama-w4-nosidecar": ("llama", jllama.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256, n_layers=2,
        n_heads=4, n_kv_heads=2, max_seq=64), 4, False),
    "opt-w4": ("opt", jopt.OPTConfig(
        vocab_size=256, hidden_size=128, ffn_dim=256, n_layers=2, n_heads=4,
        max_seq=64), 4, True),
    "opt-w3-nosidecar": ("opt", jopt.OPTConfig(
        vocab_size=256, hidden_size=128, ffn_dim=256, n_layers=2, n_heads=4,
        max_seq=64), 3, False),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """One random tree as the JAX package's arguments and the port's
    model."""
    model_type, config, bits, sparse = MODELS[request.param]
    build = _opt_tree if model_type == "opt" else _jax_tree
    specs, params = build(config, bits, seed=5, sparse=sparse)
    model = carry.from_tree(model_type, dataclasses.asdict(config),
                            _module_meta(specs), params, "cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    return model_type, config, specs, jparams, model


# 7 strides: group 3 pads its last group with two repeats
@pytest.mark.parametrize("group,nsamples", [(1, 2), (3, None)])
def test_perplexity_matches_jax(pair, group, nsamples):
    model_type, config, specs, jparams, model = pair
    tokens = data.synthetic_tokens(config.vocab_size, 7 * SEQLEN + 5, seed=2)
    want = jeval.perplexity(model_type, config, specs, jparams, tokens,
                            seqlen=SEQLEN, nsamples=nsamples, backend="xla",
                            dtype=jnp.float32, group=group)
    got = eval_mod.perplexity(model, tokens, seqlen=SEQLEN,
                              nsamples=nsamples, group=group)
    assert abs(got - want) <= PPL_RTOL * want, (got, want)


def test_perplexity_through_k4_route(pair, monkeypatch):
    """With the dispatch point lowered so that every linear of a group
    takes the dequantize-then-matmul route, the perplexity stays the JAX
    package's."""
    model_type, config, specs, jparams, model = pair
    tokens = data.synthetic_tokens(config.vocab_size, 4 * SEQLEN, seed=4)
    want = jeval.perplexity(model_type, config, specs, jparams, tokens,
                            seqlen=SEQLEN, backend="xla", dtype=jnp.float32,
                            group=2)
    monkeypatch.setattr(tql, "BIG_BATCH", 2 * SEQLEN)
    got = eval_mod.perplexity(model, tokens, seqlen=SEQLEN, group=2)
    assert abs(got - want) <= PPL_RTOL * want, (got, want)
    with pytest.raises(ValueError, match="too short"):
        eval_mod.perplexity(model, tokens[:, :SEQLEN - 1], seqlen=SEQLEN)


def test_stride_nll_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 9, 50)).astype(np.float32) * 4
    tokens = rng.integers(0, 50, (3, 9)).astype(np.int32)
    got = eval_mod.stride_nll(torch.from_numpy(logits),
                              torch.from_numpy(tokens))
    assert got.shape == (3,) and got.dtype == torch.float32
    for b in range(3):  # the JAX function takes one mean over its batch
        want = jeval.stride_nll(jnp.asarray(logits[b: b + 1]),
                                jnp.asarray(tokens[b: b + 1]))
        np.testing.assert_allclose(float(got[b]), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# K4's plain version + the dense matmul against the Pallas big-batch path
# ---------------------------------------------------------------------------

OUT_F, IN_F = 128, 316  # the last packed word is partial at bits 3 and 4
# max |dy| / max |y|. bf16 mode could be allowed the 1e-2 of a bf16 step, but
# both sides round x, the LUT and the folded sidecar to the same bf16 values
# and sum their products in f32, so it is held as tightly as exact mode.
TOL_K4 = {"exact": 1e-5, "bf16": 1e-5}


def _linear(rng, bits):
    nw = jformats.n_words(IN_F, bits)
    qweight = rng.integers(-2**31, 2**31, (nw, OUT_F),
                           dtype=np.int64).astype(np.int32)
    lut = np.sort(rng.standard_normal((OUT_F, 2**bits)).astype(np.float32),
                  axis=1)
    dense = np.zeros((OUT_F, IN_F), np.float32)
    mask = rng.random((OUT_F, IN_F)) < 0.02
    dense[mask] = rng.standard_normal(mask.sum()).astype(np.float32)
    coo = jformats.SparseCOO.from_dense(dense, pad_multiple=64)
    assert coo.nnz < len(coo.vals)  # padding present
    return qweight, lut, coo


@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("bits", [3, 4])
def test_dequant_dense_plain_matches_pallas_bigbatch(bits, mode):
    """`pallas_ops.lut_matmul(big_batch=8)` forces `_dequant_dense_kernel`
    and the COO fold on a small problem (interpret mode), with y0."""
    rng = np.random.default_rng(40 + bits)
    qweight, lut, coo = _linear(rng, bits)
    x = rng.standard_normal((16, IN_F)).astype(np.float32)
    y0 = rng.standard_normal((16, OUT_F)).astype(np.float32)
    want = np.asarray(pallas_ops.lut_matmul(
        jnp.asarray(x), jnp.asarray(qweight), jnp.asarray(lut), bits,
        interpret=True, mode="gather" if mode == "exact" else "bf16",
        big_batch=8, sp_rows=jnp.asarray(coo.rows),
        sp_cols=jnp.asarray(coo.cols), sp_vals=jnp.asarray(coo.vals),
        y0=jnp.asarray(y0)))

    rowptr, cols, vals = carry.csr_from_coo(coo.rows, coo.cols, coo.vals,
                                            OUT_F, IN_F)
    w = tdd.dequant_dense(torch.from_numpy(qweight), torch.from_numpy(lut),
                          bits, IN_F, rowptr=torch.from_numpy(rowptr),
                          cols=torch.from_numpy(cols),
                          vals=torch.from_numpy(vals), mode=mode)
    assert w.shape == (IN_F, OUT_F)
    assert w.dtype == (torch.bfloat16 if mode == "bf16" else torch.float32)
    got = tdd.dense_matmul(torch.from_numpy(x), w) + torch.from_numpy(y0)
    assert got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    # measured on the CPU: 5.2e-7 (w3) and 4.8e-7 (w4) in exact mode,
    # 2.1e-7 and 3.2e-7 in bf16 mode
    assert err <= TOL_K4[mode], err


def test_dequant_dense_fold_adds_duplicates_in_csr_order():
    """Corrections add on top of the dequantized slot, duplicates of a slot
    one after the other with each sum rounded to W's type, and zero-valued
    padding that points at slot (0, 0) changes nothing."""
    bits, in_f, out_f = 4, 8, 3
    qweight = torch.zeros((1, out_f), dtype=torch.int32)  # every code 0
    lut = torch.zeros((out_f, 16))
    lut[:, 0] = torch.tensor([1.0, 2.0, 3.0])
    # row 0: padding twice at col 0; row 1: col 5 three times; row 2: col 7
    rowptr = torch.tensor([0, 2, 5, 6], dtype=torch.int32)
    cols = torch.tensor([0, 0, 5, 5, 5, 7], dtype=torch.int32)
    vals = torch.tensor([0.0, 0.0, 2.0**-7, 2.0**-7, 1.0, -0.5])
    kw = dict(rowptr=rowptr, cols=cols, vals=vals)
    w = tdd.dequant_dense(qweight, lut, bits, in_f, mode="exact", **kw)
    want = torch.tensor([1.0, 2.0, 3.0]).repeat(in_f, 1)
    want[5, 1] += 2.0**-6 + 1.0
    want[7, 2] -= 0.5
    torch.testing.assert_close(w, want, rtol=0, atol=0)
    # bf16 steps by 2**-6 at 2: 2 + 2**-7 is a tie and rounds back to 2
    # (to even) each time, so the sequential sum is 3; adding the three
    # values first would give 3 + 2**-6, which bf16 holds
    wb = tdd.dequant_dense(qweight, lut, bits, in_f, mode="bf16", **kw)
    assert wb[5, 1] == 3.0 and wb[0, 0] == 1.0 and wb[7, 2] == 2.5


# ---------------------------------------------------------------------------
# The row-count dispatch
# ---------------------------------------------------------------------------


def _port_linear(rng, bits, in_f=40, out_f=24):
    nw = jformats.n_words(in_f, bits)
    p = {"qweight": rng.integers(-2**31, 2**31, (nw, out_f),
                                 dtype=np.int64).astype(np.int32),
         "lut": np.sort(rng.standard_normal((out_f, 2**bits))
                        .astype(np.float32), axis=1),
         "sp_rows": np.array([0, 3, 3, 23], np.int32),
         "sp_cols": np.array([1, 0, 39, 7], np.int32),
         "sp_vals": np.array([0.5, -1.0, 0.25, 2.0], np.float32),
         "topx_weights": rng.standard_normal((in_f, 2)).astype(np.float32),
         "topx_indices": np.array([5, 11], np.int32),
         "bias": rng.standard_normal(out_f).astype(np.float32)}
    meta = {"quant": True, "bits": bits, "has_bias": True, "topx": 2}
    return carry.linear_from_tree(in_f, meta, p, "cpu")


def _dispatch_device():
    return "cuda" if torch.cuda.is_available() else "cpu"


def _check_dispatch(device, rows, mode):
    """`quant_linear_apply` at `rows` rows: the branch taken (K1 below
    BIG_BATCH, K4 + matmul from there), by which plain version it equals
    and, on the card, by the launch counters; the result against K1's
    plain version within K1's tolerances."""
    rng = np.random.default_rng(rows)
    lin = _port_linear(rng, 3).to(device)
    x = torch.from_numpy(rng.standard_normal((rows, 40)).astype(np.float32))
    y0 = torch.from_numpy(rng.standard_normal((rows, 24)).astype(np.float32))
    x, y0 = x.to(device), y0.to(device)
    before = (tlm.lut_matmul.launches, tdd.dequant_dense.launches)
    got = lin(x, mode=mode, y0=y0)
    took = (tlm.lut_matmul.launches - before[0],
            tdd.dequant_dense.launches - before[1])
    big = rows >= tql.BIG_BATCH
    if device == "cuda":
        assert took == ((0, 1) if big else (1, 0))
    else:
        assert took == (0, 0)  # a CPU tensor launches nothing
    t = lin.tensors()
    sparse = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"], vals=t["sp_vals"])
    k1 = tlm.lut_matmul_plain(x, t["qweight"], t["lut"], 3, y0=y0, mode=mode,
                              **sparse)
    k4 = tdd.dense_matmul(x, tdd.dequant_dense_plain(
        t["qweight"], t["lut"], 3, 40, mode=mode, **sparse), plain=True) + y0
    branch = k4 if big else k1
    # the top-X product as plain_ops.hybrid_matmul takes it: in f64
    topx = (x.double() @ t["topx_weights"].double()).float()
    rest = branch.clone().index_add_(-1, t["topx_indices"], topx) + t["bias"]
    tol = {"exact": 1e-5, "bf16": 1e-4}[mode]
    scale = float(rest.abs().max())
    assert float((got - rest).abs().max()) <= tol * scale
    if device == "cpu":  # the very same arithmetic: bit-identical
        torch.testing.assert_close(got, rest, rtol=0, atol=0)
    return float((k4 - k1).abs().max()) / scale


@pytest.mark.parametrize("rows", [1023, 1024, 2048])
@pytest.mark.parametrize("mode", ["exact", "bf16"])
def test_row_count_dispatch_cpu(rows, mode):
    """1023 rows take K1's branch, 1024 and 2048 K4's, on a CPU tensor as
    on the card (`test_row_count_dispatch_gpu`), and no row count raises."""
    seam = _check_dispatch("cpu", rows, mode)
    # the two branches agree but for the sidecar meeting a bf16-rounded x
    # and being rounded into a bf16 W in the K4 band (measured on the CPU:
    # 2e-7 in exact mode, 5e-4 to 1.1e-3 of max |y| in bf16 mode)
    assert seam <= (1e-5 if mode == "exact" else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1023, 1024, 2048])
@pytest.mark.parametrize("mode", ["exact", "bf16"])
def test_row_count_dispatch_gpu(rows, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _check_dispatch("cuda", rows, mode)


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def test_cli_eval_prints_the_functions_perplexity(tmp_path):
    config = MODELS["llama-w3"][1]
    specs, params = _jax_tree(config, 3, seed=9)
    ckpt = str(tmp_path / "ckpt")
    jcheckpoint.save_quantized(ckpt, "llama", config, specs, params)
    corpus = str(tmp_path / "corpus.npy")
    np.save(corpus, data.synthetic_tokens(config.vocab_size, 5 * SEQLEN, 1))
    res = subprocess.run(
        [sys.executable, "-m", "squeezellm_tpu_torch", "eval", "--model",
         ckpt, "--device", "cpu", "--dataset", corpus, "--seqlen",
         str(SEQLEN), "--nsamples", "4", "--group", "3"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    model = carry.from_tree("llama", dataclasses.asdict(config),
                            _module_meta(specs), params, "cpu")
    want = eval_mod.perplexity(model, np.load(corpus)[None], seqlen=SEQLEN,
                               nsamples=4, group=3)
    assert got["seqlen"] == SEQLEN
    assert got["ppl"] == pytest.approx(want, rel=1e-6)
