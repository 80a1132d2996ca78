"""The port's quantized linear (K1's plain version + top-X + bias + y0) and
plain_ops against the JAX package: Pallas `lut_matmul` in interpret mode
(with and without SpMV slot plans) through `quant_linear_apply`, and
`xla_ops`. Inputs from a seeded numpy generator go to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from squeezellm_tpu import formats as jformats
from squeezellm_tpu.ops import quant_linear as jql
from squeezellm_tpu.ops import spmv, xla_ops
from squeezellm_tpu_torch import carry, formats
from squeezellm_tpu_torch.ops import lut_matmul as tlm
from squeezellm_tpu_torch.ops import plain_ops
from squeezellm_tpu_torch.ops import quant_linear as tql

OUT_F, IN_F = 128, 116  # the last packed word is partial at bits 3 and 4
TOL = {"exact": 1e-5, "bf16": 1e-4}  # max |dy| / max |y|


def _random_linear(rng, bits, topx=3, bias=True):
    """JAX-format params: garbage in every unused code slot of qweight, a
    COO sidecar with zero padding at the end, top-X channels, a bias."""
    nw = jformats.n_words(IN_F, bits)
    p = {
        "qweight": rng.integers(-2**31, 2**31, (nw, OUT_F),
                                dtype=np.int64).astype(np.int32),
        "lut": np.sort(rng.standard_normal((OUT_F, 2**bits))
                       .astype(np.float32), axis=1),
    }
    dense = np.zeros((OUT_F, IN_F), np.float32)
    mask = rng.random((OUT_F, IN_F)) < 0.02
    dense[mask] = rng.standard_normal(mask.sum()).astype(np.float32)
    coo = jformats.SparseCOO.from_dense(dense, pad_multiple=64)
    assert coo.nnz < len(coo.vals)  # padding present
    p.update(sp_rows=coo.rows, sp_cols=coo.cols, sp_vals=coo.vals)
    p["topx_weights"] = rng.standard_normal((IN_F, topx)).astype(np.float32)
    p["topx_indices"] = rng.choice(OUT_F, topx, replace=False).astype(np.int32)
    if bias:
        p["bias"] = rng.standard_normal(OUT_F).astype(np.float32)
    spec = jql.QuantLinearSpec(bits=bits, in_features=IN_F,
                               out_features=OUT_F, has_bias=bias,
                               nnz_pad=len(coo.vals), topx=topx)
    return spec, p


def _port_linear(spec, p):
    meta = {"quant": True, "bits": spec.bits, "has_bias": spec.has_bias,
            "topx": spec.topx}
    return carry.linear_from_tree(IN_F, meta, p, "cpu")


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / np.max(np.abs(np.asarray(b))))


@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("M", [1, 16, 40])
@pytest.mark.parametrize("bits", [3, 4])
def test_quant_linear_matches_pallas(bits, M, mode):
    """sparse + topX + bias + y0 at M rows; the JAX side runs with the
    slot plans (fused sparse GEMV up to 16 rows, gather_spmv above) and
    without them (XLA sparse add)."""
    rng = np.random.default_rng(100 * bits + M)
    spec, p = _random_linear(rng, bits)
    x = rng.standard_normal((M, IN_F)).astype(np.float32)
    y0 = rng.standard_normal((M, OUT_F)).astype(np.float32)
    backend = "pallas-bf16" if mode == "bf16" else "pallas"

    lin = _port_linear(spec, p)
    got = lin(torch.from_numpy(x), mode=mode, y0=torch.from_numpy(y0))
    assert got.dtype == torch.float32 and got.shape == (M, OUT_F)

    pspec, pp = spmv.attach_plan(spec, p)
    for s, params in ((spec, p), (pspec, pp)):
        want = jql.quant_linear_apply(
            s, {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(x), backend=backend, y0=jnp.asarray(y0))
        assert _rel(got, want) <= TOL[mode], (s.sg_rows, _rel(got, want))


@pytest.mark.parametrize("bits", [3, 4])
def test_plain_ops_match_xla_ops(bits):
    rng = np.random.default_rng(7 + bits)
    spec, p = _random_linear(rng, bits)
    x = rng.standard_normal((5, IN_F)).astype(np.float32)
    qw, lut = torch.from_numpy(p["qweight"]), torch.from_numpy(p["lut"])

    w = plain_ops.dequantize(qw, lut, bits, IN_F)
    w_want = xla_ops.dequantize(jnp.asarray(p["qweight"]),
                                jnp.asarray(p["lut"]), bits, IN_F)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_want))

    y = plain_ops.lut_matmul(torch.from_numpy(x), qw, lut, bits)
    y_want = xla_ops.lut_matmul(jnp.asarray(x), jnp.asarray(p["qweight"]),
                                jnp.asarray(p["lut"]), bits)
    assert _rel(y, y_want) <= 1e-5

    rowptr, cols, vals = carry.csr_from_coo(p["sp_rows"], p["sp_cols"],
                                            p["sp_vals"], OUT_F, IN_F)
    ys = plain_ops.sparse_matmul(torch.from_numpy(x), torch.from_numpy(rowptr),
                                 torch.from_numpy(cols),
                                 torch.from_numpy(vals), OUT_F)
    ys_want = xla_ops.sparse_matmul(jnp.asarray(x), jnp.asarray(p["sp_rows"]),
                                    jnp.asarray(p["sp_cols"]),
                                    jnp.asarray(p["sp_vals"]), OUT_F)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_want), rtol=1e-5,
                               atol=1e-5)

    yh = plain_ops.hybrid_matmul(torch.from_numpy(x),
                                 torch.from_numpy(p["topx_weights"]),
                                 torch.from_numpy(p["topx_indices"]), OUT_F)
    yh_want = xla_ops.hybrid_matmul(jnp.asarray(x),
                                    jnp.asarray(p["topx_weights"]),
                                    jnp.asarray(p["topx_indices"]), OUT_F)
    np.testing.assert_allclose(yh.numpy(), np.asarray(yh_want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_unpack_codes_matches_jax_formats(bits):
    rng = np.random.default_rng(bits)
    words = rng.integers(-2**31, 2**31, (formats.n_words(IN_F, bits), 9),
                         dtype=np.int64).astype(np.int32)
    got = formats.unpack_codes(torch.from_numpy(words), bits, IN_F)
    np.testing.assert_array_equal(got.numpy(),
                                  jformats.unpack_codes(words, bits, IN_F))
    assert formats.CODES_PER_WORD == jformats.CODES_PER_WORD


def test_csr_drops_padding_and_sorts_stably():
    rows = np.array([3, 1, 3, 1, 0, 0], np.int32)
    cols = np.array([5, 2, 1, 7, 0, 0], np.int32)
    vals = np.array([1.0, 2.0, 3.0, 4.0, 0.0, 0.0], np.float32)  # 2 pads
    rowptr, c, v = carry.csr_from_coo(rows, cols, vals, 4, 8)
    np.testing.assert_array_equal(rowptr, [0, 0, 2, 2, 4])
    np.testing.assert_array_equal(c, [2, 7, 5, 1])
    np.testing.assert_array_equal(v, [2.0, 4.0, 1.0, 3.0])
    with pytest.raises(ValueError):
        carry.csr_from_coo(np.array([4]), np.array([0]), np.array([1.0]), 4, 8)


@pytest.mark.parametrize("rows", [[], [2], [0, 0, 0, 0, 0, 3], [1, 3, 3]])
def test_sparse_matmul_sums_each_csr_row(rows):
    """Empty rows, one crowded row and an empty sidecar, against a loop."""
    rng = np.random.default_rng(len(rows))
    x = rng.standard_normal((3, 8)).astype(np.float32)
    cols = rng.integers(0, 8, len(rows)).astype(np.int32)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    rowptr, c, v = carry.csr_from_coo(np.array(rows, np.int32), cols, vals,
                                      4, 8)
    got = plain_ops.sparse_matmul(torch.from_numpy(x), torch.from_numpy(rowptr),
                                  torch.from_numpy(c), torch.from_numpy(v), 4)
    want = np.zeros((3, 4), np.float32)
    for r, col, val in zip(rows, cols, vals):
        want[:, r] += val * x[:, col]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_lut_matmul_wrapper_takes_plain_path_on_cpu():
    """On a CPU tensor the wrapper is its plain version and launches
    nothing."""
    rng = np.random.default_rng(3)
    spec, p = _random_linear(rng, 4)
    x = torch.from_numpy(rng.standard_normal((2, IN_F)).astype(np.float32))
    before = tlm.lut_matmul.launches
    args = (x, torch.from_numpy(p["qweight"]), torch.from_numpy(p["lut"]), 4)
    torch.testing.assert_close(tlm.lut_matmul(*args, mode="bf16"),
                               tlm.lut_matmul_plain(*args, mode="bf16"),
                               rtol=0, atol=0)
    assert tlm.lut_matmul.launches == before
    with pytest.raises(ValueError):
        tql.quant_linear_apply(
            tql.QuantLinearSpec(bits=4, in_features=IN_F, out_features=OUT_F),
            {"qweight": args[1], "lut": args[2]}, x, mode="f16")


@pytest.mark.parametrize("M,mode,variant,want", [
    (1, "bf16", None, "mma"), (8, "bf16", None, "mma"),
    (9, "bf16", None, "mma"), (16, "bf16", None, "mma"),
    (40, "bf16", None, "mma"), (1023, "bf16", None, "mma"),
    (1, "bf16", "gemv", "gemv"), (12, "bf16", "gemv", "gemv"),
    (40, "bf16", "gemv", "gemv"), (1, "exact", None, "gemv"),
    (40, "exact", None, "gemv"), (1023, "exact", None, "gemv"),
    (1, "bf16", "dec", "dec"), (8, "bf16", "dec", "dec"),
    (9, "bf16", "dec", "dec"), (16, "bf16", "dec", "dec"),
    (17, "bf16", "dec", "dec"), (1023, "bf16", "dec", "dec")])
def test_k1_plan_picks_the_kernel_by_rows_and_mode(M, mode, variant, want):
    """The mode's kernel whatever the row count (the prefill tensor-core
    kernel in bf16 mode, the GEMV in 16-row tiles in exact mode), and the
    decode tensor-core kernel (one n8 tile of rows up to 8, two from 9)
    or the GEMV in bf16 mode at any row count when the call site (a
    decode step) asks for it: the row count picks no kernel."""
    p = tlm.plan(M, 4096, 4096, 4, mode, variant)
    assert p.variant == want
    if want == "gemv":
        assert p.row_tile == min(16, 1 << (M - 1).bit_length())
    elif want == "dec":
        assert p.row_tile == (8 if M <= 8 else 16)
    else:
        assert p.row_tile == tlm.MMA_ROW_TILE


@pytest.mark.parametrize("variant", ["gemv", "mma", "dec"])
@pytest.mark.parametrize("M", [1, 8, 40, 1023])
@pytest.mark.parametrize("in_f,out_f,bits", [
    (4096, 12288, 4), (4096, 4096, 4), (4096, 22016, 4), (11008, 4096, 4),
    (4096, 32000, 3), (116, 203, 3), (7, 9, 4)])
def test_k1_plan_splits_cover_the_words(in_f, out_f, bits, M, variant):
    """The k-split covers every packed word row once, in word tiles of 8,
    with no empty split, and the 4096-wide outputs get several blocks a
    column tile at one row."""
    p = tlm.plan(M, in_f, out_f, bits, "bf16", variant)
    nw = formats.n_words(in_f, bits)
    assert p.words_per_split % 8 == 0
    assert (p.splits - 1) * p.words_per_split < nw <= (
        p.splits * p.words_per_split)
    col_tiles = -(-out_f // tlm.COLS)
    assert p.tiles == col_tiles * -(-M // p.row_tile)
    if variant in ("gemv", "dec") and M == 1 and out_f == 4096:
        assert p.splits >= {"gemv": 8, "dec": 4}[variant]
    if variant in ("gemv", "dec"):  # a row's order ignores the batch
        one = tlm.plan(1, in_f, out_f, bits, "bf16", variant)
        assert (p.splits, p.words_per_split, p.folds) == (
            one.splits, one.words_per_split, one.folds)


FLAGSHIP = ((4096, 12288, 4), (4096, 4096, 4), (4096, 22016, 4),
            (11008, 4096, 4), (4096, 32000, 4))


@pytest.mark.parametrize("variant", ["mma", "dec"])
@pytest.mark.parametrize("in_f,out_f,bits", FLAGSHIP + (
    (4096, 6144, 4), (4096, 28672, 4), (14336, 4096, 4), (4096, 32000, 3),
    (2056, 260, 4)))
def test_k1_plan_mma_split_is_fixed_per_shape(in_f, out_f, bits, variant):
    """At the LLaMA-2-7B and Mistral-7B shapes each tensor-core kernel
    splits the words the same way at every row count from 1 to 1023, so a
    row is summed in one order whether it is prefilled (decoded) alone or
    in a cohort. The prefill kernel's partials' workspace stays within 3
    (M, out) planes and a sidecar's fold; the decode kernel's, with or
    without a sidecar, is never larger than the GEMV's at the same rows."""
    first = tlm.plan(1, in_f, out_f, bits, "bf16", variant)
    gemv = tlm.plan(1, in_f, out_f, bits, "bf16", "gemv")
    for M in range(2, tlm.MAX_ROWS + 1):
        p = tlm.plan(M, in_f, out_f, bits, "bf16", variant)
        assert (p.splits, p.words_per_split, p.folds) == (
            first.splits, first.words_per_split, first.folds), M
        assert p.tiles == -(-out_f // tlm.COLS) * -(-M // p.row_tile)
    if variant == "mma":
        assert first.splits <= 5
    else:  # (folds + splits, M, out) f32, and a plane or none without one
        assert first.folds + first.splits <= gemv.folds + gemv.splits
        assert first.splits <= gemv.splits


def test_quant_linear_picks_the_kernel_by_call_site(monkeypatch):
    """The model's decode step (one token a slot, at 1 or 12 slots, and a
    one-token prompt, which runs as one) asks K1 for the GEMV; a prompt,
    a cohort's prefill and a full forward leave the mode's kernel (the
    tensor cores in bf16 mode) at every row count."""
    from squeezellm_tpu_torch import engine, synthetic
    from squeezellm_tpu_torch.models import fuse, llama

    calls = []
    inner = tql.lut_matmul

    def spy(x, *args, variant=None, **kw):
        calls.append((x.shape[0], variant))
        return inner(x, *args, variant=variant, **kw)

    monkeypatch.setattr(tql, "lut_matmul", spy)
    cfg = llama.LlamaConfig(vocab_size=64, hidden_size=64,
                            intermediate_size=96, n_layers=1, n_heads=2,
                            n_kv_heads=1, max_seq=32)
    model = fuse.fuse_for_decode(synthetic.quantized_llama(
        cfg, 4, sparsity=0.02, topx=2, device="cpu"))
    eng = engine.Engine(model, dtype=torch.bfloat16,
                        cache_dtype=torch.bfloat16, mode="bf16")
    kw = dict(dtype=torch.bfloat16, mode="bf16")

    def run(fn):
        calls.clear()
        with torch.no_grad():
            fn()
        return set(calls)

    cache = eng.new_cache(12)
    assert run(lambda: model.prefill(torch.ones(12, 5, dtype=torch.long),
                                     cache, **kw)) == {(12, None), (60, None)}
    assert run(lambda: model.decode_step(
        torch.ones(12, 1, dtype=torch.long), 5, cache, **kw)) == {
            (12, "dec")}
    assert run(lambda: model.prefill(torch.ones(1, 1, dtype=torch.long),
                                     eng.new_cache(1), **kw)) == {
        (1, "dec")}
    assert run(lambda: model.forward(torch.ones(1, 9, dtype=torch.long),
                                     **kw)) == {(9, None)}
    assert run(lambda: eng.generate(np.ones((1, 7), np.int64), 2)) == {
        (1, None), (1, "dec"), (7, None)}
    # exact mode: the mode's kernel, the GEMV, at every call
    exact = engine.Engine(model)
    assert run(lambda: model.decode_step(
        torch.ones(12, 1, dtype=torch.long), 5, exact.new_cache(12))) == {
            (12, None)}
    assert run(lambda: exact.generate(np.ones((1, 7), np.int64), 2)) == {
        (1, None), (7, None)}


def test_k1_wrappers_refuse_a_variant_on_the_cpu():
    """A CPU tensor meets the refusals a CUDA tensor would: an unknown
    kernel, and the tensor-core kernel in exact mode."""
    rng = np.random.default_rng(4)
    spec, p = _random_linear(rng, 4)
    x = torch.zeros(20, IN_F)
    qw, lut = torch.from_numpy(p["qweight"]), torch.from_numpy(p["lut"])
    a, d = lut[:, :8].contiguous(), lut[:, 8].contiguous()
    with pytest.raises(ValueError, match="variant"):
        tlm.lut_matmul(x, qw, lut, 4, mode="bf16", variant="wgmma")
    with pytest.raises(ValueError, match="bf16 mode only"):
        tlm.lut_matmul(x, qw, lut, 4, mode="exact", variant="mma")
    with pytest.raises(ValueError, match="bf16 mode only"):
        tlm.lut_matmul_struct(x, qw, a, d, mode="exact", variant="mma")
    for fn, tables in ((tlm.lut_matmul, (lut, 4)),
                       (tlm.lut_matmul_struct, (a, d))):
        with pytest.raises(ValueError, match="bf16 mode only"):
            fn(x, qw, *tables, mode="exact", variant="dec")
    # the plain version stands in for any kernel on the CPU
    for variant in ("gemv", "mma", "dec", None):
        torch.testing.assert_close(
            tlm.lut_matmul(x, qw, lut, 4, mode="bf16", variant=variant),
            tlm.lut_matmul_plain(x, qw, lut, 4, mode="bf16"), rtol=0, atol=0)
