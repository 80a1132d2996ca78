"""K10 (structured-codebook LUT matmul), K11 (transposed 4-bit GEMV) and
K12 (standalone CSR sparse sum): their plain PyTorch versions against the
JAX package's Pallas kernels in interpret mode (``lut_matmul`` with
``lut_t_struct``, ``lut_matmul_t``, ``gather_spmv`` on classic and grouped
slot plans, and ``spmv.reference_apply``), the routing of
``quant_linear_apply`` against the JAX package's with the same decode
tables attached, and the greedy tokens of a tiny structured model and a
transposed one against the JAX engine's.

Tolerances (max |dy| / max |y|): exact mode 1e-5. bf16 mode against the
interpreter 2e-2: the port rounds x and the dequantized W to bf16 before
the products, as the TPU's one-pass MXU does, while the CPU interpreter
leaves W unrounded (one bf16 step is 2**-9 of a weight); against the
interpreter fed the same rounded operands, 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from squeezellm_tpu import engine as jengine
from squeezellm_tpu import formats as jformats
from squeezellm_tpu.models import fuse as jfuse
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.models.common import LinearSpec as JLinearSpec
from squeezellm_tpu.ops import pallas_ops, spmv as jspmv
from squeezellm_tpu.ops import quant_linear as jql
from squeezellm_tpu.quantize import kmeans as jkmeans
from squeezellm_tpu_torch import carry, engine
from squeezellm_tpu_torch.models import fuse
from squeezellm_tpu_torch.ops import lut_matmul, lut_matmul_t, spmv

EXACT, BF16_INTERP = 1e-5, 2e-2
OUT_F, IN_F = 128, 116  # the last packed word is partial


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _structured_lut(rng, out_f):
    """bench.py's structured statistics: lut = [A, A + d]."""
    a = np.sort(rng.standard_normal((out_f, 8)).astype(np.float32) * 0.02,
                axis=1)
    d = (np.abs(rng.standard_normal((out_f, 1))) * 0.01 + 0.005).astype(
        np.float32)
    return np.concatenate([a, a + d], axis=1)


def _qweight(rng, in_f, out_f, bits=4):
    return rng.integers(-2**31, 2**31, (jformats.n_words(in_f, bits), out_f),
                        dtype=np.int64).astype(np.int32)


def _struct_table(lut):
    """A, d and the JAX package's (16, out) table of them (A^T in rows 0-7,
    d / 8 in row 8), as its attach_decode_luts builds it."""
    a, d = jkmeans.structured_decomposition(lut)
    st = np.zeros((16, lut.shape[0]), np.float32)
    st[0:8], st[8] = a.T, d / 8.0
    return a, d, st


@pytest.mark.parametrize("M", [1, 5, 16, 40])
def test_k10_plain_matches_pallas_structured(M):
    rng = np.random.default_rng(M)
    lut = _structured_lut(rng, OUT_F)
    a, d, st = _struct_table(lut)
    qw = _qweight(rng, IN_F, OUT_F)
    x = rng.standard_normal((M, IN_F)).astype(np.float32)
    y0 = rng.standard_normal((M, OUT_F)).astype(np.float32)
    for mode, jmode, tol in (("exact", "gather", EXACT),
                             ("bf16", "bf16", BF16_INTERP)):
        got = lut_matmul.lut_matmul_struct(_t(x), _t(qw), _t(a), _t(d),
                                           y0=_t(y0), mode=mode)
        want = pallas_ops.lut_matmul(
            jnp.asarray(x), jnp.asarray(qw), jnp.asarray(lut), 4,
            interpret=True, mode=jmode, lut_t_struct=jnp.asarray(st),
            y0=jnp.asarray(y0))
        assert _rel(got, want) <= tol, (mode, _rel(got, want))
    # bf16 mode is exact f32 arithmetic on bf16-rounded x and W
    got = lut_matmul.lut_matmul_struct(_t(x), _t(qw), _t(a), _t(d),
                                       y0=_t(y0), mode="bf16")
    want = pallas_ops.lut_matmul(
        jnp.asarray(_bf16(x)), jnp.asarray(qw),
        jnp.asarray(_bf16(np.concatenate([a, a + d[:, None]], 1))), 4,
        interpret=True, mode="gather", y0=jnp.asarray(y0))
    assert _rel(got, want) <= EXACT


@pytest.mark.parametrize("M", [1, 3, 8])
def test_k11_plain_matches_pallas_transposed(M):
    rng = np.random.default_rng(10 + M)
    lut = np.sort(rng.standard_normal((OUT_F, 16)).astype(np.float32), 1)
    qw = _qweight(rng, IN_F, OUT_F)
    qwt = np.ascontiguousarray(qw.T)
    x = rng.standard_normal((M, IN_F)).astype(np.float32)

    def pallas(xx, table, mode):
        return pallas_ops.lut_matmul_t(
            jnp.asarray(xx), jnp.asarray(qwt),
            jnp.asarray(pallas_ops.wide_lut(table, 4)), 4, interpret=True,
            mode=mode)

    for mode, jmode, tol in (("exact", "gather", EXACT),
                             ("bf16", "bf16", BF16_INTERP)):
        got = lut_matmul_t.lut_matmul_t(_t(x), _t(qwt), _t(lut), mode=mode)
        assert got.shape == (M, OUT_F)
        assert _rel(got, pallas(x, lut, jmode)) <= tol, mode
    # fed a bf16-rounded table, the interpreter's bf16 mode (which rounds x)
    # computes what the port's bf16 mode does
    got = lut_matmul_t.lut_matmul_t(_t(x), _t(qwt), _t(lut), mode="bf16")
    assert _rel(got, pallas(x, _bf16(lut), "bf16")) <= EXACT


def _coo(rng, out_f, in_f, density=0.03):
    dense = np.zeros((out_f, in_f), np.float32)
    mask = rng.random((out_f, in_f)) < density
    dense[mask] = rng.standard_normal(mask.sum()).astype(np.float32)
    dense[3] = 0  # an empty row
    return jformats.SparseCOO.from_dense(dense, pad_multiple=64)


@pytest.mark.parametrize("B", [1, 3, 40])
def test_k12_plain_matches_gather_spmv(B):
    """K12's plain version on the CSR sidecar against gather_spmv on a
    classic slot plan and on a grouped plan's meta (which the interpreter
    runs through the classic kernel), and against reference_apply."""
    rng = np.random.default_rng(B)
    coo = _coo(rng, OUT_F, IN_F)
    rowptr, cols, vals = carry.csr_from_coo(coo.rows, coo.cols, coo.vals,
                                            OUT_F, IN_F)
    x = rng.standard_normal((B, IN_F)).astype(np.float32)
    got = spmv.spmv(_t(x), _t(rowptr), _t(cols), _t(vals), OUT_F)
    assert got.shape == (B, OUT_F)
    plans = (jspmv.build_plan(coo.rows, coo.cols, coo.vals, OUT_F, IN_F),
             jspmv.build_plan_grouped(coo.rows, coo.cols, coo.vals, OUT_F,
                                      IN_F))
    assert plans[1].groups is not None
    for plan in plans:
        want = pallas_ops.gather_spmv(
            jnp.asarray(x), jnp.asarray(plan.meta), jnp.asarray(plan.vals),
            oh=plan.oh, ih=plan.ih, out_features=OUT_F, interpret=True,
            groups=None if plan.groups is None else jnp.asarray(plan.groups))
        assert _rel(got, want) <= EXACT
        ref = np.stack([jspmv.reference_apply(plan, x[b]) for b in range(B)])
        assert _rel(got, ref) <= EXACT
    assert np.all(got[:, 3].numpy() == 0)


def test_k12_plain_takes_crowded_rows_a_block_at_a_time(monkeypatch):
    """A sensitivity-ranked sidecar can crowd half a row's inputs into one
    CSR row; the plain sum then walks the (out, widest row) grid a block of
    rows at a time, with the same sums bit for bit."""
    from squeezellm_tpu_torch.ops import plain_ops

    rng = np.random.default_rng(9)
    dense = np.zeros((OUT_F, IN_F), np.float32)
    dense[5, : IN_F // 2] = rng.standard_normal(IN_F // 2)  # one crowded row
    mask = rng.random((OUT_F, IN_F)) < 0.02
    dense[mask] = rng.standard_normal(mask.sum()).astype(np.float32)
    coo = jformats.SparseCOO.from_dense(dense, pad_multiple=64)
    csr = [_t(a) for a in carry.csr_from_coo(coo.rows, coo.cols, coo.vals,
                                             OUT_F, IN_F)]
    x = _t(rng.standard_normal((40, IN_F)).astype(np.float32))
    whole = spmv.spmv_plain(x, *csr, OUT_F)
    monkeypatch.setattr(plain_ops, "SPARSE_SCRATCH", 40 * 58 * 7)
    assert torch.equal(spmv.spmv_plain(x, *csr, OUT_F), whole)
    np.testing.assert_allclose(whole.numpy(), x.numpy() @ dense.T,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("y0_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_k12_fold_is_the_composition_bit_for_bit(B, y0_dtype):
    """K12's accumulate form, y = (y + y0) + sum in place, is the
    transposed route's two adds in their order, bit for bit: through the
    plain version and through the wrapper on CPU tensors."""
    rng = np.random.default_rng(30 + B)
    coo = _coo(rng, OUT_F, IN_F)
    csr = [_t(a) for a in carry.csr_from_coo(coo.rows, coo.cols, coo.vals,
                                             OUT_F, IN_F)]
    x = _t(rng.standard_normal((B, IN_F)).astype(np.float32))
    y = _t(rng.standard_normal((B, OUT_F)).astype(np.float32))
    y0 = (None if y0_dtype is None else
          _t(rng.standard_normal((B, OUT_F)).astype(np.float32)).to(y0_dtype))
    want = y if y0 is None else y + y0.float()
    want = want + spmv.spmv_plain(x, *csr, OUT_F)
    for fn in (spmv.spmv_plain, spmv.spmv):
        acc = y.clone()
        got = fn(x, *csr, OUT_F, y=acc, y0=y0)
        assert got is acc
        assert torch.equal(got, want), fn.__name__


@pytest.mark.parametrize("with_y0", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_transposed_route_matches_lut_matmul_t_and_gather_spmv(rows,
                                                               with_y0):
    """The port's transposed route (K11, then y0 and K12's sum folded in
    K12's launch) against the JAX package's: lut_matmul_t, + y0, then
    gather_spmv on a slot plan, both Pallas kernels in interpret mode."""
    rng = np.random.default_rng(40 + rows)
    lut = np.sort(rng.standard_normal((OUT_F, 16)).astype(np.float32), 1)
    coo = _coo(rng, OUT_F, IN_F, 0.02)
    p = {"qweight": _qweight(rng, IN_F, OUT_F), "lut": lut,
         "sp_rows": coo.rows, "sp_cols": coo.cols, "sp_vals": coo.vals}
    spec, jp = jspmv.attach_plan(
        jql.QuantLinearSpec(bits=4, in_features=IN_F, out_features=OUT_F,
                            nnz_pad=len(coo.vals)), p)
    assert spec.sg_rows > 0
    jp.update(qweight_t=np.ascontiguousarray(p["qweight"].T),
              lut_w=np.asarray(pallas_ops.wide_lut(lut, 4)))
    lin = carry.linear_from_tree(IN_F, {"quant": True, "bits": 4}, p, "cpu")
    holder = torch.nn.Module()
    holder.lin = lin
    fuse.attach_decode_luts(holder, transposed=True)
    assert "qweight_t" in lin.tensors()
    x = rng.standard_normal((rows, IN_F)).astype(np.float32)
    y0 = (rng.standard_normal((rows, OUT_F)).astype(np.float32) if with_y0
          else None)
    before = spmv.spmv.launches
    got = lin(_t(x), y0=None if y0 is None else _t(y0))
    assert spmv.spmv.launches == before  # CPU tensors: the plain version
    want = jql.quant_linear_apply(
        spec, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
        backend="pallas", y0=None if y0 is None else jnp.asarray(y0))
    assert _rel(got, want) <= EXACT


@pytest.mark.parametrize("bad", ["y0 without y", "y dtype", "y shape",
                                 "y0 shape", "y0 dtype", "y strided"])
def test_spmv_refuses_a_wrong_accumulator(bad):
    B = 3
    rowptr = torch.zeros(OUT_F + 1, dtype=torch.int32)
    cols, vals = torch.zeros(0, dtype=torch.int32), torch.zeros(0)
    x = torch.zeros(B, IN_F)
    y, y0 = torch.zeros(B, OUT_F), torch.zeros(B, OUT_F)
    kw = {"y0 without y": dict(y0=y0),
          "y dtype": dict(y=y.bfloat16()),
          "y shape": dict(y=torch.zeros(B + 1, OUT_F)),
          "y0 shape": dict(y=y, y0=torch.zeros(B, OUT_F - 1)),
          "y0 dtype": dict(y=y, y0=y0.double()),
          "y strided": dict(y=torch.zeros(OUT_F, B).t())}[bad]
    with pytest.raises(ValueError):
        spmv.spmv(x, rowptr, cols, vals, OUT_F, **kw)


@pytest.mark.parametrize("in_f,density,want", [
    (4096, 0.0045, 8), (11008, 0.0045, 16), (4096, 0.02, 32),
    (4096, 0.0, 8)])
def test_k12_lanes_a_row_follow_the_sidecar_shape(in_f, density, want):
    """G lanes a CSR row from the mean row length: 8 for LLaMA-2-7B's
    4096-input sidecars at 0.45%, 16 for down's 11008 inputs, 32 for
    denser rows; the batch tile is fixed by B alone."""
    out_f = 4096
    assert spmv.group_size(int(out_f * in_f * density), out_f) == want
    assert [spmv.tile_rows(b) for b in (1, 2, 3, 4, 5, 8, 9, 1023)] == [
        1, 2, 4, 4, 8, 8, 8, 8]


def test_wrappers_refuse_on_the_cpu_what_the_card_refuses():
    x = torch.zeros(9, IN_F)
    qwt = torch.zeros(OUT_F, jformats.n_words(IN_F, 4), dtype=torch.int32)
    lut = torch.zeros(OUT_F, 16)
    with pytest.raises(ValueError):  # K11 takes at most 8 rows
        lut_matmul_t.lut_matmul_t(x, qwt, lut)
    with pytest.raises(ValueError):  # int64 words
        lut_matmul_t.lut_matmul_t(x[:2], qwt.long(), lut)
    with pytest.raises(ValueError):  # K10: A must be (out, 8)
        lut_matmul.lut_matmul_struct(x, qwt.t().contiguous(), lut,
                                     torch.zeros(OUT_F))
    rowptr = torch.zeros(OUT_F + 1, dtype=torch.int32)
    cols = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError):  # K12: 1..1023 rows
        spmv.spmv(torch.zeros(1024, IN_F), rowptr, cols, torch.zeros(0),
                  OUT_F)


def _jax_linear(rng, sparse=True, topx=2):
    lut = _structured_lut(rng, OUT_F)
    p = {"qweight": _qweight(rng, IN_F, OUT_F), "lut": lut,
         "bias": rng.standard_normal(OUT_F).astype(np.float32)}
    nnz_pad = 0
    if sparse:
        coo = _coo(rng, OUT_F, IN_F, 0.02)
        p.update(sp_rows=coo.rows, sp_cols=coo.cols, sp_vals=coo.vals)
        nnz_pad = len(coo.vals)
    p["topx_weights"] = rng.standard_normal((IN_F, topx)).astype(np.float32)
    p["topx_indices"] = rng.choice(OUT_F, topx, replace=False).astype(
        np.int32)
    q = jql.QuantLinearSpec(bits=4, in_features=IN_F, out_features=OUT_F,
                            has_bias=True, nnz_pad=nnz_pad, topx=topx)
    return JLinearSpec(in_features=IN_F, out_features=OUT_F, has_bias=True,
                       quant=q), p


@pytest.mark.parametrize("rows", [1, 8, 9, 40])
def test_quant_linear_routes_as_the_jax_package(rows):
    """A structured linear with transposed words attached in both packages:
    <= 8 rows take K11 + K12 (lut_matmul_t + gather_spmv), more rows K10
    (the structured lut_matmul); exact mode."""
    rng = np.random.default_rng(rows)
    spec, p = _jax_linear(rng)
    jspecs, jparams = jfuse.attach_decode_luts(
        {"layers": ({"q": spec},)}, {"layers": [{"q": p}]}, transposed=True)
    jspec, jp = jspecs["layers"][0]["q"], jparams["layers"][0]["q"]
    assert "lut_t_struct" in jp and "qweight_t" in jp
    meta = {"quant": True, "bits": 4, "has_bias": True, "topx": 2}
    lin = carry.linear_from_tree(IN_F, meta, p, "cpu")
    holder = torch.nn.Module()
    holder.lin = lin
    fuse.attach_decode_luts(holder, transposed=True)
    x = rng.standard_normal((rows, IN_F)).astype(np.float32)
    y0 = rng.standard_normal((rows, OUT_F)).astype(np.float32)
    got = lin(_t(x), y0=_t(y0))
    want = jql.quant_linear_apply(
        jspec.quant, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
        backend="pallas", y0=jnp.asarray(y0))
    assert _rel(got, want) <= EXACT


CONFIG = jllama.LlamaConfig(vocab_size=64, hidden_size=64,
                            intermediate_size=96, n_layers=1, n_heads=4,
                            n_kv_heads=2, max_seq=32)
PROMPT = np.array([[3, 41, 59, 26, 5]], np.int32)


def _structured_tree(seed=0):
    rng = np.random.default_rng(seed)
    h = CONFIG.hidden_size
    spec_layer, layer = {}, {}
    for name, (o, i) in CONFIG.linear_shapes().items():
        dense = np.zeros((o, i), np.float32)
        mask = rng.random((o, i)) < 0.02
        dense[mask] = rng.standard_normal(mask.sum()).astype(np.float32) * .3
        coo = jformats.SparseCOO.from_dense(dense, pad_multiple=64)
        layer[name] = {"qweight": _qweight(rng, i, o),
                       "lut": _structured_lut(rng, o) * 5,
                       "sp_rows": coo.rows, "sp_cols": coo.cols,
                       "sp_vals": coo.vals}
        spec_layer[name] = JLinearSpec(
            in_features=i, out_features=o,
            quant=jql.QuantLinearSpec(bits=4, in_features=i, out_features=o,
                                      nnz_pad=len(coo.vals)))
    layer["input_norm"] = np.ones(h, np.float32)
    layer["post_norm"] = np.ones(h, np.float32)
    head = {"qweight": _qweight(rng, h, CONFIG.vocab_size),
            "lut": _structured_lut(rng, CONFIG.vocab_size) * 5}
    head_spec = JLinearSpec(
        in_features=h, out_features=CONFIG.vocab_size,
        quant=jql.QuantLinearSpec(bits=4, in_features=h,
                                  out_features=CONFIG.vocab_size))
    params = {"embed": rng.standard_normal((CONFIG.vocab_size, h)).astype(
        np.float32), "layers": [layer],
        "final_norm": np.ones(h, np.float32), "lm_head": head}
    return {"layers": (spec_layer,), "lm_head": head_spec}, params


@pytest.mark.parametrize("transposed", [False, True])
def test_structured_and_transposed_models_match_the_jax_engine(transposed):
    """A tiny structured model, fused: decode through K10 (and prefill,
    under 1024 rows), or with transposed words through K11 + K12 (every
    call has <= 8 rows); greedy tokens equal the JAX engine's on the
    Pallas path with the same tables."""
    specs, params = _structured_tree()
    jspecs, jparams = jfuse.fuse_for_decode("llama", specs, params)
    if transposed:
        # the JAX attach adds tables only to a linear without 'lut_t', which
        # fuse_for_decode's own attach has given every one
        for layer in jparams["layers"]:
            for name in ("qkv", "o", "gateup", "down"):
                layer[name] = {k: v for k, v in layer[name].items()
                               if not k.startswith("lut_t")}
        jspecs, jparams = jfuse.attach_decode_luts(jspecs, jparams,
                                                   transposed=True)
    assert all(("qweight_t" in p) == transposed and "lut_t_struct" in p
               for p in (jparams["layers"][0][n] for n in ("qkv", "gateup")))
    eng = jengine.Engine("llama", CONFIG, jspecs,
                         jax.tree.map(jnp.asarray, jparams),
                         backend="pallas")
    want = eng.generate(PROMPT, 6)

    meta = {f"0.{n}": {"quant": True, "bits": 4, "has_bias": False,
                       "topx": 0} for n in CONFIG.linear_shapes()}
    meta["lm_head"] = {"quant": True, "bits": 4, "has_bias": False,
                       "topx": 0}
    model = carry.from_tree("llama", CONFIG.__dict__, meta, params, "cpu")
    fuse.attach_decode_luts(fuse.fuse_for_decode(model),
                            transposed=transposed)
    lins = fuse.quant_linears(model)
    assert all("struct_a" in m.tensors() for m in lins)
    assert all(("qweight_t" in m.tensors()) == transposed for m in lins)
    got = engine.Engine(model).generate(PROMPT, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
