"""K1-K12 on the card against their plain PyTorch versions, at ragged small
shapes the full-width smoke run does not reach (column and row tails,
partial packed words, GQA groups, head dims 32/64/128, strided inputs,
unaligned int8 caches, small pages, shared and shuffled page tables, odd
row counts of the transposed GEMV and the sparse sum), the routing of
``quant_linear_apply`` between K1, K4, K10, K11 and K12, and tiny models'
kernel paths against their plain paths (LLaMA and OPT, f32 and int8
caches, the eval forward, the paged serving engine, structured and
transposed decode tables).

Needs an NVIDIA GPU and nvcc; skipped elsewhere. On the card:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu``."""

import numpy as np
import pytest
import torch

from squeezellm_tpu_torch import data, engine, serving, synthetic
from squeezellm_tpu_torch import eval as eval_mod
from squeezellm_tpu_torch.models import common, fuse, llama, opt
from squeezellm_tpu_torch.ops import (decode_attn, dequant_dense, flash_attn,
                                      kv_quant, lut_matmul, lut_matmul_t,
                                      paged_attn, quant_linear, spmv)
from squeezellm_tpu_torch.sampling import SamplingParams

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("M", [1, 3, 16, 40, 100])
def test_lut_matmul_kernel_matches_plain(dev, M, bits, mode):
    g = torch.Generator(device=dev).manual_seed(M * 10 + bits)
    in_f, out_f = 116, 200
    lin = synthetic.random_quant_linear(g, dev, out_f, in_f, bits, 0.05, 0)
    t = lin.tensors()
    for x_dt, y0_dt, sparse in ((torch.float32, torch.float32, True),
                                (torch.bfloat16, torch.bfloat16, True),
                                (torch.float32, None, False)):
        x = torch.randn(M, in_f, generator=g, device=dev).to(x_dt)
        y0 = (None if y0_dt is None
              else torch.randn(M, out_f, generator=g, device=dev).to(y0_dt))
        kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                  vals=t["sp_vals"]) if sparse else {}
        args = (x, t["qweight"], t["lut"], bits)
        got = lut_matmul.lut_matmul(*args, y0=y0, mode=mode, **kw)
        want = lut_matmul.lut_matmul_plain(*args, y0=y0, mode=mode, **kw)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-5, (x_dt, sparse, _rel(got, want))


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,g,window", [(32, 2, None), (64, 4, 5),
                                         (128, 1, None), (128, 8, 40)])
def test_decode_attention_kernel_matches_plain(dev, hd, g, window,
                                               cache_dtype):
    gen = torch.Generator(device=dev).manual_seed(hd + g)
    B, Hkv, S = 3, 2, 80
    H = g * Hkv
    # q/k/v as column slices of one fused projection row, as the model
    # hands them over
    qkv = torch.randn(B, (H + 2 * Hkv) * hd, generator=gen, device=dev)
    q = qkv[:, : H * hd].view(B, H, hd)
    k = qkv[:, H * hd: (H + Hkv) * hd].view(B, Hkv, hd)
    v = qkv[:, (H + Hkv) * hd:].view(B, Hkv, hd)
    cache = torch.randn(2, B, S, Hkv * hd, generator=gen,
                        device=dev).to(cache_dtype)
    lengths = torch.tensor([37, 0, S], dtype=torch.int32, device=dev)
    cos, sin = common.rope_cos_sin((lengths - 1).clamp(min=0).long(), hd,
                                   10000.0)
    got_c, want_c = cache.clone(), cache.clone()
    kw = dict(sliding_window=window, rope_cos=cos.contiguous(),
              rope_sin=sin.contiguous())
    got = decode_attn.decode_attention(q, k, v, got_c[0], got_c[1], lengths,
                                       **kw)
    want = decode_attn.decode_attention_plain(q, k, v, want_c[0], want_c[1],
                                              lengths, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4
    assert (got_c.float() - want_c.float()).abs().max() <= 1e-6


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,offset,hd,g,window", [
    (1, 0, 128, 1, None), (7, 0, 128, 1, None), (33, 0, 64, 2, None),
    (16, 21, 32, 4, None), (45, 3, 128, 2, 9)])
def test_flash_attention_kernel_matches_plain(dev, Sq, offset, hd, g,
                                              window, kv_dtype):
    gen = torch.Generator(device=dev).manual_seed(Sq + offset)
    B, Hkv, S = 2, 2, 96
    H = g * Hkv
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).transpose(1, 2)
    cache = {n: torch.randn(B, S, Hkv * hd, generator=gen,
                            device=dev).to(kv_dtype) for n in ("k", "v")}
    k, v = common.read_kv(cache, kv_dtype, Hkv)  # strided head-major views
    got = flash_attn.flash_attention(q, k, v, offset, sliding_window=window)
    want = flash_attn.flash_attention_plain(q, k, v, offset,
                                            sliding_window=window)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4


TOL_ATTN_BF16 = 2.0**-8  # of max |v|: p rounded to bf16 before p.v


@pytest.mark.parametrize("hd,g", [(hd, g) for hd in (32, 64, 128)
                                  for g in (1, 2, 4)])
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("offset", [0, 21])
@pytest.mark.parametrize("Sq", [1, 7, 33, 64, 65, 130, 300])
def test_flash_attention_bf16_kernel_matches_plain(dev, Sq, offset, window,
                                                   hd, g):
    """The bf16 regime's tensor-core kernel (mode "bf16", q, k, v bf16) on
    strided head-major views of a cache longer than the prefix (rows past
    it hold large values, never attended), against the plain version's f32
    products of the same inputs within TOL_ATTN_BF16 of max |v|."""
    gen = torch.Generator(device=dev).manual_seed(Sq * 7 + offset + hd + g)
    B, Hkv = 2, 2
    H, S = g * Hkv, offset + Sq + 70
    qkv = torch.randn(B, Sq, (H + 2 * Hkv) * hd, generator=gen,
                      device=dev).to(torch.bfloat16)
    q = qkv[..., : H * hd].view(B, Sq, H, hd).transpose(1, 2)
    cache = {n: torch.randn(B, S, Hkv * hd, generator=gen,
                            device=dev).to(torch.bfloat16) for n in ("k", "v")}
    for c in cache.values():
        c[:, offset + Sq:] = 3e4
    k, v = common.read_kv(cache, torch.bfloat16, Hkv)
    before = dict(flash_attn.flash_attention.regime_launches)
    got = flash_attn.flash_attention(q, k, v, offset, sliding_window=window,
                                     mode="bf16")
    assert flash_attn.flash_attention.regime_launches["bf16"] == (
        before["bf16"] + 1)
    want = flash_attn.flash_attention_plain(
        q, k[:, :, : offset + Sq], v[:, :, : offset + Sq], offset,
        sliding_window=window)
    torch.cuda.synchronize()
    vmax = float(v[:, :, : offset + Sq].float().abs().max())
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL_ATTN_BF16 * vmax


@pytest.mark.parametrize("window", [None, 9, 100])
def test_flash_attention_bf16_rows_do_not_depend_on_the_cohort(dev, window):
    """A row's bf16-regime output is bit-equal whichever rows share its
    call: the whole 300-token prompt at once, or chunks that start at other
    positions (a prefix hit, a chunk boundary), with and without a window."""
    gen = torch.Generator(device=dev).manual_seed(window or 0)
    B, Hkv, g, hd, S = 1, 2, 2, 128, 300
    H = g * Hkv
    q = torch.randn(B, S, H, hd, generator=gen,
                    device=dev).to(torch.bfloat16).transpose(1, 2)
    cache = {n: torch.randn(B, S, Hkv * hd, generator=gen,
                            device=dev).to(torch.bfloat16) for n in ("k", "v")}
    k, v = common.read_kv(cache, torch.bfloat16, Hkv)
    whole = flash_attn.flash_attention(q, k, v, 0, sliding_window=window,
                                       mode="bf16")
    for start, n in ((37, 150), (100, 200), (171, 5)):
        part = flash_attn.flash_attention(q[:, :, start: start + n], k, v,
                                          start, sliding_window=window,
                                          mode="bf16")
        torch.cuda.synchronize()
        assert torch.equal(part, whole[:, :, start: start + n]), start


def _decode_case(gen, dev, B, H, Hkv, hd, S, cache_dtype):
    qkv = torch.randn(B, (H + 2 * Hkv) * hd, generator=gen,
                      device=dev).to(torch.bfloat16)
    q = qkv[:, : H * hd].view(B, H, hd)
    k = qkv[:, H * hd: (H + Hkv) * hd].view(B, Hkv, hd)
    v = qkv[:, (H + Hkv) * hd:].view(B, Hkv, hd)
    hist = torch.randn(2, B, S, Hkv, hd, generator=gen, device=dev)
    if cache_dtype == "int8":
        codes, scales = kv_quant.quantize_rows(hist)
        return q, k, v, (codes.reshape(2, B, S, Hkv * hd),
                         scales[..., 0].transpose(2, 3).contiguous())
    return q, k, v, (hist.reshape(2, B, S, Hkv * hd).to(cache_dtype),)


def _decode(q, k, v, caches, lengths, plain, **kw):
    """K2 (one cache tensor pair) or K5 (codes and scales) on copies of
    `caches`; returns the output and the updated copies."""
    c = [t.clone() for t in caches]
    if len(c) == 1:
        fn = (decode_attn.decode_attention_plain if plain
              else decode_attn.decode_attention)
        out = fn(q, k, v, c[0][0], c[0][1], lengths, **kw)
    else:
        fn = (decode_attn.decode_attention_q8_plain if plain
              else decode_attn.decode_attention_q8)
        out = fn(q, k, v, c[0][0], c[0][1], c[1][0], c[1][1], lengths, **kw)
    return out, c


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32,
                                         "int8"])
@pytest.mark.parametrize("window", [None, 150, 40])
def test_decode_attention_row_split_matches_plain(dev, window, cache_dtype):
    """K2 and K5 at lengths on each side of the row chunks' boundaries
    (CHUNK rows a block), 0, the full cache and beyond it, with windows
    that cross chunks: within 1e-4 of the plain version, the cache rows
    equal to its (int8 codes and scales bit for bit)."""
    C = decode_attn.CHUNK
    gen = torch.Generator(device=dev).manual_seed(C + (window or 0))
    lens = [0, 1, C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1, 2 * C + 44,
            2 * C + 45, 2 * C + 60]
    B, H, Hkv, hd, S = len(lens), 8, 2, 128, 2 * C + 45
    q, k, v, caches = _decode_case(gen, dev, B, H, Hkv, hd, S, cache_dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    cos, sin = common.rope_cos_sin((lengths - 1).clamp(min=0).long(), hd,
                                   10000.0)
    kw = dict(sliding_window=window, rope_cos=cos.contiguous(),
              rope_sin=sin.contiguous())
    got, gc = _decode(q, k, v, caches, lengths, False, **kw)
    want, wc = _decode(q, k, v, caches, lengths, True, **kw)
    torch.cuda.synchronize()
    assert decode_attn.splits(S) == 3
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert not got[0].any()
    for a, b in zip(gc, wc):
        if cache_dtype == "int8":
            assert torch.equal(a, b)
        else:
            assert float((a.float() - b.float()).abs().max()) <= 1e-6


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, "int8"])
def test_decode_attention_slot_does_not_depend_on_its_cohort(dev,
                                                             cache_dtype):
    """A slot's K2/K5 output and cache rows are bit-equal whether it is
    decoded alone or beside other slots of other lengths: the row split
    follows the cache's capacity, never the cohort."""
    gen = torch.Generator(device=dev).manual_seed(3)
    B, H, Hkv, hd, S = 5, 32, 32, 128, 2048
    q, k, v, caches = _decode_case(gen, dev, B, H, Hkv, hd, S, cache_dtype)
    lengths = torch.tensor([2048, 1000, 129, 7, 1500], dtype=torch.int32,
                           device=dev)
    cos, sin = common.rope_cos_sin(lengths.long() - 1, hd, 10000.0)
    kw = dict(rope_cos=cos.contiguous(), rope_sin=sin.contiguous())
    full, fc = _decode(q, k, v, caches, lengths, False, **kw)
    for i in range(B):
        one = [t[:, i: i + 1].contiguous() for t in caches]
        alone, ac = _decode(
            q[i: i + 1], k[i: i + 1], v[i: i + 1], one, lengths[i: i + 1],
            False, rope_cos=kw["rope_cos"][i: i + 1],
            rope_sin=kw["rope_sin"][i: i + 1])
        torch.cuda.synchronize()
        assert torch.equal(alone[0], full[i]), i
        for a, b in zip(ac, fc):
            assert torch.equal(a[:, 0], b[:, i]), i


def test_tiny_model_kernel_path_matches_plain_path(dev):
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=384, n_layers=2, n_heads=4,
                            n_kv_heads=2, max_seq=128)
    prompt = np.array([[5, 9, 200, 31, 7, 77, 101]])
    outs = []
    for plain in (False, True):
        model = synthetic.quantized_llama(cfg, 4, sparsity=0.01, topx=3,
                                          seed=3, device=dev)
        eng = engine.Engine(fuse.fuse_for_decode(model), plain=plain)
        outs.append((eng.generate(prompt, 12),
                     eng.teacher_forced_logits(np.arange(10)[None])))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert _rel(outs[0][1], outs[1][1]) <= 1e-4


@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("in_f,out_f", [(116, 200), (320, 129), (7, 33)])
def test_dequant_dense_kernel_equals_plain(dev, in_f, out_f, bits, mode):
    """W equal to the plain version's bit for bit, with a crowded sidecar
    (duplicated slots), without one, and with zero-valued padding entries
    that point at slot (0, 0)."""
    g = torch.Generator(device=dev).manual_seed(in_f + bits)
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, bits, 0.2,
                                      0).tensors()
    args = (t["qweight"], t["lut"], bits, in_f)
    pad = dict(rowptr=t["sp_rowptr"] + 3, cols=torch.cat(
        [torch.zeros(3, dtype=torch.int32, device=dev), t["sp_cols"]]),
        vals=torch.cat([torch.zeros(3, device=dev), t["sp_vals"]]))
    pad["rowptr"][0] = 0
    for kw in (dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                    vals=t["sp_vals"]), {}, pad):
        got = dequant_dense.dequant_dense(*args, mode=mode, **kw)
        want = dequant_dense.dequant_dense_plain(*args, mode=mode, **kw)
        torch.cuda.synchronize()
        assert got.shape == (in_f, out_f) and got.dtype == want.dtype
        assert torch.equal(got, want), int((got != want).sum())


def _crowded_csr(g, out_f, in_f, bits, dev, density):
    """A CSR sidecar that meets every boundary of K4's fold and tiles:
    channels at both sides of a 128-column tile edge with rows of 70
    entries (three 32-entry batches) in which one slot repeats across each
    batch edge (entries 30-33 and 62-65) and others at the rows on both
    sides of a block's row edge (64 or, in two passes, 128 words: 512 or
    1024 rows at 4 bits, 640 or 1280 at 3),
    zero-valued padding entries at slot (0, 0) in front, and `density` of
    the other slots at random, unsorted within a row as a real sidecar
    is."""
    rng = np.random.default_rng(int(g.initial_seed()))
    cpw = 8 if bits == 4 else 10
    edge, edge2 = 64 * cpw, 128 * cpw  # a block's rows: 64 or 128 words
    rows = []
    for o in range(out_f):
        n = rng.binomial(in_f, density)
        c = list(rng.integers(0, in_f, n))
        if o in (0, 126, 127, 128, 129, out_f - 1):
            c = list(rng.integers(0, in_f, 70))
            for e in (30, 31, 32, 33, 62, 63, 64, 65):
                c[e] = 5 % in_f
            if in_f > edge:
                c[10], c[40], c[69] = edge - 1, edge, edge - 1
            if in_f > edge2:
                c[15], c[45], c[68] = edge2 - 1, edge2, edge2 - 1
        rows.append(c)
    rows[0] = [0, 0, 0] + rows[0]
    counts = [len(c) for c in rows]
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    cols = np.concatenate([np.asarray(c, dtype=np.int64) for c in rows])
    vals = rng.standard_normal(len(cols)).astype(np.float32)
    vals[:3] = 0.0
    return dict(rowptr=torch.from_numpy(rowptr).to(dev),
                cols=torch.from_numpy(cols.astype(np.int32)).to(dev),
                vals=torch.from_numpy(vals).to(dev))


@pytest.mark.parametrize("density", [0.01, 0.05])
@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("in_f,out_f", [(1300, 260), (1300, 262),
                                        (645, 131), (4096, 256),
                                        (10400, 4096)])
def test_dequant_dense_fold_batches_and_tiles_equal_plain(dev, in_f, out_f,
                                                          bits, mode,
                                                          density):
    """K4's W equal to the plain version's in every element when CSR rows
    are longer than a 32-entry batch and a slot repeats across batch, row
    block and column tile edges; a word row holds ~10 sidecar entries (1%)
    or more than its bucket (5%: ~50, the block's slow fold); blocks of one
    pass and, at 10400 x 4096, of two; `out` a multiple of 4 (16-byte
    words and W stores) and not (4-byte ones), `in` not a multiple of a
    word row or of a block's word rows."""
    g = torch.Generator(device=dev).manual_seed(in_f * 7 + out_f + bits)
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, bits, 0.0,
                                      0).tensors()
    kw = _crowded_csr(g, out_f, in_f, bits, dev, density)
    args = (t["qweight"], t["lut"], bits, in_f)
    got = dequant_dense.dequant_dense(*args, mode=mode, **kw)
    again = dequant_dense.dequant_dense(*args, mode=mode, **kw)
    want = dequant_dense.dequant_dense_plain(*args, mode=mode, **kw)
    torch.cuda.synchronize()
    assert got.shape == (in_f, out_f) and got.dtype == want.dtype
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(got, again)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,g,window,rope,S", [
    (32, 2, None, True, 80), (64, 4, 5, True, 33), (128, 1, None, False, 80),
    (128, 8, 40, True, 128)])
def test_decode_attention_q8_kernel_matches_plain(dev, hd, g, window, rope,
                                                  S, in_dtype):
    """Codes and scales equal to the plain version's (the in-kernel
    quantization is bit-identical to `quantize_rows`), output within 1e-4,
    at cache lengths no 32- or 128-row rule would take."""
    gen = torch.Generator(device=dev).manual_seed(hd + g)
    B, Hkv = 3, 2
    H = g * Hkv
    qkv = torch.randn(B, (H + 2 * Hkv) * hd, generator=gen,
                      device=dev).to(in_dtype)
    if not rope:  # an all-zero k row: scale 1e-12, codes 0
        qkv[0, H * hd: (H + 1) * hd] = 0
    q = qkv[:, : H * hd].view(B, H, hd)
    k = qkv[:, H * hd: (H + Hkv) * hd].view(B, Hkv, hd)
    v = qkv[:, (H + Hkv) * hd:].view(B, Hkv, hd)
    codes, scales = kv_quant.quantize_rows(
        torch.randn(2, B, S, Hkv, hd, generator=gen, device=dev))
    codes = codes.reshape(2, B, S, Hkv * hd)
    scales = scales[..., 0].transpose(2, 3).contiguous()
    lengths = torch.tensor([min(37, S), 0, S], dtype=torch.int32, device=dev)
    kw = dict(sliding_window=window)
    if rope:
        cos, sin = common.rope_cos_sin((lengths - 1).clamp(min=0).long(), hd,
                                       10000.0)
        kw.update(rope_cos=cos.contiguous(), rope_sin=sin.contiguous())
    gc, gs, wc, ws = codes.clone(), scales.clone(), codes.clone(), scales.clone()
    got = decode_attn.decode_attention_q8(q, k, v, gc[0], gc[1], gs[0], gs[1],
                                          lengths, **kw)
    want = decode_attn.decode_attention_q8_plain(q, k, v, wc[0], wc[1], ws[0],
                                                 ws[1], lengths, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert not got[1].any()
    assert torch.equal(gc, wc) and torch.equal(gs, ws)
    assert not torch.equal(gc, codes)  # the active slots' rows were written


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_tiny_models_int8_and_eval_paths_match_plain(dev, family,
                                                     monkeypatch):
    """A tiny LLaMA and a tiny OPT: the int8-cache request token-identical
    to the plain path, and the f32 perplexity through K4 (the dispatch point
    lowered to the tiny stride) within 1e-4 of the plain path's."""
    if family == "llama":
        cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                                intermediate_size=384, n_layers=2, n_heads=4,
                                n_kv_heads=2, max_seq=128)
        make = synthetic.quantized_llama
    else:
        cfg = opt.OPTConfig(vocab_size=512, hidden_size=256, ffn_dim=384,
                            n_layers=2, n_heads=4, max_seq=128)
        make = synthetic.quantized_opt
    model = fuse.fuse_for_decode(make(cfg, 3, sparsity=0.01, topx=3, seed=4,
                                      device=dev))
    prompt = np.array([[5, 9, 200, 31, 7, 77, 101]])
    toks = [engine.Engine(model, cache_dtype="int8", plain=plain)
            .generate(prompt, 12) for plain in (False, True)]
    np.testing.assert_array_equal(toks[0], toks[1])
    monkeypatch.setattr(quant_linear, "BIG_BATCH", 64)
    tokens = data.synthetic_tokens(cfg.vocab_size, 3 * 64, seed=1)
    before = dequant_dense.dequant_dense.launches
    ppl = [eval_mod.perplexity(model, tokens, seqlen=64, group=2,
                               plain=plain) for plain in (False, True)]
    assert dequant_dense.dequant_dense.launches > before
    assert abs(ppl[0] - ppl[1]) <= 1e-4 * ppl[1]


def _paged_case(dev, gen, *, B, Hkv, g, hd, ps, maxp, W, q8, in_dtype,
                pool_dtype, index, rope, shared_pages=1):
    """Pools of random history, a shuffled page table whose first
    ``shared_pages`` pages are shared by every slot that writes beyond
    them (a shared page is read by several blocks and written by none),
    and a window's q/k/v as head-major views of one fused token-major
    projection."""
    H = g * Hkv
    P = B * maxp + 3
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    pt = perm[: B * maxp].view(B, maxp).clone()
    first_written = torch.tensor(index, device=dev) - (1 if W is None else 0)
    sharers = (first_written >= shared_pages * ps).nonzero()[:, 0]
    pt[sharers, :shared_pages] = pt[sharers[0], :shared_pages]
    pt[first_written < 0] = 0
    w = W or 1
    qkv = torch.randn(B, w, (H + 2 * Hkv) * hd, generator=gen,
                      device=dev).to(in_dtype)
    q = qkv[..., : H * hd].view(B, w, H, hd).transpose(1, 2)
    k = qkv[..., H * hd: (H + Hkv) * hd].view(B, w, Hkv, hd).transpose(1, 2)
    v = qkv[..., (H + Hkv) * hd:].view(B, w, Hkv, hd).transpose(1, 2)
    hist = torch.randn(2, P, ps, Hkv, hd, generator=gen, device=dev)
    if q8:
        codes, sc = kv_quant.quantize_rows(hist)
        pools = [codes[0].reshape(P, ps, -1), codes[1].reshape(P, ps, -1),
                 kv_quant.pool_pack_scales(sc[0]).contiguous(),
                 kv_quant.pool_pack_scales(sc[1]).contiguous()]
    else:
        pools = [hist[0].reshape(P, ps, -1).to(pool_dtype),
                 hist[1].reshape(P, ps, -1).to(pool_dtype)]
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    kw = {}
    if rope:
        first = (idx.long() - (1 if W is None else 0)).clamp(min=0)
        at = first[:, None] + torch.arange(w, device=dev)
        cos, sin = common.rope_cos_sin(at if W else at[:, 0], hd, 10000.0)
        kw = dict(rope_cos=cos.contiguous(), rope_sin=sin.contiguous())
    if W is None:
        q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    return q, k, v, pools, pt, idx, kw


def _paged_run(fn, plain, q, k, v, pools, pt, idx, kw):
    """One K6-K9 call (``fn``, or its plain version) on copies of `pools`;
    returns the output and the updated copies."""
    pc = [t.clone() for t in pools]
    f = getattr(paged_attn, fn + ("_plain" if plain else ""))
    return f(q, k, v, *pc, pt, idx, **kw), pc


def _split_capacity(ps, W):
    """Pages a slot needs so that its capacity spans three chunks."""
    return -(-(2 * paged_attn.CHUNK + 2 * ps + W) // ps)


@pytest.mark.parametrize("at", ["pages", "chunks"])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("in_dtype,pool_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("hd,g,ps,window,rope", [
    (32, 2, 16, None, True), (64, 4, 8, 21, True), (128, 1, 16, None, False),
    (128, 8, 32, 40, True), (128, 1, 128, 100, True)])
def test_paged_decode_kernels_match_plain(dev, hd, g, ps, window, rope,
                                          in_dtype, pool_dtype, q8, at):
    """K6 and K7: output within 1e-4 of max |out|, the pools after the
    write equal to the plain version's (int8 codes and scales included),
    an inactive slot untouched, lengths at a page's first and last row
    ("pages") or at CHUNK - 1, CHUNK and CHUNK + 1 positions, where the
    row split changes hands ("chunks"; sliding windows whose low edge
    falls inside a chunk)."""
    gen = torch.Generator(device=dev).manual_seed(hd + g + ps)
    C = paged_attn.CHUNK
    if at == "pages":
        maxp = 6
        lengths = [1, ps, ps + 1, 0, 3 * ps + 5, maxp * ps]
    else:
        maxp = _split_capacity(ps, 1)
        lengths = [C - 1, C, C + 1, 0, 2 * C + 5, maxp * ps]
    q, k, v, pools, pt, idx, kw = _paged_case(
        dev, gen, B=6, Hkv=2, g=g, hd=hd, ps=ps, maxp=maxp, W=None, q8=q8,
        in_dtype=in_dtype, pool_dtype=pool_dtype, index=lengths, rope=rope)
    kw["sliding_window"] = window
    fn = "paged_decode_attention" + ("_q8" if q8 else "")
    before = getattr(paged_attn, fn).launches
    got, got_p = _paged_run(fn, False, q, k, v, pools, pt, idx, kw)
    want, want_p = _paged_run(fn, True, q, k, v, pools, pt, idx, kw)
    torch.cuda.synchronize()
    assert getattr(paged_attn, fn).launches == before + 1
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert not got[3].any()
    for a, b_ in zip(got_p, want_p):
        assert torch.equal(a, b_)
    assert not torch.equal(got_p[0], pools[0])


@pytest.mark.parametrize("at", ["pages", "chunks"])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("in_dtype,pool_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("hd,g,ps,W,window,rope", [
    (32, 2, 16, 2, None, True), (64, 4, 8, 5, 21, True),
    (128, 1, 16, 8, None, False), (128, 8, 32, 8, 40, True),
    (128, 3, 16, 3, None, True), (128, 1, 128, 5, None, True),
    (128, 4, 128, 5, 100, True)])
def test_paged_verify_kernels_match_plain(dev, hd, g, ps, W, window, rope,
                                          in_dtype, pool_dtype, q8, at):
    """K8 and K9: every window row's output within 1e-4 of max |out|, all
    W rows written as the plain version writes them, an inactive slot;
    windows that start at a page's last rows and cross into the next page
    ("pages"), or that start at CHUNK - 2 and cross a chunk (and, with
    128-row pages, a page), start at a chunk's first or last position, and
    sliding windows whose low edge falls inside a chunk ("chunks"). g * W >
    8 rows take the kernel's passes of 8."""
    gen = torch.Generator(device=dev).manual_seed(hd + g + ps + W)
    C = paged_attn.CHUNK
    if at == "pages":
        maxp = 6
        starts = [0, ps - 1, 2 * ps - W + 1, -1, 3 * ps + 5, maxp * ps - W]
    else:
        maxp = _split_capacity(ps, W)
        starts = [C - 2, C - W, C, -1, 2 * C - 1, maxp * ps - W]
    q, k, v, pools, pt, idx, kw = _paged_case(
        dev, gen, B=6, Hkv=2, g=g, hd=hd, ps=ps, maxp=maxp, W=W, q8=q8,
        in_dtype=in_dtype, pool_dtype=pool_dtype, index=starts, rope=rope)
    kw["sliding_window"] = window
    fn = "paged_verify_attention" + ("_q8" if q8 else "")
    before = getattr(paged_attn, fn).launches
    got, got_p = _paged_run(fn, False, q, k, v, pools, pt, idx, kw)
    want, want_p = _paged_run(fn, True, q, k, v, pools, pt, idx, kw)
    torch.cuda.synchronize()
    assert getattr(paged_attn, fn).launches == before + 1
    assert got.shape == want.shape == (6, 2 * g, W, hd)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert not got[3].any()
    for a, b_ in zip(got_p, want_p):
        assert torch.equal(a, b_)
    assert not torch.equal(got_p[0], pools[0])


@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("fn", ["paged_decode_attention",
                                "paged_decode_attention_q8",
                                "paged_verify_attention",
                                "paged_verify_attention_q8"])
def test_paged_kernels_slot_does_not_depend_on_its_cohort(dev, fn, ps):
    """A slot's K6-K9 output is bit-equal whether it runs alone or beside
    slots of other lengths or starts, and the pools written by the slots
    one at a time equal those the cohort wrote (codes and scales too): the
    row split follows the table's capacity, never the cohort."""
    gen = torch.Generator(device=dev).manual_seed(ps + len(fn))
    C = paged_attn.CHUNK
    verify = "verify" in fn
    W = 5 if verify else None
    index = ([2043, 1000, C - 2, 7, 1500] if verify
             else [2048, 1000, C + 1, 7, 1500])
    q, k, v, pools, pt, idx, kw = _paged_case(
        dev, gen, B=5, Hkv=8, g=1, hd=128, ps=ps, maxp=2048 // ps, W=W,
        q8=fn.endswith("q8"), in_dtype=torch.bfloat16,
        pool_dtype=torch.bfloat16, index=index, rope=True)
    full, full_p = _paged_run(fn, False, q, k, v, pools, pt, idx, kw)
    one_p = [t.clone() for t in pools]
    for i in range(len(index)):
        f = getattr(paged_attn, fn)
        alone = f(q[i: i + 1], k[i: i + 1], v[i: i + 1], *one_p,
                  pt[i: i + 1].contiguous(), idx[i: i + 1],
                  rope_cos=kw["rope_cos"][i: i + 1],
                  rope_sin=kw["rope_sin"][i: i + 1])
        torch.cuda.synchronize()
        assert torch.equal(alone[0], full[i]), i
    for a, b_ in zip(one_p, full_p):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("family,cache_dtype", [
    ("llama", torch.float32), ("llama", "int8"), ("opt", torch.float32)])
def test_tiny_model_paged_serving_matches_plain(dev, family, cache_dtype):
    """The paged engine on a tiny model: step, step_window, the speculative
    window and chunked admission token-identical to each other and (f32
    pool) to the plain path; the sampled run repeats; every page is free
    afterwards."""
    if family == "llama":
        cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                                intermediate_size=384, n_layers=2, n_heads=4,
                                n_kv_heads=2, max_seq=128)
        make = synthetic.quantized_llama
    else:
        cfg = opt.OPTConfig(vocab_size=512, hidden_size=256, ffn_dim=384,
                            n_layers=2, n_heads=4, max_seq=128)
        make = synthetic.quantized_opt
    model = fuse.fuse_for_decode(make(cfg, 4, sparsity=0.01, topx=3, seed=5,
                                      device=dev))
    rng = np.random.default_rng(2)
    base = rng.integers(0, 512, 37).tolist()
    prompts = [base + [7], base + [9, 11], rng.integers(0, 512, 5).tolist(),
               [3, 1, 4] * 6, rng.integers(0, 512, 5).tolist()]

    def run(window=1, **kw):
        eng = serving.PagedContinuousBatchEngine(
            model, slots=3, n_pages=40, page_size=16, cache_dtype=cache_dtype,
            **kw)
        out = eng.run(prompts, max_new_tokens=10, window=window)
        assert eng.pool.pages_in_use() == 0
        return out

    before = [paged_attn.paged_decode_attention.launches,
              paged_attn.paged_decode_attention_q8.launches,
              paged_attn.paged_verify_attention.launches,
              paged_attn.paged_verify_attention_q8.launches]
    ref = run()
    assert run(window=4) == ref
    assert run(speculative=(3, 2)) == ref
    assert run(prefill_chunk=8) == ref  # chunks of 8, 8, ... and a tail of 1
    after = [paged_attn.paged_decode_attention.launches,
             paged_attn.paged_decode_attention_q8.launches,
             paged_attn.paged_verify_attention.launches,
             paged_attn.paged_verify_attention_q8.launches]
    moved = [a > b for a, b in zip(after, before)]
    assert moved == ([False, True, False, True] if cache_dtype == "int8"
                     else [True, False, True, False])
    if cache_dtype != "int8":
        assert run(plain=True) == ref
    sp = SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
    eng = [serving.PagedContinuousBatchEngine(
        model, slots=3, n_pages=40, page_size=16, cache_dtype=cache_dtype,
        seed=3) for _ in range(2)]
    a = eng[0].run(prompts, max_new_tokens=10, sampling=sp)
    b = eng[1].run(prompts, max_new_tokens=10, window=4, sampling=sp)
    assert a == b and a != ref


@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("M", [1, 3, 8, 16, 40, 100])
def test_lut_matmul_struct_kernel_matches_plain(dev, M, mode):
    g = torch.Generator(device=dev).manual_seed(M + 7)
    in_f, out_f = 116, 200
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, 4, 0.05, 0,
                                      structured=True).tensors()
    a = t["lut"][:, :8].contiguous()
    d = (t["lut"][:, 8] - t["lut"][:, 0]).contiguous()
    for x_dt, y0_dt, sparse in ((torch.float32, torch.float32, True),
                                (torch.bfloat16, torch.bfloat16, True),
                                (torch.float32, None, False)):
        x = torch.randn(M, in_f, generator=g, device=dev).to(x_dt)
        y0 = (None if y0_dt is None
              else torch.randn(M, out_f, generator=g, device=dev).to(y0_dt))
        kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                  vals=t["sp_vals"]) if sparse else {}
        got = lut_matmul.lut_matmul_struct(x, t["qweight"], a, d, y0=y0,
                                           mode=mode, **kw)
        want = lut_matmul.lut_matmul_struct_plain(x, t["qweight"], a, d,
                                                  y0=y0, mode=mode, **kw)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-5, (x_dt, sparse, _rel(got, want))


@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("in_f,out_f", [(116, 200), (2056, 33), (7, 9)])
def test_lut_matmul_t_kernel_matches_plain(dev, M, in_f, out_f, mode):
    """Partial last words, inputs over two x chunks, channel tails."""
    g = torch.Generator(device=dev).manual_seed(M * 100 + in_f)
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, 4, 0.0,
                                      0).tensors()
    qwt = t["qweight"].t().contiguous()
    for x_dt in (torch.float32, torch.bfloat16):
        x = torch.randn(M, in_f, generator=g, device=dev).to(x_dt)
        got = lut_matmul_t.lut_matmul_t(x, qwt, t["lut"], mode=mode)
        want = lut_matmul_t.lut_matmul_t_plain(x, qwt, t["lut"], mode=mode)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-5, (x_dt, _rel(got, want))


TOL_K1 = {"exact": 1e-5, "bf16": 1e-4}  # chip_smoke.TOL_K1


@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("in_f,out_f", [(1000, 130), (1028, 257),
                                        (1056, 128), (4104, 36),
                                        (11008, 140), (520, 17000),
                                        (136, 34000)])
def test_lut_matmul_t_tiles_and_splits_match_plain(dev, in_f, out_f, mode):
    """K11 within TOL_K1 of max |y| of the plain version at every row
    count, x in f32 and bf16: `in` not a multiple of 16 inputs, of a
    128-input span or of a block's 128 words (a partial last span, 4-byte
    copies where n_words % 4 != 0), k-splits of 1 to 11 blocks, and
    128-channel tiles with a tail; two launches bit-equal."""
    g = torch.Generator(device=dev).manual_seed(in_f + out_f)
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, 4, 0.0,
                                      0).tensors()
    qwt = t["qweight"].t().contiguous()
    for M in range(1, 9):
        for x_dt in (torch.float32, torch.bfloat16):
            x = torch.randn(M, in_f, generator=g, device=dev).to(x_dt)
            got = lut_matmul_t.lut_matmul_t(x, qwt, t["lut"], mode=mode)
            again = lut_matmul_t.lut_matmul_t(x, qwt, t["lut"], mode=mode)
            want = lut_matmul_t.lut_matmul_t_plain(x, qwt, t["lut"],
                                                   mode=mode)
            torch.cuda.synchronize()
            assert _rel(got, want) <= TOL_K1[mode], (M, x_dt,
                                                     _rel(got, want))
            assert torch.equal(got, again), (M, x_dt)


@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("in_f,out_f", [(4096, 4096), (1028, 257)])
def test_lut_matmul_t_rows_do_not_depend_on_the_batch(dev, in_f, out_f,
                                                      mode):
    """Row m of K11 is bit-equal at every M from 1 to 8 and at every place
    in the batch: a slot's tokens do not depend on the slots decoded
    beside it (the tensor cores always take 8 columns, exact mode's row
    variants sum a row in one order, the split follows the shape)."""
    g = torch.Generator(device=dev).manual_seed(11)
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, 4, 0.0,
                                      0).tensors()
    qwt = t["qweight"].t().contiguous()
    for x_dt in (torch.float32, torch.bfloat16):
        x = torch.randn(8, in_f, generator=g, device=dev).to(x_dt)
        full = lut_matmul_t.lut_matmul_t(x, qwt, t["lut"], mode=mode)
        for a, b in ((0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7),
                     (7, 8), (3, 8), (2, 5), (1, 2)):
            part = lut_matmul_t.lut_matmul_t(x[a:b].contiguous(), qwt,
                                             t["lut"], mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(part, full[a:b]), (x_dt, a, b)


def _k12_csr(dev, kind, seed):
    """A CSR sidecar (in_f, rowptr, cols, vals) on `dev`, out_f = 517 rows:
    "random" (2% of 300 inputs); "wide" (2% of 25000 inputs: one row of f32
    x, 100000 bytes, is more than a block stages, so it is read from
    global memory); "skewed" (empty rows, one row holding
    half of 2304 inputs, one of 2000 entries, the rest sparse);
    "duplicates" (columns repeated within rows); "g8"/"g16"/"g32" (row
    lengths at the edges of a lane, of G lanes and of G * UNROLL entries
    in flight, among rows of 3 G entries, so that their mean picks that
    G)."""
    rng = np.random.default_rng(seed)
    out_f = 517
    in_f = {"skewed": 2304, "random": 300, "duplicates": 300,
            "wide": 25000}.get(kind, 600)
    if kind in ("random", "wide"):
        lengths = rng.binomial(in_f, 0.02, out_f)
    elif kind == "skewed":
        lengths = np.where(rng.random(out_f) < 0.3, 0,
                           rng.integers(1, 12, out_f))
        lengths[5], lengths[300] = in_f // 2, 2000
    elif kind == "duplicates":
        lengths = rng.integers(0, 40, out_f)
    else:
        G, U = int(kind[1:]), spmv.UNROLL
        edges = [0, 1, G - 1, G, G + 1, G * U - 1, G * U, G * U + 1,
                 2 * G * U + 1]
        period = [n for e in edges for n in (e, 3 * G, 3 * G, 3 * G, 3 * G)]
        lengths = np.array(period * (out_f // len(period) + 1))[:out_f]
    rows = []
    for n in lengths:
        rows.append(rng.integers(0, 16, n) if kind == "duplicates"
                    else rng.choice(in_f, n, replace=False))
    cols = np.concatenate(rows).astype(np.int32)
    rowptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    vals = rng.standard_normal(len(cols)).astype(np.float32)
    if kind.startswith("g"):
        assert spmv.group_size(len(cols), out_f) == int(kind[1:])
    return in_f, *(torch.from_numpy(a).to(dev) for a in (rowptr, cols, vals))


K12_SIDECARS = ["random", "wide", "skewed", "duplicates", "g8", "g16",
                "g32"]


@pytest.mark.parametrize("sidecar", K12_SIDECARS)
@pytest.mark.parametrize("B", [1, 3, 8, 40, 100, 1023])
def test_spmv_kernel_matches_plain(dev, B, sidecar):
    """The sum alone and folded into an accumulator (y0 none, f32, bf16),
    x f32 and bf16, against the plain version."""
    in_f, *csr = _k12_csr(dev, sidecar, B)
    out_f = csr[0].numel() - 1
    g = torch.Generator(device=dev).manual_seed(B)
    for x_dt in (torch.float32, torch.bfloat16):
        x = torch.randn(B, in_f, generator=g, device=dev).to(x_dt)
        y = torch.randn(B, out_f, generator=g, device=dev)
        for y0_dt in (None, "none", torch.float32, torch.bfloat16):
            kw = {}
            if y0_dt is not None:  # the accumulate form
                y0 = (None if y0_dt == "none" else
                      torch.randn(B, out_f, generator=g, device=dev).to(
                          y0_dt))
                kw = dict(y=y.clone(), y0=y0)
            got = spmv.spmv(x, *csr, out_f, **kw)
            if kw:
                assert got.data_ptr() == kw["y"].data_ptr()  # in place
                kw["y"] = y.clone()
            want = spmv.spmv_plain(x, *csr, out_f, **kw)
            torch.cuda.synchronize()
            assert _rel(got, want) <= 1e-5, (x_dt, y0_dt, _rel(got, want))


@pytest.mark.parametrize("sidecar", K12_SIDECARS)
def test_spmv_rows_do_not_depend_on_the_batch(dev, sidecar):
    """Row m of K12 is bit-equal at every M from 1 to 8, at every place in
    the batch, across two launches and with the fold: a slot's tokens do
    not depend on the slots decoded beside it."""
    in_f, *csr = _k12_csr(dev, sidecar, 7)
    out_f = csr[0].numel() - 1
    g = torch.Generator(device=dev).manual_seed(7)
    for x_dt in (torch.float32, torch.bfloat16):
        x = torch.randn(8, in_f, generator=g, device=dev).to(x_dt)
        y = torch.randn(8, out_f, generator=g, device=dev)
        y0 = torch.randn(8, out_f, generator=g, device=dev)
        full = spmv.spmv(x, *csr, out_f)
        assert torch.equal(spmv.spmv(x, *csr, out_f), full)
        folded = spmv.spmv(x, *csr, out_f, y=y.clone(), y0=y0)
        for a, b in ((0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7),
                     (7, 8), (3, 8), (2, 5), (1, 2)):
            part = spmv.spmv(x[a:b].contiguous(), *csr, out_f)
            fpart = spmv.spmv(x[a:b].contiguous(), *csr, out_f,
                              y=y[a:b].clone(), y0=y0[a:b].contiguous())
            torch.cuda.synchronize()
            assert torch.equal(part, full[a:b]), (x_dt, a, b)
            assert torch.equal(fpart, folded[a:b]), (x_dt, a, b)


@pytest.mark.parametrize("rows,want", [(1, "t"), (8, "t"), (9, "struct"),
                                       (1023, "struct"), (1024, "dense")])
def test_quant_linear_routing_on_the_card(dev, rows, want):
    """The JAX precedence: <= 8 rows with qweight_t: K11 (+ K12 for the
    sidecar); else a structured table below 1024 rows: K10; 1024 rows and
    more: K4. Each route agrees with the plain route."""
    g = torch.Generator(device=dev).manual_seed(rows)
    lin = synthetic.random_quant_linear(g, dev, 96, 116, 4, 0.05, 2,
                                        structured=True)
    model = torch.nn.Module()
    model.lin = lin
    fuse.attach_decode_luts(model, transposed=True)
    assert {"struct_a", "struct_d", "qweight_t"} <= set(lin.tensors())
    kernels = (lut_matmul.lut_matmul, lut_matmul.lut_matmul_struct,
               lut_matmul_t.lut_matmul_t, spmv.spmv,
               dequant_dense.dequant_dense)
    before = [k.launches for k in kernels]
    x = torch.randn(rows, 116, generator=g, device=dev)
    y0 = torch.randn(rows, 96, generator=g, device=dev)
    got = lin(x, y0=y0)
    moved = [k.launches - b for k, b in zip(kernels, before)]
    want_moved = {"t": [0, 0, 1, 1, 0], "struct": [0, 1, 0, 0, 0],
                  "dense": [0, 0, 0, 0, 1]}[want]
    assert moved == want_moved
    ref = lin(x, y0=y0, plain=True)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("transposed", [False, True])
def test_tiny_structured_model_kernel_path_matches_plain(dev, transposed):
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=384, n_layers=2, n_heads=4,
                            n_kv_heads=2, max_seq=128)
    prompt = np.array([[5, 9, 200, 31, 7, 77, 101]])
    model = fuse.attach_decode_luts(fuse.fuse_for_decode(
        synthetic.quantized_llama(cfg, 4, sparsity=0.01, topx=3, seed=3,
                                  device=dev, structured=True)),
        transposed=transposed)
    counted = (lut_matmul_t.lut_matmul_t if transposed
               else lut_matmul.lut_matmul_struct)
    before = (counted.launches, lut_matmul.lut_matmul.launches)
    got = engine.Engine(model).generate(prompt, 12)
    assert counted.launches > before[0]
    assert lut_matmul.lut_matmul.launches == before[1]
    ref = engine.Engine(model, plain=True).generate(prompt, 12)
    np.testing.assert_array_equal(got, ref)


def _sidecar(g, dev, out_f, in_f, kind):
    """A CSR sidecar: none, 5% of the slots at random, or 5% with one
    crowded row of 2100 entries (columns drawn with repeats, as a
    Fisher-ranked sidecar crowds a few rows)."""
    if kind == "none":
        return {}
    counts = torch.bincount(torch.randint(0, out_f, (int(0.05 * out_f * in_f),),
                                          generator=g, device=dev),
                            minlength=out_f)
    if kind == "crowded":
        counts[7] = 2100
    rowptr = torch.zeros(out_f + 1, dtype=torch.int32, device=dev)
    rowptr[1:] = torch.cumsum(counts, 0)
    nnz = int(rowptr[-1])
    return dict(rowptr=rowptr,
                cols=torch.randint(0, in_f, (nnz,), generator=g, device=dev,
                                   dtype=torch.int32),
                vals=torch.randn(nnz, generator=g, device=dev))


@pytest.mark.parametrize("in_f,out_f", [(116, 203), (2056, 260)])
@pytest.mark.parametrize("mode", ["exact", "bf16"])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 9, 12, 16, 17, 40, 100, 1023])
@pytest.mark.parametrize("wrapper,bits", [("k1", 3), ("k1", 4), ("k10", 4)])
def test_lut_matmul_gemv_and_mma_kernels_match_plain(dev, wrapper, bits, M,
                                                     mode, in_f, out_f):
    """Every device kernel of K1 and K10 (the GEMV and, in bf16 mode, the
    decode and the prefill tensor-core kernels, each forced at every row
    count) against the plain version within 1e-5 of max |y|, and bit-equal
    across two launches: x and y0 in f32 and bf16, y0 absent, no sidecar,
    5%, and one row of 2100 entries; `out` not a multiple of 4 and a
    partial last word (116), and a k-split over several blocks (2056
    inputs)."""
    g = torch.Generator(device=dev).manual_seed(M * 31 + bits + in_f)
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, bits, 0.0, 0,
                                      structured=wrapper == "k10").tensors()
    if wrapper == "k10":
        tables = (t["lut"][:, :8].contiguous(),
                  (t["lut"][:, 8] - t["lut"][:, 0]).contiguous())
        kernel, plain = (lut_matmul.lut_matmul_struct,
                         lut_matmul.lut_matmul_struct_plain)
        args = (t["qweight"], *tables)
    else:
        kernel, plain = lut_matmul.lut_matmul, lut_matmul.lut_matmul_plain
        args = (t["qweight"], t["lut"], bits)
    variants = ("gemv", "mma", "dec") if mode == "bf16" else ("gemv",)
    for kind in ("none", "sparse", "crowded"):
        kw = _sidecar(g, dev, out_f, in_f, kind)
        for x_dt, y0_dt in ((torch.float32, torch.float32),
                            (torch.bfloat16, torch.bfloat16),
                            (torch.bfloat16, None), (torch.float32,
                                                     torch.bfloat16)):
            x = torch.randn(M, in_f, generator=g, device=dev).to(x_dt)
            y0 = (None if y0_dt is None else
                  torch.randn(M, out_f, generator=g, device=dev).to(y0_dt))
            want = plain(x, *args, y0=y0, mode=mode, **kw)
            for variant in variants:
                got = kernel(x, *args, y0=y0, mode=mode, variant=variant, **kw)
                again = kernel(x, *args, y0=y0, mode=mode, variant=variant,
                               **kw)
                torch.cuda.synchronize()
                case = (kind, x_dt, y0_dt, variant)
                assert _rel(got, want) <= 1e-5, (case, _rel(got, want))
                assert torch.equal(got, again), case


@pytest.mark.parametrize("M,mode,variant,want", [
    (1, "bf16", None, "mma"), (8, "bf16", None, "mma"),
    (16, "bf16", "gemv", "gemv"), (12, "bf16", "gemv", "gemv"),
    (100, "exact", None, "gemv"), (1, "bf16", "dec", "dec"),
    (8, "bf16", "dec", "dec"), (16, "bf16", "dec", "dec"),
    (17, "bf16", "dec", "dec"), (1, "exact", None, "gemv")])
def test_lut_matmul_counts_the_kernel_it_ran(dev, M, mode, variant, want):
    g = torch.Generator(device=dev).manual_seed(M)
    t = synthetic.random_quant_linear(g, dev, 96, 116, 4, 0.05, 0).tensors()
    x = torch.randn(M, 116, generator=g, device=dev)
    before = dict(lut_matmul.lut_matmul.variant_launches)
    lut_matmul.lut_matmul(x, t["qweight"], t["lut"], 4, mode=mode,
                          variant=variant)
    after = lut_matmul.lut_matmul.variant_launches
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == want) for k in after}


@pytest.mark.parametrize("wrapper", ["k1", "k10"])
def test_lut_matmul_gemv_rows_do_not_depend_on_the_batch(dev, wrapper):
    """The GEMV sums a row in the same order whatever else is in the batch
    (exact mode, and bf16 mode's decode steps, at every row count), so
    that a request's tokens do not depend on what is served beside it."""
    g = torch.Generator(device=dev).manual_seed(5)
    in_f, out_f = 2056, 260
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, 4, 0.05, 0,
                                      structured=wrapper == "k10").tensors()
    if wrapper == "k10":
        kernel = lut_matmul.lut_matmul_struct
        args = (t["qweight"], t["lut"][:, :8].contiguous(),
                (t["lut"][:, 8] - t["lut"][:, 0]).contiguous())
    else:
        kernel, args = lut_matmul.lut_matmul, (t["qweight"], t["lut"], 4)
    kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"], vals=t["sp_vals"])
    x = torch.randn(40, in_f, generator=g, device=dev)
    y0 = torch.randn(40, out_f, generator=g, device=dev)
    for mode in ("exact", "bf16"):
        full = kernel(x, *args, y0=y0, mode=mode, variant="gemv", **kw)
        for M in (1, 3, 8, 12, 16, 17):
            part = kernel(x[:M], *args, y0=y0[:M], mode=mode,
                          variant="gemv", **kw)
            torch.cuda.synchronize()
            assert torch.equal(part, full[:M]), (mode, M)


@pytest.mark.parametrize("wrapper,bits", [("k1", 4), ("k1", 3), ("k10", 4)])
@pytest.mark.parametrize("in_f,out_f", [(2056, 260), (4096, 4096)])
def test_lut_matmul_dec_rows_do_not_depend_on_the_batch(dev, wrapper, bits,
                                                        in_f, out_f):
    """The decode kernel (bf16 mode's decode steps and verify windows of
    at most 16 rows) sums a row in one order whatever the batch: the
    k-split follows the layer's shape, and one n8 tile of rows or two
    run the same products for a row, so a row's bits are the same at M
    1, 3, 8, 12, 16 and 17 and at any place in the batch: a slot gets the
    same tokens served alone or in a full batch."""
    g = torch.Generator(device=dev).manual_seed(11 + bits)
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, bits, 0.0045, 0,
                                      structured=wrapper == "k10").tensors()
    if wrapper == "k10":
        kernel = lut_matmul.lut_matmul_struct
        args = (t["qweight"], t["lut"][:, :8].contiguous(),
                (t["lut"][:, 8] - t["lut"][:, 0]).contiguous())
    else:
        kernel, args = lut_matmul.lut_matmul, (t["qweight"], t["lut"], bits)
    kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"], vals=t["sp_vals"],
              mode="bf16", variant="dec")
    x = torch.randn(40, in_f, generator=g, device=dev).to(torch.bfloat16)
    y0 = torch.randn(40, out_f, generator=g, device=dev).to(torch.bfloat16)
    full = kernel(x, *args, y0=y0, **kw)
    for a, b in ((0, 1), (0, 3), (0, 8), (0, 12), (0, 16), (0, 17), (7, 8),
                 (5, 17), (20, 32), (23, 40), (39, 40)):
        part = kernel(x[a:b].contiguous(), *args, y0=y0[a:b].contiguous(),
                      **kw)
        torch.cuda.synchronize()
        assert torch.equal(part, full[a:b]), (a, b)


@pytest.mark.parametrize("wrapper", ["k1", "k10"])
@pytest.mark.parametrize("in_f,out_f", [(2056, 260), (4096, 4096)])
def test_lut_matmul_mma_rows_do_not_depend_on_the_batch(dev, wrapper, in_f,
                                                        out_f):
    """The tensor-core kernel's k-split follows the layer's shape, not the
    row count, so in bf16 mode a row's bits are the same at every M from
    9 to 1023 and at any place in the batch: a prompt prefilled alone, in
    a cohort or after a prefix hit gets the same logits."""
    g = torch.Generator(device=dev).manual_seed(7)
    t = synthetic.random_quant_linear(g, dev, out_f, in_f, 4, 0.0045, 0,
                                      structured=wrapper == "k10").tensors()
    if wrapper == "k10":
        kernel = lut_matmul.lut_matmul_struct
        args = (t["qweight"], t["lut"][:, :8].contiguous(),
                (t["lut"][:, 8] - t["lut"][:, 0]).contiguous())
    else:
        kernel, args = lut_matmul.lut_matmul, (t["qweight"], t["lut"], 4)
    kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"], vals=t["sp_vals"])
    x = torch.randn(1023, in_f, generator=g, device=dev).to(torch.bfloat16)
    y0 = torch.randn(1023, out_f, generator=g, device=dev)
    full = kernel(x, *args, y0=y0, mode="bf16", **kw)
    for a, b in ((0, 9), (5, 17), (0, 64), (1, 66), (100, 200), (37, 137),
                 (900, 1023), (3, 1000), (500, 501)):
        part = kernel(x[a:b].contiguous(), *args, y0=y0[a:b].contiguous(),
                      mode="bf16", **kw)
        torch.cuda.synchronize()
        assert torch.equal(part, full[a:b]), (a, b)


def test_hybrid_matmul_rows_do_not_depend_on_the_batch(dev):
    """The top-X product (a library GEMM) gives a row the same f32 value
    whatever the batch, as K1 does (exact mode's sampled tokens must not
    depend on what is served beside a request)."""
    from squeezellm_tpu_torch.ops import plain_ops

    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(300, 4096, generator=g, device=dev)
    w = torch.randn(4096, 10, generator=g, device=dev)
    idx = torch.randperm(4096, generator=g, device=dev)[:10]
    full = plain_ops.hybrid_matmul(x, w, idx, 4096)
    for a, b in ((0, 1), (74, 111), (256, 300), (3, 11)):
        part = plain_ops.hybrid_matmul(x[a:b].contiguous(), w, idx, 4096)
        assert torch.equal(part, full[a:b]), (a, b)


# ---------------------------------------------------------------------------
# Step programs captured as CUDA graphs (graphs.StepGraph)
# ---------------------------------------------------------------------------


def _tiny_llama(dev, **kw):
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=384, n_layers=2, n_heads=4,
                            n_kv_heads=2, max_seq=128)
    return fuse.fuse_for_decode(synthetic.quantized_llama(
        cfg, 4, sparsity=0.01, topx=3, seed=3, device=dev, **kw))


@pytest.mark.parametrize("regime", ["exact", "bf16"])
def test_flash_attention_reads_its_offset_from_the_card(dev, regime):
    """K3 with its offset in a tensor (int32 or int64, 0-d or (1,)) equals
    the launch at the python int bit for bit, in both regimes, at a verify
    window's shape and a prompt's."""
    gen = torch.Generator(device=dev).manual_seed(5)
    B, H, Hkv, hd, S = 1, 4, 2, 128, 256
    dt = torch.bfloat16 if regime == "bf16" else torch.float32
    cache = {n: torch.randn(B, S, Hkv * hd, generator=gen,
                            device=dev).to(dt) for n in ("k", "v")}
    k, v = common.read_kv(cache, dt, Hkv)
    for sq, offset in ((5, 0), (5, 123), (40, 77)):
        q = torch.randn(B, sq, H, hd, generator=gen,
                        device=dev).to(dt).transpose(1, 2)
        want = flash_attn.flash_attention(q, k, v, offset, mode=regime)
        for off in (torch.tensor(offset, device=dev),
                    torch.tensor([offset], dtype=torch.int32, device=dev)):
            got = flash_attn.flash_attention(q, k, v, off, mode=regime)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (sq, offset)
        plain = flash_attn.flash_attention_plain(
            q, k, v, torch.tensor([offset], device=dev))
        tol = TOL_ATTN_BF16 * float(v.float().abs().max()) if (
            regime == "bf16") else 1e-4
        assert float((want - plain).abs().max()) <= tol


@pytest.mark.parametrize("mode", ["exact", "bf16"])
def test_captured_verify_window_replays_at_any_position(dev, mode):
    """A verify window (prefill at a device start: K3's offset and the
    cache write read from the card) captured once and replayed at three
    positions equals the eager window at each position, logits and cache
    bit for bit."""
    from squeezellm_tpu_torch import graphs

    model = _tiny_llama(dev)
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    kw = dict(dtype=dt, mode=mode)
    c = model.config
    cache = common.init_kv_cache(1, 128, c.n_layers, c.n_kv_heads,
                                 c.head_dim, dt, dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():
        model.prefill(torch.randint(0, 512, (1, 40), generator=gen,
                                    device=dev), cache, **kw)
        win = torch.zeros((1, 5), dtype=torch.long, device=dev)
        start = torch.zeros(1, dtype=torch.long, device=dev)
        out = torch.zeros((1, 5, c.vocab_size), device=dev)

        def body():
            out.copy_(model.prefill(win, cache, start=start,
                                    all_logits=True, **kw))

        step = graphs.StepGraph(body, dev)
        for p in (40, 43, 51, 60):
            w = torch.randint(0, 512, (1, 5), generator=gen, device=dev)
            ref_cache = [{n: t.clone() for n, t in lc.items()}
                         for lc in cache]
            ref = model.prefill(w, ref_cache, start=p, all_logits=True, **kw)
            win.copy_(w)
            start.fill_(p)
            step()
            torch.cuda.synchronize()
            assert torch.equal(out, ref), p
            for a, b_ in zip(cache, ref_cache):
                assert all(torch.equal(a[n], b_[n]) for n in a), p
    assert step.graph is not None and step.replays == 3


def test_graph_replays_after_the_workspaces_grow(dev):
    """A graph captured while K11's partials and K12's copy of x are small
    replays the same tokens after calls at larger shapes replaced those
    workspaces (and K1's tile counters): the old buffers stay alive."""
    model = fuse.attach_decode_luts(_tiny_llama(dev), transposed=True)
    prompt = np.array([[5, 9, 200, 31], [7, 77, 101, 3]])
    stores = (lut_matmul._COUNTERS, lut_matmul_t._WORKSPACE, spmv._WORKSPACE)
    for store in stores:  # start from the tiny model's own sizes
        lut_matmul.RETIRED.extend(store.values())
        store.clear()
    want = engine.Engine(model, graphs=False).generate(prompt, 12)
    eng = engine.Engine(model)
    np.testing.assert_array_equal(eng.generate(prompt, 12), want)
    held = [dict(s) for s in stores]
    assert held[1] and held[2]  # the graph holds K11's and K12's
    g = torch.Generator(device=dev).manual_seed(1)
    in_f, out_f = 4096, 32000
    nw = lut_matmul.formats.n_words(in_f, 4)
    qw = torch.randint(-2**31, 2**31 - 1, (nw, out_f), generator=g,
                       dtype=torch.int64, device=dev).to(torch.int32)
    lut = torch.randn(out_f, 16, generator=g, device=dev)
    lut_matmul.lut_matmul(torch.randn(1023, in_f, generator=g, device=dev),
                          qw, lut, 4, variant="gemv")
    lut_matmul_t.lut_matmul_t(torch.randn(8, in_f, generator=g, device=dev),
                              qw.t().contiguous(), lut)
    rowptr = torch.ones(17, dtype=torch.int32, device=dev)
    rowptr[0] = 0
    spmv.spmv(torch.randn(8, 11008, generator=g, device=dev), rowptr,
              torch.zeros(1, dtype=torch.int32, device=dev),
              torch.ones(1, device=dev), 16)
    for old, store in zip(held, stores):
        for d, t in old.items():
            assert store[d] is not t
            assert any(r is t for r in lut_matmul.RETIRED)
    np.testing.assert_array_equal(eng.generate(prompt, 12), want)


def test_tiny_model_graphs_match_eager(dev):
    """Every step program of the Engine and of the paged engine, captured
    and replayed, gives the eager steps' tokens, and the launch counts
    (replays included) equal the eager run's."""
    from squeezellm_tpu_torch import graphs

    model = _tiny_llama(dev)
    prompt = np.array([[5, 9, 200, 31, 5, 9, 200]])
    sp = dict(temperature=0.8, top_k=40, top_p=0.95, seed=7)

    def runs(graphed):
        eng = engine.Engine(model, graphs=graphed)
        draft = engine.Engine(engine.truncate_for_draft(model, 1),
                              graphs=graphed)
        before = graphs.read_counts()
        out = [eng.generate(prompt, 12), eng.generate(prompt, 12, **sp),
               eng.generate_speculative(prompt, 12, draft_len=3),
               eng.generate_draft_speculative(prompt, 12, draft,
                                              draft_len=3)]
        for kw in ({}, {"speculative": (3, 2)}):
            paged = serving.PagedContinuousBatchEngine(
                model, slots=3, n_pages=40, page_size=16,
                cache_dtype=torch.float32, graphs=graphed, **kw)
            out.append(paged.run([[1, 2, 3], [4, 5, 4, 5, 4], [9] * 20],
                                 max_new_tokens=10, window=4))
        out.append(serving.PagedContinuousBatchEngine(
            model, slots=3, n_pages=40, page_size=16, seed=2,
            cache_dtype=torch.float32, graphs=graphed).run(
                [[1, 2, 3], [4, 5, 6]], max_new_tokens=8,
                sampling=SamplingParams(temperature=0.8, top_k=40)))
        return out, graphs.count_increase(before, graphs.read_counts())

    eager, eager_counts = runs(False)
    graphed, graphed_counts = runs(True)
    for a, b_ in zip(eager, graphed):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b_)
        else:
            assert a == b_
    np.testing.assert_array_equal(eager[2], eager[0])
    np.testing.assert_array_equal(eager[3], eager[0])
    assert graphed_counts == eager_counts
