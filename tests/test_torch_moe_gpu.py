"""K13 (``ops/moe_lut``) on the card at Mellum2's widths: 64 experts of
gate|up 1792 x 2304 (fused, 20 top-X rows) and down 2304 x 896 (10 top-X
rows), every one Dense-and-Sparse with its 0.45% sidecar. Against its plain
version and against K1's decode kernel called expert by expert; a row's
bits whatever rows share its launch or its expert; empty experts, every
row on one expert, 1 to 40 rows; one captured graph replayed under other
routings; the combine; and a tiny sparse-expert model served graphed
against its eager run.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. On the card:
``python -m pytest tests/test_torch_moe_gpu.py -m gpu``."""

import pytest
import torch

from squeezellm_tpu_torch import serving, synthetic
from squeezellm_tpu_torch.models import fuse, moe
from squeezellm_tpu_torch.ops import lut_matmul, moe_lut, plain_ops

pytestmark = pytest.mark.gpu

HIDDEN, WIDTH, EXPERTS, TOP_K = 2304, 896, 64, 8
# K1's bf16 tolerance against its plain version (chip_smoke.TOL_K1): the
# kernel's f32 sums in another order than the plain matmul's
TOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def layer(dev):
    """One layer's stacked experts at Mellum2's widths, gate|up fused."""
    g = torch.Generator(device=dev).manual_seed(19)

    def lin(o, i):
        return synthetic.random_quant_linear(g, dev, o, i, 4, 0.0045, 10)

    ex = {"gate": moe.Experts.stack([lin(WIDTH, HIDDEN)
                                     for _ in range(EXPERTS)]),
          "up": moe.Experts.stack([lin(WIDTH, HIDDEN)
                                   for _ in range(EXPERTS)]),
          "down": moe.Experts.stack([lin(HIDDEN, WIDTH)
                                     for _ in range(EXPERTS)])}
    fuse.fuse_experts(ex)
    return ex


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _route(dev, T, seed, one_expert=None, n_experts=EXPERTS):
    """A routing of T rows, k each (one_expert: every row's first choice
    that expert); only ``n_experts`` of the experts reachable."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(T, HIDDEN, generator=g, device=dev)
    router = torch.randn(EXPERTS, HIDDEN, generator=g, device=dev)
    if n_experts < EXPERTS:  # the others' logits ~ -1000 along u
        u = torch.ones(HIDDEN, device=dev) / HIDDEN ** 0.5
        router[:n_experts] -= (router[:n_experts] @ u)[:, None] * u
        router[n_experts:] = -10 * u
        h = h + 100 * u
    if one_expert is not None:
        h = h + 50 * router[one_expert]
    return h.to(torch.bfloat16), router


def _run(ex, x, r, variant, plain=False):
    t = ex.tensors()
    kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"], vals=t["sp_vals"],
              topx_weights=t["topx_weights"],
              topx_indices=t["topx_indices"], mode="bf16")
    if plain:
        return moe_lut.moe_lut_matmul_plain(x, r.offsets, t["qweight"],
                                            t["lut"], 4, **kw)
    return moe_lut.moe_lut_matmul(x, r.offsets, t["qweight"], t["lut"], 4,
                                  variant=variant, tiles=r.tiles,
                                  row_tile=r.row_tile, per_row=r.k, **kw)


def _routed(dev, T, variant, seed, **kw):
    h, router = _route(dev, T, seed, **kw)
    r = moe.route(h, router, TOP_K, True, moe_lut.row_tile(T, variant))
    return h.index_select(0, r.tok).contiguous(), r


@pytest.mark.parametrize("variant", ["dec", "mma"])
@pytest.mark.parametrize("T,case", [(1, "random"), (3, "random"),
                                    (16, "random"), (40, "random"),
                                    (16, "one"), (5, "few")])
def test_k13_matches_plain_and_k1(dev, layer, variant, T, case):
    """gate|up and down through K13 against the plain version and against
    K1's kernel (``variant``'s) on each expert's linear with its top-X
    rows, within K1's tolerance; "one": every row's first choice one
    expert; "few": only 9 experts reachable, the rest empty."""
    kw = {"one": dict(one_expert=5), "few": dict(n_experts=9)}.get(case, {})
    x, r = _routed(dev, T, variant, seed=T, **kw)
    for name, xin in (("gateup", x),
                      ("down", torch.randn(x.shape[0], WIDTH, device=dev)
                       .to(torch.bfloat16))):
        ex = layer[name]
        got = _run(ex, xin, r, variant)
        want = _run(ex, xin, r, variant, plain=True)
        torch.cuda.synchronize()
        assert _rel(got, want) <= TOL, (name, _rel(got, want))
        off = r.offsets.tolist()
        for e in range(EXPERTS):
            if off[e + 1] == off[e]:
                continue
            t = ex.expert(e).tensors()
            xe = xin[off[e]:off[e + 1]].contiguous()
            y = lut_matmul.lut_matmul(
                xe, t["qweight"], t["lut"], 4, rowptr=t["sp_rowptr"],
                cols=t["sp_cols"], vals=t["sp_vals"], mode="bf16",
                variant=variant)
            y = plain_ops.hybrid_matmul(xe, t["topx_weights"],
                                        t["topx_indices"], y.shape[1],
                                        base=y)
            assert _rel(got[off[e]:off[e + 1]], y) <= TOL, (name, e)
    if case == "few":
        assert int((r.offsets[1:] > r.offsets[:-1]).sum()) <= 9


@pytest.mark.parametrize("variant", ["dec", "mma"])
def test_k13_rows_do_not_depend_on_their_company(dev, layer, variant):
    """Token 0's gate|up rows are bit-equal alone (8 pairs) and among 15
    other tokens (its experts shared with other rows, its rows at other
    places of their tiles)."""
    h, router = _route(dev, 16, 3)
    outs = []
    for T in (1, 16):
        r = moe.route(h[:T], router, TOP_K, True,
                      moe_lut.row_tile(T, variant))
        x = h[:T].index_select(0, r.tok).contiguous()
        y = _run(layer["gateup"], x, r, variant)
        outs.append(y[r.inv[0]])
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_k13_graph_replays_other_routings(dev, layer):
    """A decode-shaped layer (route, K13 gate|up and down, combine) captured
    once and replayed under three other routings equals its eager run."""
    T = 16
    g = torch.Generator(device=dev).manual_seed(5)
    router = torch.randn(EXPERTS, HIDDEN, generator=g, device=dev) * 0.03
    hbuf = torch.zeros(T, HIDDEN, device=dev, dtype=torch.bfloat16)
    out = torch.zeros(T, HIDDEN, device=dev, dtype=torch.bfloat16)

    def body():
        r = moe.route(hbuf, router, TOP_K, True, moe_lut.row_tile(T, "dec"))
        x = hbuf.index_select(0, r.tok)
        gu = _run(layer["gateup"], x.contiguous(), r, "dec").to(
            torch.bfloat16)
        a = torch.nn.functional.silu(gu[:, :WIDTH]) * gu[:, WIDTH:]
        d = _run(layer["down"], a.contiguous(), r, "dec")
        out.copy_(moe_lut.moe_combine(d, r.inv, r.weights, hbuf))

    hbuf.copy_(torch.randn(T, HIDDEN, generator=g, device=dev))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(3):
        hbuf.copy_(torch.randn(T, HIDDEN, generator=g, device=dev))
        graph.replay()
        got = out.clone()
        body()
        torch.cuda.synchronize()
        assert torch.equal(got, out)


def test_combine_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    T, k, n = 7, TOP_K, HIDDEN
    d = torch.randn(T * k, n, generator=g, device=dev)
    inv = torch.randperm(T * k, generator=g, device=dev).view(T, k)
    w = torch.rand(T, k, generator=g, device=dev)
    res = torch.randn(T, n, generator=g, device=dev).to(torch.bfloat16)
    for r in (res, None, res.float()):
        got = moe_lut.moe_combine(d, inv, w, r)
        want = moe_lut.moe_combine_plain(d, inv, w, r)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_tiny_sparse_expert_model_served_graphed(dev):
    """A tiny sparse-expert model in bf16 mode: the paged engine's graphed
    decode steps give its eager run's tokens, and K13 ran."""
    from squeezellm_tpu_torch.models import moe as moe_mod

    cfg = moe_mod.MoEConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512, n_layers=4,
        n_heads=4, n_kv_heads=2, head_dim=64, max_seq=256,
        sliding_window=16, rope_theta=5e5,
        layer_types=("sliding_attention",) * 3 + ("full_attention",),
        n_experts=16, top_k=4, expert_size=128)
    model = fuse.fuse_for_decode(synthetic.quantized_mellum(
        cfg, 4, seed=3, device=dev))
    prompts = [[5, 9, 2] * 7, [11, 3] * 20, [7] * 9]
    toks = []
    before = dict(moe_lut.moe_lut_matmul.variant_launches)
    for graphs in (False, True):
        eng = serving.PagedContinuousBatchEngine(
            model, slots=3, n_pages=12, page_size=32,
            dtype=torch.bfloat16, cache_dtype=torch.bfloat16, mode="bf16",
            max_seq=96, graphs=graphs)
        toks.append(eng.run(prompts, max_new_tokens=20, window=4))
        assert eng.stats["moe_pairs"] > 0
    assert toks[0] == toks[1]
    after = moe_lut.moe_lut_matmul.variant_launches
    assert after["dec"] > before["dec"] and after["mma"] > before["mma"]
