"""The sparse-expert model (``models/moe.py``, Mellum 2) on the CPU, at a
tiny size: hidden 64, 4 query heads of head_dim 32, 2 kv heads, 8 experts
with 2 a token of width 24, 4 layers (sliding, sliding, sliding, full),
window 8, yarn on the full layer. The port is built from the benchmark's
seeded raw weights (``port_bench/families/mellum.py``) and held to the
benchmark's plain reference (``port_bench/reference/mellum.py``), which
imports neither the port nor JAX; then routing, yarn, K13's tile map and
plain version, the counters, the configuration parsing and the CLI."""

import json
import math
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(REPO, "port_bench")
if HARNESS not in sys.path:
    sys.path.insert(0, HARNESS)

from pbench import check, spec  # noqa: E402
from reference import mellum as ref  # noqa: E402

from squeezellm_tpu_torch import cli, serving  # noqa: E402
from squeezellm_tpu_torch.models import common, llama, moe, registry  # noqa
from squeezellm_tpu_torch.ops import lut_matmul, moe_lut  # noqa: E402

YARN = {"rope_type": "yarn", "rope_theta": 500000, "factor": 16,
        "original_max_position_embeddings": 256, "beta_fast": 32,
        "beta_slow": 1, "attention_factor": 1.2772588722239782}
TINY = {
    "model_type": "mellum", "vocab_size": 256, "hidden_size": 64,
    "intermediate_size": 96, "num_hidden_layers": 4,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
    "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
    "mlp_layer_types": ["sparse"] * 4, "moe_intermediate_size": 24,
    "num_experts": 8, "num_experts_per_tok": 2, "norm_topk_prob": True,
    "rms_norm_eps": 1e-6, "sliding_window": 8,
    "max_position_embeddings": 4096, "tie_word_embeddings": False,
    "rope_parameters": {"full_attention": YARN,
                        "sliding_attention": {"rope_type": "default",
                                              "rope_theta": 500000}},
    "quant": {"bits": 4, "sparsity": 0.0045, "topx": 4},
    "serve": {"activations": "float32", "kv_cache": "float32",
              "mode": "exact"}}
SEED = 2**31 + 19
# f32 on both sides, the same dequantized weights: the port and the
# reference differ only in the order of their sums (K1's plain fold, the
# f64 top-X and router products, attention in blocks), ~1e-6 of logits of
# deviation ~2; 1e-4 leaves room for 28 such layers' worth of growth and
# is far below a routing or rope mistake (whole experts or rotations)
TOL_LOGITS = 1e-4


@pytest.fixture(scope="module")
def family():
    return spec.family(TINY)


@pytest.fixture(scope="module")
def model(family):
    return family.build_model(TINY, SEED, "cpu")


def _prompt(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (n,), generator=g).tolist()


def test_port_plain_matches_the_reference(model):
    """Whole sequences past the window through the port's plain versions
    and through the reference, on the same seeded weights."""
    seqs = [_prompt(21, 1), _prompt(13, 2)]
    want = ref.logits(TINY, SEED, seqs, [0, 0], "cpu")
    for s, w in zip(seqs, want):
        got = model(torch.tensor([s]), plain=True)[0]
        assert float((got - w).abs().max()) <= TOL_LOGITS


def test_paged_prefill_then_decode_matches_the_reference(model):
    """Paged prefill then greedy decode past the window (prompts of 5 and
    11 rows, 14 tokens each, pages of 16 rows), the served tokens held to
    the reference's full forward as the benchmark's check holds them: each
    served token's reference logit within TOL_LOGITS of the best (greedy
    in f32, so only the order of sums separates them); and the counters:
    every decode step routes its slots' 2 pairs in each of 4 layers."""
    eng = serving.PagedContinuousBatchEngine(
        model, slots=2, n_pages=8, page_size=16, dtype=torch.float32,
        cache_dtype=torch.float32, mode="exact", max_seq=48, graphs=False)
    prompts = [_prompt(5, 3), _prompt(11, 4)]
    res = eng.run(prompts, max_new_tokens=14, window=4)
    served = [res[i] for i in range(2)]
    seqs = [p + s[:-1] for p, s in zip(prompts, served)]
    ref_logits = ref.logits(TINY, SEED, seqs, [len(p) - 1 for p in prompts],
                            "cpu")
    for lg, s in zip(ref_logits, served):
        assert float(check.gaps(lg, torch.tensor(s)).max()) <= TOL_LOGITS
    steps = eng.stats["decode_steps"]
    assert eng.stats["moe_pairs"] == steps * 4 * 2 * 2
    assert 0 < eng.stats["moe_experts_read"] <= steps * 4 * 4


def test_routing_ties_and_renormalisation():
    """Equal router rows tie: the lower expert wins; the top-k weights sum
    to 1; pairs sorted by expert, then token; offsets and inv agree."""
    g = torch.Generator().manual_seed(7)
    router = torch.randn(6, 16, generator=g)
    router[4] = router[1]  # experts 1 and 4 always tie
    router[5] = router[1]
    h = torch.randn(9, 16, generator=g)
    h[0] = router[1] * 3  # token 0 prefers expert 1 (= 4 = 5) by far
    r = moe.route(h, router, 2, True)
    ids = torch.empty(9, 2, dtype=torch.long)
    key = torch.empty(18, dtype=torch.long)
    off = r.offsets.tolist()
    for e in range(6):
        key[off[e]:off[e + 1]] = e
    assert torch.equal(key, key.sort().values)
    for e in range(6):
        toks = r.tok[off[e]:off[e + 1]]
        assert torch.equal(toks, toks.sort().values)
    ids = key[r.inv]
    assert ids[0].tolist() == [1, 4]  # the tie: lower expert first
    assert torch.equal(r.tok[r.inv], torch.arange(9)[:, None].expand(9, 2))
    torch.testing.assert_close(r.weights.sum(1), torch.ones(9))
    p = torch.softmax(h.double() @ router.double().t(), -1).float()
    top = p.gather(1, ids)
    torch.testing.assert_close(r.weights, top / top.sum(1, keepdim=True))
    want_ids, want_w = ref.route(h, router, 2, True)
    assert torch.equal(ids, want_ids)
    torch.testing.assert_close(r.weights, want_w)


def test_yarn_frequencies_match_the_formula():
    """The port's yarn frequencies and factor against the reference's and
    against the formula at Mellum2's published numbers (head_dim 128,
    theta 5e5, factor 16 over 8192 positions, beta 32 / 1): the ramp runs
    from dim 18 (floor 18.08) to 35 (ceil 34.98)."""
    pub = dict(YARN, original_max_position_embeddings=8192)
    spec_ = common.RopeSpec.from_hf(pub)
    got, af = common.yarn_inv_freq(128, spec_)
    want, want_af = ref.inv_freq(128, pub)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert af == want_af == pytest.approx(0.1 * math.log(16) + 1)
    own = 1.0 / 500000.0 ** (torch.arange(0, 128, 2).double() / 128)
    torch.testing.assert_close(got[:19].double(), own[:19], rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(got[35:].double(), own[35:] / 16, rtol=1e-6,
                               atol=0)
    ramp = (torch.arange(64).double() - 18) / 17
    mid = own / 16 * ramp + own * (1 - ramp)
    torch.testing.assert_close(got[19:35].double(), mid[19:35], rtol=1e-5,
                               atol=0)
    pos = torch.arange(5)
    cos, sin = common.rope_cos_sin_spec(pos, 128, spec_)
    ang = pos.float()[:, None] * got
    torch.testing.assert_close(cos[:, :64], torch.cos(ang) * af)
    torch.testing.assert_close(sin[:, 64:], torch.sin(ang) * af)


def test_k13_plain_and_tile_map():
    """K13's plain version equals K1's plain version expert by expert
    (with the top-X rows), and its tile map covers each expert's rows in
    tiles of its own (-1 past them), whatever experts are empty."""
    g = torch.Generator().manual_seed(3)
    from squeezellm_tpu_torch import synthetic

    lins = [synthetic.random_quant_linear(g, "cpu", 40, 48, 4, 0.05, 3)
            for _ in range(5)]
    ex = moe.Experts.stack(lins)
    counts = [3, 0, 7, 1, 0]
    offsets = torch.tensor([0] + counts).cumsum(0).to(torch.int32)
    x = torch.randn(sum(counts), 48, generator=g)
    r = moe.Route(tok=torch.zeros(0), offsets=offsets, inv=None,
                  weights=None, k=1)
    got = ex(x, r, mode="bf16", plain=True)
    for e, lin in enumerate(lins):
        a, b = int(offsets[e]), int(offsets[e + 1])
        if b > a:
            want = lin(x[a:b], mode="bf16", plain=True).float()
            torch.testing.assert_close(got[a:b], want, rtol=1e-5, atol=1e-6)
        back = ex.expert(e).tensors()
        for name, t in lin.tensors().items():
            assert torch.equal(back[name], t), name
    for tile in (2, 8, 64):
        n = moe_lut.n_tiles(5, 7, sum(counts), tile)
        tiles = moe_lut.tile_map(offsets, n, tile)
        rows = {}
        for z in range(n):
            e, first = tiles[:, z].tolist()
            if e < 0:
                continue
            rows.setdefault(e, []).extend(
                range(first, min(first + tile, int(offsets[e + 1]))))
        assert {e: v for e, v in rows.items()} == {
            e: list(range(int(offsets[e]), int(offsets[e + 1])))
            for e in range(5) if counts[e]}
        assert n >= sum(-(-c // tile) for c in counts)


def test_fuse_experts_matches_fusing_each_expert():
    """gate|up fused on the stacked tensors equals each expert's gate and
    up through ``fuse_linears``, stacked again: bit for bit, with experts
    whose sidecar is empty among them."""
    from squeezellm_tpu_torch import synthetic
    from squeezellm_tpu_torch.models import fuse

    g = torch.Generator().manual_seed(4)
    gates = [synthetic.random_quant_linear(g, "cpu", 24, 40, 4, sp, 3)
             for sp in (0.05, 0.0, 0.02, 0.05)]
    ups = [synthetic.random_quant_linear(g, "cpu", 24, 40, 4, sp, 2)
           for sp in (0.03, 0.04, 0.0, 0.05)]
    ex = torch.nn.ModuleDict({"gate": moe.Experts.stack(gates),
                              "up": moe.Experts.stack(ups)})
    fuse.fuse_experts(ex)
    want = moe.Experts.stack([fuse.fuse_linears([a, b])
                              for a, b in zip(gates, ups)])
    assert sorted(ex) == ["gateup"]
    assert ex["gateup"].spec == want.spec
    got = ex["gateup"].tensors()
    assert sorted(got) == sorted(want.tensors())
    for name, t in want.tensors().items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


def test_k13_plans_fix_the_split_by_shape():
    """The k-split follows the shape and the experts a row chooses; at
    Mellum2's widths (gate|up 1792 x 2304, down 2304 x 896, 8 a token)."""
    assert moe_lut.plan(2304, 1792, 4, "dec", 8).splits == 2
    assert moe_lut.plan(896, 2304, 4, "dec", 8).splits == 1
    assert moe_lut.plan(2304, 1792, 4, "mma", 8).splits == 2
    for v in ("dec", "mma"):
        p = moe_lut.plan(2304, 1792, 4, v, 8)
        assert p.splits * p.words_per_split >= 288
        assert p.words_per_split % 8 == 0
    assert moe_lut.row_tile(1, "dec") == 8
    assert moe_lut.row_tile(16, "dec") == 16
    assert moe_lut.row_tile(40, "mma") == lut_matmul.MMA_ROW_TILE


def test_dense_configs_parse_as_before():
    """Mistral's and the dense LLaMA's configurations parse to what they
    did: head_dim hidden / heads, one window and one rope for every layer,
    and the manifest holds the JAX package's fields only."""
    with open(os.path.join(HARNESS, "configs", "mistral-7b-w4.json")) as f:
        hf = json.load(f)
    c = llama.LlamaConfig.from_hf_config(hf)
    assert (c.head_dim, c.sliding_window, c.rope_theta, c.layer_types,
            c.ropes) == (128, 4096, 10000.0, None, None)
    assert (c.window(None), c.rope(None)) == (4096,
                                              common.RopeSpec(10000.0))
    assert c.linear_shapes()["q"] == (4096, 4096)
    assert set(c.manifest()) == {
        "vocab_size", "hidden_size", "intermediate_size", "n_layers",
        "n_heads", "n_kv_heads", "rope_theta", "rms_eps", "max_seq",
        "sliding_window", "tie_embeddings"}
    assert llama.LlamaConfig(**c.manifest()) == c
    m = registry.config_class("mellum").from_hf_config(TINY)
    assert (m.head_dim, m.window("full_attention"),
            m.window("sliding_attention")) == (32, None, 8)
    assert m.rope("full_attention").factor == 16
    assert m.linear_shapes()["q"] == (128, 64)


def test_serve_bench_builds_the_synthetic_model(tmp_path, capsys):
    """``serve-bench --synthetic`` builds the sparse-expert model from a
    config.json (``synthetic.quantized_mellum``) and serves it paged."""
    cfg = {k: v for k, v in TINY.items() if k not in ("quant", "serve")}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    cli.main(["serve-bench", "--synthetic", str(tmp_path / "config.json"),
              "--wbits", "4", "--device", "cpu", "--paged", "--page-size",
              "16", "--requests", "3", "--max-new-tokens", "4", "--slots",
              "2", "--seqlen", "48", "--window", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["total_tokens"] == 3 * 4
