"""The port's whole LLaMA path against the JAX package (backend 'xla',
f32) on one random Dense-and-Sparse tree: prefill and decode logits within
1e-4 and 16 greedy tokens identical. The tree reaches the port through
`checkpoint.save_quantized` -> `load_quantized`, through `carry.from_tree`
(unfused, fused by the port, and fused by the JAX package), on a GQA
config and a sliding-window config."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from squeezellm_tpu import checkpoint as jcheckpoint
from squeezellm_tpu import engine as jengine
from squeezellm_tpu import formats as jformats
from squeezellm_tpu.models import common as jcommon
from squeezellm_tpu.models import fuse as jfuse
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.ops.quant_linear import QuantLinearSpec
from squeezellm_tpu_torch import carry, checkpoint, engine
from squeezellm_tpu_torch.models import fuse as fuse_mod
from squeezellm_tpu_torch.models import llama

ATOL = 1e-4  # logits, f32 on both sides
PROMPT = np.array([[3, 141, 59, 26, 5]], np.int32)
NEW_TOKENS = 16
N_DECODE_LOGITS = 4

CONFIGS = {
    "gqa": (jllama.LlamaConfig(vocab_size=256, hidden_size=128,
                               intermediate_size=256, n_layers=2, n_heads=4,
                               n_kv_heads=2, max_seq=64), 4),
    "window": (jllama.LlamaConfig(vocab_size=256, hidden_size=128,
                                  intermediate_size=256, n_layers=2,
                                  n_heads=4, n_kv_heads=2, max_seq=64,
                                  sliding_window=8), 3),
}


def _quant(rng, o, i, bits, sparse=True, topx=2):
    nw = jformats.n_words(i, bits)
    p = {"qweight": rng.integers(-2**31, 2**31, (nw, o),
                                 dtype=np.int64).astype(np.int32),
         "lut": np.sort(rng.standard_normal((o, 2**bits)).astype(np.float32)
                        * 0.1, axis=1)}
    nnz_pad = 0
    if sparse:
        dense = np.zeros((o, i), np.float32)
        mask = rng.random((o, i)) < 0.01
        dense[mask] = rng.standard_normal(mask.sum()).astype(np.float32) * 0.3
        coo = jformats.SparseCOO.from_dense(dense, pad_multiple=64)
        p.update(sp_rows=coo.rows, sp_cols=coo.cols, sp_vals=coo.vals)
        nnz_pad = len(coo.vals)
    if topx:
        p["topx_weights"] = (rng.standard_normal((i, topx))
                             .astype(np.float32) * 0.1)
        p["topx_indices"] = rng.choice(o, topx, replace=False).astype(np.int32)
    spec = jcommon.LinearSpec(
        in_features=i, out_features=o,
        quant=QuantLinearSpec(bits=bits, in_features=i, out_features=o,
                              nnz_pad=nnz_pad, topx=topx))
    return spec, p


def _jax_tree(config, bits, seed=0, sparse=True):
    """Random quantized tree in the JAX package's format (numpy)."""
    rng = np.random.default_rng(seed)
    h = config.hidden_size
    spec_layers, layers = [], []
    for _ in range(config.n_layers):
        sd, pd = {}, {}
        for name, (o, i) in config.linear_shapes().items():
            sd[name], pd[name] = _quant(rng, o, i, bits, sparse=sparse)
        pd["input_norm"] = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
        pd["post_norm"] = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
        spec_layers.append(sd)
        layers.append(pd)
    head_spec, head = _quant(rng, config.vocab_size, h, bits, sparse=False,
                             topx=0)
    params = {
        "embed": rng.standard_normal((config.vocab_size, h)).astype(np.float32),
        "layers": layers,
        "final_norm": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
        "lm_head": head,
    }
    return {"layers": tuple(spec_layers), "lm_head": head_spec}, params


def _module_meta(specs):
    """The manifest's per-module dict, as checkpoint.save_quantized writes
    it."""
    meta = {}

    def one(ls):
        m = {"has_bias": ls.has_bias, "quant": ls.is_quant}
        if ls.is_quant:
            m.update(bits=ls.quant.bits, topx=ls.quant.topx,
                     nnz_pad=ls.quant.nnz_pad)
        return m

    for li, sd in enumerate(specs["layers"]):
        for name, ls in sd.items():
            meta[f"{li}.{name}"] = one(ls)
    meta["lm_head"] = one(specs["lm_head"])
    return meta


def _jax_reference(config, specs, params):
    """Greedy tokens, prefill logits and the first decode logits."""
    eng = jengine.Engine("llama", config, specs,
                         jax.tree.map(jnp.asarray, params), backend="xla")
    tokens = eng.generate(PROMPT, NEW_TOKENS)
    cache = eng.new_cache(1)
    logits, cache = eng._prefill(eng.params, jnp.asarray(PROMPT), cache)
    rows = [np.asarray(logits[0, -1])]
    for i in range(N_DECODE_LOGITS):
        pos = PROMPT.shape[1] + i
        lg, cache = eng._decode(eng.params,
                                jnp.asarray(tokens[:, pos: pos + 1]),
                                jnp.asarray(pos, jnp.int32), cache)
        rows.append(np.asarray(lg[0, -1]))
    full = np.asarray(jllama.forward(config, specs,
                                     jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(tokens), backend="xla"))
    return tokens, np.stack(rows), full


def _port_logits(eng, tokens):
    cache = eng.new_cache(1)
    prompt = torch.from_numpy(PROMPT).long()
    rows = [eng.model.prefill(prompt, cache)[0, -1]]
    for i in range(N_DECODE_LOGITS):
        pos = PROMPT.shape[1] + i
        tok = torch.tensor(tokens[:, pos: pos + 1], dtype=torch.long)
        rows.append(eng.model.decode_step(tok, pos, cache)[0, -1])
    return torch.stack(rows).numpy()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def reference(request, tmp_path_factory):
    config, bits = CONFIGS[request.param]
    specs, params = _jax_tree(config, bits)
    ckpt = tmp_path_factory.mktemp(f"ckpt_{request.param}")
    jcheckpoint.save_quantized(str(ckpt), "llama", config, specs, params)
    return dict(config=config, specs=specs, params=params, ckpt=str(ckpt),
                want=_jax_reference(config, specs, params))


def _port_model(ref, route):
    config, specs, params = ref["config"], ref["specs"], ref["params"]
    cfg = dataclasses.asdict(config)
    if route == "checkpoint":
        model_type, model = checkpoint.load_quantized(ref["ckpt"], "cpu")
        assert model_type == "llama"
        return model, False
    if route == "jax-fused":
        fspecs, fparams = jfuse.fuse_for_decode("llama", specs, params)
        model = carry.from_tree("llama", cfg, _module_meta(fspecs), fparams,
                                "cpu")
        assert "qkv" in model.layers[0].attn.proj
        return model, False
    model = carry.from_tree("llama", cfg, _module_meta(specs), params, "cpu")
    return model, route == "port-fused"


@pytest.mark.parametrize("route", ["checkpoint", "carry", "port-fused",
                                   "jax-fused"])
def test_port_matches_jax(reference, route):
    tokens_want, logits_want, full_want = reference["want"]
    model, fuse = _port_model(reference, route)
    assert isinstance(model, llama.Llama)
    if fuse:
        fuse_mod.fuse_for_decode(model)
        assert set(model.layers[0].attn.proj) == {"qkv", "o"}
        assert set(model.layers[0].mlp.proj) == {"gateup", "down"}
    eng = engine.Engine(model)
    np.testing.assert_array_equal(eng.generate(PROMPT, NEW_TOKENS),
                                  tokens_want)
    np.testing.assert_allclose(_port_logits(eng, tokens_want), logits_want,
                               rtol=0, atol=ATOL)
    full = model.forward(torch.tensor(tokens_want, dtype=torch.long))
    np.testing.assert_allclose(full.numpy(), full_want, rtol=0, atol=ATOL)


def test_engine_refuses_sampling():
    """The engine samples (tests/test_torch_engine.py); it refuses the
    sampling parameters the on-device sampler cannot honour, as
    SamplingParams does."""
    config, bits = CONFIGS["gqa"]
    specs, params = _jax_tree(config, bits, seed=1)
    model = carry.from_tree("llama", dataclasses.asdict(config),
                            _module_meta(specs), params, "cpu")
    with pytest.raises(ValueError, match="top_k"):
        engine.Engine(model).generate(PROMPT, 2, temperature=0.7, top_k=65)
    with pytest.raises(ValueError, match="top_p"):
        engine.Engine(model).generate(PROMPT, 2, temperature=0.7, top_p=0.0)


def test_benchmark_checks_perplexity_only_when_asked(monkeypatch):
    """Engine.benchmark keeps the JAX protocol's `check` switch: by default
    the timed loop runs the decode steps alone (no log-softmax, no
    check_ppl), with check=True it also gives the fed sequence's
    next-token perplexity, that of the teacher-forced logits."""
    config, bits = CONFIGS["gqa"]
    specs, params = _jax_tree(config, bits, seed=1)
    model = carry.from_tree("llama", dataclasses.asdict(config),
                            _module_meta(specs), params, "cpu")
    eng = engine.Engine(model)
    ids = np.arange(10)[None] * 7 % config.vocab_size
    calls = []
    inner = torch.log_softmax

    def spy(*args, **kw):
        calls.append(1)
        return inner(*args, **kw)

    monkeypatch.setattr(torch, "log_softmax", spy)
    stats = eng.benchmark(ids, max_seq=32)
    assert "check_ppl" not in stats and not calls
    assert stats["tokens"] == 10 and stats["tokens_per_s"] > 0
    checked = eng.benchmark(ids, max_seq=32, check=True)
    # one log-softmax a step run: the first call, the warmup steps and the
    # timed ones (the step masks the last position's term on the device)
    assert len(calls) == ids.shape[1] + 1 + engine.WARMUP_STEPS
    monkeypatch.undo()
    logits = eng.teacher_forced_logits(ids, max_seq=32)
    nll = -torch.log_softmax(logits[:-1], -1).gather(
        1, torch.as_tensor(ids[0, 1:])[:, None]).mean()
    np.testing.assert_allclose(checked["check_ppl"], float(torch.exp(nll)),
                               rtol=1e-5)
