"""The port's OPT path against the JAX package (backend 'xla', f32) on one
random Dense-and-Sparse OPT tree with biases: full-sequence logits within
1e-4 of max |logit|, prefill and decode logits, and 16 greedy tokens
identical. The tree reaches the port through `checkpoint.save_quantized`
-> `load_quantized` and through `carry.from_tree` (unfused, q|k|v fused by
the port, and fused by the JAX package)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from squeezellm_tpu import checkpoint as jcheckpoint
from squeezellm_tpu import engine as jengine
from squeezellm_tpu.models import common as jcommon
from squeezellm_tpu.models import fuse as jfuse
from squeezellm_tpu.models import opt as jopt
from squeezellm_tpu_torch import carry, checkpoint, engine
from squeezellm_tpu_torch.models import fuse as fuse_mod
from squeezellm_tpu_torch.models import opt, registry
from test_torch_model import _module_meta, _quant

TOL = 1e-4  # logits, relative to max |logit|; f32 on both sides
PROMPT = np.array([[3, 141, 59, 26, 5]], np.int32)
NEW_TOKENS = 16
N_DECODE_LOGITS = 4
CONFIG = jopt.OPTConfig(vocab_size=256, hidden_size=128, ffn_dim=256,
                        n_layers=2, n_heads=4, max_seq=64)


def _opt_tree(config, bits, seed=0, sparse=True):
    """Random quantized OPT tree in the JAX package's format (numpy): a
    bias on each of the six layer linears, none on the quantized lm_head."""
    rng = np.random.default_rng(seed)
    h = config.hidden_size

    def norm():
        return {"w": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(h)).astype(np.float32)}

    spec_layers, layers = [], []
    for _ in range(config.n_layers):
        sd, pd = {}, {}
        for name, (o, i) in config.linear_shapes().items():
            spec, p = _quant(rng, o, i, bits, sparse=sparse)
            p["bias"] = (0.1 * rng.standard_normal(o)).astype(np.float32)
            sd[name] = dataclasses.replace(
                spec, has_bias=True,
                quant=dataclasses.replace(spec.quant, has_bias=True))
            pd[name] = p
        pd["attn_norm"], pd["ffn_norm"] = norm(), norm()
        spec_layers.append(sd)
        layers.append(pd)
    head_spec, head = _quant(rng, config.vocab_size, h, bits, sparse=False,
                             topx=0)
    params = {
        "embed": rng.standard_normal((config.vocab_size, h)).astype(np.float32),
        "embed_pos": (0.5 * rng.standard_normal(
            (config.max_seq + 2, h))).astype(np.float32),
        "layers": layers,
        "final_norm": norm(),
        "lm_head": head,
    }
    return {"layers": tuple(spec_layers), "lm_head": head_spec}, params


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's greedy tokens, prefill and decode logits, and
    full-sequence logits."""
    specs, params = _opt_tree(CONFIG, 4)
    ckpt = str(tmp_path_factory.mktemp("opt_ckpt"))
    jcheckpoint.save_quantized(ckpt, "opt", CONFIG, specs, params)
    jparams = jax.tree.map(jnp.asarray, params)
    eng = jengine.Engine("opt", CONFIG, specs, jparams, backend="xla")
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
    full = np.asarray(jopt.forward(CONFIG, specs, jparams,
                                   jnp.asarray(tokens), backend="xla"))
    return dict(specs=specs, params=params, ckpt=ckpt, tokens=tokens,
                rows=np.stack(rows), full=full)


def _port_model(ref, route):
    cfg = dataclasses.asdict(CONFIG)
    if route == "checkpoint":
        model_type, model = checkpoint.load_quantized(ref["ckpt"], "cpu")
        assert model_type == "opt"
        return model
    specs, params = ref["specs"], ref["params"]
    if route == "jax-fused":
        specs, params = jfuse.fuse_for_decode("opt", specs, params)
    model = carry.from_tree("opt", cfg, _module_meta(specs), params, "cpu")
    if route == "port-fused":
        fuse_mod.fuse_for_decode(model)
    return model


@pytest.mark.parametrize("route", ["checkpoint", "carry", "port-fused",
                                   "jax-fused"])
def test_port_opt_matches_jax(reference, route):
    model = _port_model(reference, route)
    assert isinstance(model, opt.OPT)
    fused = route.endswith("fused")
    assert set(model.layers[0].attn.proj) == (
        {"qkv", "o"} if fused else {"q", "k", "v", "o"})
    assert model.layers[0].attn.proj["qkv" if fused else "q"].spec.has_bias
    eng = engine.Engine(model)
    tokens = reference["tokens"]
    np.testing.assert_array_equal(eng.generate(PROMPT, NEW_TOKENS), tokens)

    cache = eng.new_cache(1)
    rows = [model.prefill(torch.from_numpy(PROMPT).long(), cache)[0, -1]]
    for i in range(N_DECODE_LOGITS):
        pos = PROMPT.shape[1] + i
        tok = torch.tensor(tokens[:, pos: pos + 1], dtype=torch.long)
        rows.append(model.decode_step(tok, pos, cache)[0, -1])
    for got, want in ((torch.stack(rows).numpy(), reference["rows"]),
                      (model.forward(torch.tensor(tokens, dtype=torch.long))
                       .numpy(), reference["full"])):
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_opt_config_and_registry():
    hf = {"model_type": "opt", "vocab_size": 50272, "hidden_size": 4096,
          "ffn_dim": 16384, "num_hidden_layers": 32,
          "num_attention_heads": 32, "max_position_embeddings": 2048}
    got = opt.OPTConfig.from_hf_config(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jopt.OPTConfig.from_hf_config(hf))
    assert got.linear_shapes() == jopt.OPTConfig.from_hf_config(
        hf).linear_shapes()
    assert (got.head_dim, got.n_kv_heads, got.sliding_window) == (128, 32,
                                                                  None)
    assert opt.MODULE_NAMES == jopt.MODULE_NAMES
    assert opt.POS_OFFSET == jopt._POS_OFFSET
    assert registry.get_model_module("opt") is opt
    assert registry.parse_model_type("x/opt-6.7b") == "opt"
    assert registry.parse_model_type("x", hf) == "opt"
    assert registry.config_class("opt") is opt.OPTConfig
    with pytest.raises(ValueError, match="unknown model type"):
        registry.get_model_module("gpt2")


@pytest.mark.parametrize("bad,match", [
    ({"word_embed_proj_dim": 512}, "embedding projection"),
    ({"do_layer_norm_before": False}, "post-LN")])
def test_from_hf_config_rejects_unsupported_variants(bad, match):
    """OPT-350m's projected embeddings and post-LN layers: the JAX package
    refuses both, and so does the port."""
    hf = {"vocab_size": 50272, "hidden_size": 1024, "ffn_dim": 4096,
          "num_hidden_layers": 24, "num_attention_heads": 16, **bad}
    with pytest.raises(AssertionError, match=match):
        jopt.OPTConfig.from_hf_config(hf)
    with pytest.raises(ValueError, match=match):
        opt.OPTConfig.from_hf_config(hf)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    from squeezellm_tpu_torch.models import common

    got = common.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), 1e-5)
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
