"""The port's converter of the reference's packed checkpoints against the
JAX package's, on the CPU, on reference-format state dicts made from a
numpy seed with the JAX package's ``formats.pack_codes_ref`` (the buffers
of the reference's ``QuantLinearLUT``, as ``tests/test_convert.py`` makes
them): tiny LLaMA w3 and w4, with and without the sparse sidecar and top-X,
embeddings, norms and lm_head in fp16 as published checkpoints hold them;
tiny OPT w4 with biases.

* ``pack_codes_ref`` / ``unpack_codes_ref`` equal the JAX functions bit for
  bit, the 3-bit inputs that spill across words (10 and 21) included;
* ``convert_state_dict`` gives the JAX package's arrays exactly;
* the converted model's f32 logits match the JAX forward
  (``backend="xla"``) within ``ATOL`` = 1e-4, the tolerance of
  ``tests/test_torch_model.py`` (f32 on both sides);
* the checkpoint ``convert_reference_checkpoint`` writes loads in the JAX
  package, whose forward on it matches as well; the ``convert`` command
  gives the same checkpoint, and ``eval`` runs on it.
"""

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
from squeezellm_tpu import convert as jconvert
from squeezellm_tpu import formats as jformats
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.models import opt as jopt
from squeezellm_tpu_torch import checkpoint, convert, formats
from squeezellm_tpu_torch.models import llama, opt

ATOL = 1e-4  # logits, f32 on both sides
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LLAMA = jllama.LlamaConfig(vocab_size=64, hidden_size=64,
                           intermediate_size=96, n_layers=2, n_heads=4,
                           n_kv_heads=2, max_seq=32)
OPT = jopt.OPTConfig(vocab_size=64, hidden_size=64, ffn_dim=96, n_layers=2,
                     n_heads=4, max_seq=32)
HF_NAMES = {
    "llama": {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
              "v": "self_attn.v_proj", "o": "self_attn.o_proj",
              "gate": "mlp.gate_proj", "up": "mlp.up_proj",
              "down": "mlp.down_proj"},
    "opt": {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
            "v": "self_attn.v_proj", "o": "self_attn.out_proj",
            "up": "fc1", "down": "fc2"},
}
TOKENS = np.random.default_rng(0).integers(0, 64, (2, 9)).astype(np.int32)


def _f16(rng, *shape, scale=0.1, base=0.0):
    return (base + scale * rng.standard_normal(shape)).astype(np.float16)


def reference_state_dict(family, bits, sparse, topx, seed):
    """A reference-format state dict of numpy arrays: per linear the
    reference-layout words, a sorted f32 LUT and, when asked, a 2% CSR
    sidecar and two top-X channels; fp16 everything else."""
    config = LLAMA if family == "llama" else OPT
    rng = np.random.default_rng(seed)
    prefix = "model.decoder." if family == "opt" else "model."
    h = config.hidden_size
    sd = {}
    for li in range(config.n_layers):
        for name, (out_f, in_f) in config.linear_shapes().items():
            p = f"{prefix}layers.{li}.{HF_NAMES[family][name]}."
            lut = np.sort(rng.standard_normal((out_f, 2**bits)).astype(
                np.float32) * 0.1, axis=1)
            codes = rng.integers(0, 2**bits, (in_f, out_f), dtype=np.uint8)
            sd[p + "qweight"] = jformats.pack_codes_ref(codes, bits)
            sd[p + "lookup_table"] = lut
            if family == "opt":
                sd[p + "bias"] = _f16(rng, out_f, scale=0.01)
            if sparse:
                mask = rng.random((out_f, in_f)) < 0.02
                crow = np.zeros(out_f + 1, np.int32)
                np.cumsum(mask.sum(1), out=crow[1:])
                sd[p + "rows"] = crow
                sd[p + "cols"] = np.nonzero(mask)[1].astype(np.int32)
                sd[p + "vals"] = rng.standard_normal(
                    int(mask.sum())).astype(np.float32) * 0.1
                sd[f"sparse_threshold.{li}.{name}"] = np.int32(mask.sum())
            if topx:
                sd[p + "full_rows"] = rng.standard_normal(
                    (in_f, topx)).astype(np.float32) * 0.05
                sd[p + "full_row_indices"] = rng.choice(
                    out_f, topx, replace=False).astype(np.int32)
        lp = f"{prefix}layers.{li}."
        if family == "opt":
            for n in ("self_attn_layer_norm", "final_layer_norm"):
                sd[f"{lp}{n}.weight"] = _f16(rng, h, base=1.0)
                sd[f"{lp}{n}.bias"] = _f16(rng, h, scale=0.02)
        else:
            sd[lp + "input_layernorm.weight"] = _f16(rng, h, base=1.0)
            sd[lp + "post_attention_layernorm.weight"] = _f16(rng, h,
                                                              base=1.0)
            sd[lp + "self_attn.rotary_emb.inv_freq"] = np.ones(
                h // config.n_heads // 2, np.float32)
    sd[prefix + "embed_tokens.weight"] = _f16(rng, config.vocab_size, h)
    if family == "opt":
        sd[prefix + "embed_positions.weight"] = _f16(rng, config.max_seq + 2,
                                                     h)
        sd[prefix + "final_layer_norm.weight"] = _f16(rng, h, base=1.0)
        sd[prefix + "final_layer_norm.bias"] = _f16(rng, h, scale=0.02)
    else:
        sd[prefix + "norm.weight"] = _f16(rng, h, base=1.0)
        sd["lm_head.weight"] = _f16(rng, config.vocab_size, h)
    return config, sd


CASES = {  # family, bits, sidecar, top-X
    "llama-w3-sparse-topx": ("llama", 3, True, 2),
    "llama-w3-dense": ("llama", 3, False, 0),
    "llama-w4-sparse": ("llama", 4, True, 0),
    "llama-w4-dense-topx": ("llama", 4, False, 2),
    "opt-w4-bias-sparse": ("opt", 4, True, 0),
}


def _port_config(config):
    if isinstance(config, jopt.OPTConfig):
        return opt.OPTConfig(**config.__dict__)
    return llama.LlamaConfig(**config.__dict__)


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        want = np.asarray(want)
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)


def _jax_logits(family, config, specs, params):
    mod = jopt if family == "opt" else jllama
    return np.asarray(mod.forward(config, specs,
                                  jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(TOKENS), backend="xla"))


def _port_logits(path):
    model = checkpoint.load_quantized(path, "cpu")[1]
    return model.forward(torch.as_tensor(TOKENS).long()).numpy()


@pytest.mark.parametrize("bits", [3, 4])
def test_reference_packing_matches_the_jax_package(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, (128, 24), dtype=np.uint8)
    codes[:, 0] = 2**bits - 1  # words with the sign bit set
    want = jformats.pack_codes_ref(codes, bits)
    got = formats.pack_codes_ref(torch.from_numpy(codes), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] < 0).any()
    back = formats.unpack_codes_ref(got, bits, 128).numpy()
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(
        back, jformats.unpack_codes_ref(want, bits, 128))
    np.testing.assert_array_equal(
        formats.convert_ref_qweight(got, bits, 128).numpy(),
        jformats.convert_ref_qweight(want, bits, 128))
    if bits == 3:
        # one input of a group set: inputs 10 and 21 straddle two words
        for j, spans in ((10, {0: 3 << 30, 1: 1}),
                         (21, {1: 1 << 31, 2: 3})):
            one = np.zeros((32, 1), np.uint8)
            one[j] = 7
            words = formats.pack_codes_ref(torch.from_numpy(one), 3)
            words = words.numpy().view(np.uint32)[:, 0]
            assert {w: int(v) for w, v in enumerate(words) if v} == spans
            np.testing.assert_array_equal(
                words.view(np.int32), jformats.pack_codes_ref(one, 3)[:, 0])
            np.testing.assert_array_equal(formats.unpack_codes_ref(
                torch.from_numpy(words.view(np.int32)[:, None]), 3,
                32).numpy(), one)


def test_sparse_from_csr_matches_the_jax_package():
    crow = np.array([0, 2, 2, 5, 6], np.int32)
    cols = np.array([1, 7, 0, 3, 6, 2], np.int32)
    vals = np.linspace(-1, 1, 6).astype(np.float32)
    want = jformats.SparseCOO.from_csr(crow, cols, vals, 8, pad_multiple=4)
    got = formats.SparseCOO.from_csr(torch.from_numpy(crow),
                                     torch.from_numpy(cols),
                                     torch.from_numpy(vals), 8,
                                     pad_multiple=4)
    for k in ("rows", "cols", "vals"):
        _assert_same(getattr(got, k), getattr(want, k), k)
    assert (got.nnz, got.out_features, got.in_features) == (6, 4, 8)


@pytest.mark.parametrize("case", list(CASES))
def test_convert_state_dict_matches_the_jax_package(case, tmp_path):
    family, bits, sparse, topx = CASES[case]
    config, sd = reference_state_dict(family, bits, sparse, topx,
                                      seed=len(case))
    sd = {k: v for k, v in sd.items() if not k.startswith("sparse_thr")}
    jspecs, jparams = jconvert.convert_state_dict(sd, family, config, bits,
                                                  nnz_pad_multiple=64)
    specs, params = convert.convert_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, family,
        _port_config(config), bits, nnz_pad_multiple=64, device="cpu")
    _assert_same(params, jparams)
    prefix = "model.decoder." if family == "opt" else "model."
    for li, (ls, lj) in enumerate(zip(specs["layers"], jspecs["layers"])):
        for n, s in lj.items():
            q, jq = ls[n].quant, s.quant
            assert (q.bits, q.has_bias, q.topx) == (jq.bits, jq.has_bias,
                                                    jq.topx)
            vals = sd.get(f"{prefix}layers.{li}.{HF_NAMES[family][n]}.vals")
            assert q.nnz == (0 if vals is None else len(vals))
    path = str(tmp_path / "ckpt")
    checkpoint.save_quantized(path, family, _port_config(config), specs,
                              params)
    want = _jax_logits(family, config, jspecs, jparams)
    np.testing.assert_allclose(_port_logits(path), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("family,bits", [("llama", 3), ("opt", 4)])
def test_converted_checkpoint_loads_in_the_jax_package(family, bits,
                                                       tmp_path):
    config, sd = reference_state_dict(family, bits, True,
                                      2 if family == "llama" else 0, seed=9)
    pt = str(tmp_path / "sq.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pt)
    model_dir = _config_dir(tmp_path, family, config)
    out = str(tmp_path / "converted")
    stats = {}
    convert.convert_reference_checkpoint(pt, model_dir, bits, out,
                                         nnz_pad_multiple=64, device="cpu",
                                         stats=stats)
    assert sorted(stats) == ["convert", "load", "save"]
    mt, jconfig, jspecs, jparams = jcheckpoint.load_quantized(out)
    assert mt == family
    want = _jax_logits(family, jconfig, jspecs, jparams)
    np.testing.assert_allclose(_port_logits(out), want, rtol=0, atol=ATOL)
    # and the JAX converter's own checkpoint of the same .pt
    jout = str(tmp_path / "jconverted")
    jconvert.convert_reference_checkpoint(pt, model_dir, bits, jout,
                                          nnz_pad_multiple=64,
                                          build_spmv=False)
    np.testing.assert_allclose(_port_logits(jout), want, rtol=0, atol=ATOL)


def _config_dir(tmp_path, family, config):
    d = tmp_path / f"{family}_model"
    d.mkdir()
    if family == "opt":
        hf = {"model_type": "opt", "vocab_size": config.vocab_size,
              "hidden_size": config.hidden_size, "ffn_dim": config.ffn_dim,
              "num_hidden_layers": config.n_layers,
              "num_attention_heads": config.n_heads,
              "max_position_embeddings": config.max_seq}
    else:
        hf = {"model_type": "llama", "vocab_size": config.vocab_size,
              "hidden_size": config.hidden_size,
              "intermediate_size": config.intermediate_size,
              "num_hidden_layers": config.n_layers,
              "num_attention_heads": config.n_heads,
              "num_key_value_heads": config.n_kv_heads,
              "max_position_embeddings": config.max_seq}
    (d / "config.json").write_text(json.dumps(hf))
    return str(d)


def test_convert_and_eval_commands(tmp_path):
    """`python -m squeezellm_tpu_torch convert`, then `eval` on its
    checkpoint, as a user runs them: the checkpoint's arrays equal the
    JAX command's, and the perplexity is finite."""
    from squeezellm_tpu import cli as jcli

    config, sd = reference_state_dict("llama", 3, True, 2, seed=3)
    pt = str(tmp_path / "sq-w3.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pt)
    model_dir = _config_dir(tmp_path, "llama", config)
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(*args):
        res = subprocess.run([sys.executable, "-m", "squeezellm_tpu_torch",
                              *args, "--device", "cpu"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        return res.stdout

    out = str(tmp_path / "converted")
    run("convert", "--checkpoint", pt, "--model", model_dir, "--wbits", "3",
        "--output", out)
    jout = str(tmp_path / "jconverted")
    jcli.main(["convert", "--checkpoint", pt, "--model", model_dir,
               "--wbits", "3", "--output", jout])
    for f in sorted(os.listdir(out)):
        if f.endswith(".npz"):
            with np.load(os.path.join(out, f)) as got, \
                    np.load(os.path.join(jout, f)) as want:
                _assert_same({k: got[k] for k in got.files},
                             {k: want[k] for k in want.files
                              if not k.split(".")[-1].startswith("sg")},
                             f)
    line = run("eval", "--model", out, "--seqlen", "16", "--nsamples", "2",
               "--group", "1").strip().splitlines()[-1]
    assert np.isfinite(json.loads(line)["ppl"])
