"""The port's offline quantization against the JAX package on the CPU, on
the same numpy inputs: k-means (free and structured) against
``method="batched"``, the structured-table detection against the table the
JAX package attaches, outlier extraction and IQR thresholds, packing,
Fisher gradients (LLaMA and OPT), ``quantize_model`` (LLaMA w4 structured
with a sensitivity sidecar, LLaMA w3, OPT w4), checkpoints in both
directions, the safetensors reader, and the ``fisher`` and ``quantize``
commands on a temporary HF directory.

Tolerances: a LUT within 1e-6 of max |lut| and codes equal in all but 1e-4
of the entries (f64 sums taken in another order can move an exact
near-tie); Fisher grad^2 within 1e-4 of its max (f32 backward passes in
another order); logits within 1e-4 of max |logit| (f32)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from squeezellm_tpu import checkpoint as jcheckpoint
from squeezellm_tpu import cli as jcli
from squeezellm_tpu import formats as jformats
from squeezellm_tpu.models import fuse as jfuse
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.models import opt as jopt
from squeezellm_tpu.ops import quant_linear as jql
from squeezellm_tpu.quantize import gradients as jgradients
from squeezellm_tpu.quantize import kmeans as jkmeans
from squeezellm_tpu.quantize import outlier_config as joc
from squeezellm_tpu.quantize import outliers as joutliers
from squeezellm_tpu.quantize import pipeline as jpipeline
from squeezellm_tpu_torch import checkpoint, cli, formats
from squeezellm_tpu_torch.models import fuse, llama, opt
from squeezellm_tpu_torch.ops import quant_linear
from squeezellm_tpu_torch.quantize import gradients, kmeans
from squeezellm_tpu_torch.quantize import outlier_config, outliers, pipeline
from squeezellm_tpu_torch.utils import hf

LUT_TOL = 1e-6
LABEL_TOL = 1e-4
FISHER_TOL = 1e-4
LOGIT_TOL = 1e-4

LLAMA = jllama.LlamaConfig(vocab_size=128, hidden_size=64,
                           intermediate_size=96, n_layers=2, n_heads=4,
                           n_kv_heads=2, max_seq=64)
OPT = jopt.OPTConfig(vocab_size=128, hidden_size=64, ffn_dim=96, n_layers=2,
                     n_heads=4, max_seq=64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_config(config):
    cls = opt.OPTConfig if isinstance(config, jopt.OPTConfig) else (
        llama.LlamaConfig)
    return cls(**dataclasses.asdict(config))


def _weights(rng, C, N, zero_frac=0.01):
    w = (rng.standard_normal((C, N)) * 0.02).astype(np.float32)
    w[rng.random((C, N)) < zero_frac] = 0  # zeroed outlier slots
    return w


def _assert_luts(got, want, got_labels, want_labels):
    got = np.asarray(got)
    assert np.abs(got - want).max() <= LUT_TOL * np.abs(want).max()
    assert (np.asarray(got_labels) != want_labels).mean() <= LABEL_TOL


# 300 channels: one full chunk of 256 and a partial one drawing its own
# k-means++ sequence; 40: a partial chunk only
@pytest.mark.parametrize("C,N,bits,with_grad", [
    (300, 116, 4, True), (300, 200, 3, False), (40, 64, 4, False),
    (40, 257, 3, True)])
def test_fit_module_luts_matches_batched(C, N, bits, with_grad):
    rng = np.random.default_rng(C + N + bits)
    w = _weights(rng, C, N)
    g = ((rng.random((C, N)) ** 4) * 1e-6).astype(np.float32)
    g[:3] = 0  # all-zero rows fall back to uniform weights
    g = g if with_grad else None
    lut, labels = jkmeans.fit_module_luts(w, g, bits, method="batched")
    got, got_labels = kmeans.fit_module_luts(
        _t(w), None if g is None else _t(g), bits, method="batched")
    assert got.dtype == torch.float32 and got_labels.dtype == torch.uint8
    _assert_luts(got, lut, got_labels, labels)


@pytest.mark.parametrize("C,N,k", [(8, 256, 16), (64, 4096, 8),
                                   (32, 4096, 16), (300, 116, 8)])
def test_native_kmeans_equals_the_jax_package_library(C, N, k):
    """The port's copy of the native solver, built by the host's g++ at
    first use, against the JAX package's committed library on the same f32
    values and weights: centroids and labels equal bit for bit (3 and 4
    bits), and nothing of the JAX package is loaded by the port."""
    from squeezellm_tpu import _native

    rng = np.random.default_rng(C + N + k)
    v = rng.standard_normal((C, N)).astype(np.float32)
    w = rng.random((C, N)).astype(np.float32)
    w[:2] = 0  # all-zero weights: the solver's own fallback
    want_c, want_l = _native.weighted_kmeans_batched(v, w, k, seed=3)
    got_c, got_l = kmeans.weighted_kmeans_native(_t(v), _t(w), k, seed=3)
    assert got_c.dtype == torch.float32 and got_l.dtype == torch.uint8
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_l.numpy(), want_l)


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("with_grad", [True, False])
def test_fit_module_luts_auto_equals_the_jax_default(bits, with_grad):
    """method="auto" is the native solver in both packages: the same LUTs
    and codes bit for bit, grad^2 weights, zeroed slots and all-zero rows
    included."""
    rng = np.random.default_rng(bits * 2 + with_grad)
    w = _weights(rng, 300, 200, zero_frac=0.05)
    g = ((rng.random(w.shape) ** 4) * 1e-6).astype(np.float32)
    g[:3] = 0
    g = g if with_grad else None
    lut, labels = jkmeans.fit_module_luts(w, g, bits, method="auto")
    for method in ("auto", "native"):
        got, got_labels = kmeans.fit_module_luts(
            _t(w), None if g is None else _t(g), bits, method=method)
        np.testing.assert_array_equal(got.numpy(), lut)
        np.testing.assert_array_equal(got_labels.numpy(), labels)


def test_native_kmeans_names_the_batched_solver_when_it_cannot_build(
        monkeypatch):
    from squeezellm_tpu_torch import _build

    monkeypatch.setattr(_build, "HOST_CXX", "no-such-compiler-for-the-test")
    monkeypatch.setattr(_build, "_host_lib", None)
    w = torch.randn(4, 32)
    with pytest.raises(RuntimeError, match='method="batched"'):
        kmeans.fit_module_luts(w, None, 3)
    lut, _ = kmeans.fit_module_luts(w, None, 3, method="batched")
    assert lut.shape == (4, 8)


def test_weighted_kmeans_uniform_and_repeated_values():
    """No weights, and channels with fewer distinct values than k (the
    k-means++ draws then repeat a centroid, which takes no values)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((20, 50))
    x[:4] = rng.integers(0, 3, (4, 50)).astype(np.float64)  # 3 values
    cents, labels = jkmeans.weighted_kmeans_batched(x, None, 8)
    got, got_labels = kmeans.weighted_kmeans_batched(_t(x), None, 8)
    _assert_luts(got, cents, got_labels, labels)


@pytest.mark.parametrize("with_grad", [True, False])
def test_fit_structured_luts_matches(with_grad):
    rng = np.random.default_rng(11)
    w = _weights(rng, 300, 116)
    g = ((rng.random(w.shape) ** 4) * 1e-6).astype(np.float32)
    g = g if with_grad else None
    lut, labels = jkmeans.fit_structured_luts(w, g)
    got, got_labels = kmeans.fit_structured_luts(
        _t(w), None if g is None else _t(g))
    _assert_luts(got, lut, got_labels, labels)
    # structured order, not sorted: lut[:, 8:] - lut[:, :8] is d per row
    delta = got[:, 8:] - got[:, :8]
    assert torch.allclose(delta, delta[:, :1].expand_as(delta), atol=1e-6)


def test_structured_table_equals_jax_lut_t_struct():
    """attach_decode_luts of both packages on the same tables: the port's A
    and d are the JAX package's (16, out) table bit for bit (row 8 holds
    d / 8, an exact division), and a free table is detected by neither."""
    rng = np.random.default_rng(3)
    structured, _ = jkmeans.fit_structured_luts(_weights(rng, 40, 64), None)
    free, _ = jkmeans.fit_module_luts(_weights(rng, 40, 64), None, 4,
                                      method="batched")
    for lut, is_struct in ((structured, True), (free, False)):
        o, i = lut.shape[0], 64
        qspec = jql.QuantLinearSpec(bits=4, in_features=i, out_features=o)
        spec = jllama.LinearSpec(in_features=i, out_features=o, quant=qspec)
        p = {"qweight": np.zeros((jformats.n_words(i, 4), o), np.int32),
             "lut": lut}
        _, jp = jfuse.attach_decode_luts({"layers": ({"q": spec},)},
                                         {"layers": [{"q": p}]})
        st = jp["layers"][0]["q"].get("lut_t_struct")
        dec = kmeans.structured_decomposition(_t(lut))
        assert (st is not None) == is_struct == (dec is not None)
        if is_struct:
            a, d = dec
            np.testing.assert_array_equal(a, st[0:8].T)
            np.testing.assert_array_equal(d / 8.0, st[8])


def test_outlier_masks_match():
    rng = np.random.default_rng(2)
    weights = {n: _weights(rng, 48, 80, 0.0) for n in ("q", "down")}
    grads = {n: rng.random((48, 80)).astype(np.float32) for n in weights}
    grads["q"][0, :5] = grads["q"][0, 5]  # ties at the threshold
    cfg = joc.make_outlier_config([weights], 1.5)
    assert outlier_config.make_outlier_config([{
        n: _t(w) for n, w in weights.items()}], 1.5) == cfg
    thresholds = cfg["outlier_config"][0]
    for sens, thr in ((0.45, None), (0.0, thresholds), (2.0, thresholds)):
        jw = {n: w.copy() for n, w in weights.items()}
        want = joutliers.remove_outliers(jw, sensitivity=sens,
                                         outlier_config=thr, gradients=grads)
        tw = {n: _t(w) for n, w in weights.items()}
        got = outliers.remove_outliers(
            tw, sensitivity=sens, outlier_config=thr,
            gradients={n: _t(g) for n, g in grads.items()})
        for n in weights:
            np.testing.assert_array_equal(got[n].numpy(), want[n])
            np.testing.assert_array_equal(tw[n].numpy(), jw[n])
        assert sum(int((v != 0).sum()) for v in want.values()) > 0


@pytest.mark.parametrize("bits", [3, 4])
def test_pack_linear_matches(bits):
    """Same labels in, the same qweight, lut and COO sidecar (zero-
    corrected, padded to the multiple) out; no labels: the same
    nearest-centroid codes."""
    rng = np.random.default_rng(bits)
    w = _weights(rng, 40, 116, 0.0)
    lut, labels = jkmeans.fit_module_luts(w, None, bits, method="batched")
    out = np.zeros_like(w)
    mask = rng.random(w.shape) < 0.02
    out[mask] = rng.standard_normal(mask.sum()).astype(np.float32)
    out[0, 0] = lut[0, np.argmin(np.abs(lut[0]))]  # corrects to exactly 0
    w[mask] = 0
    bias = rng.standard_normal(40).astype(np.float32)
    for lab in (labels, None):
        want_spec, want = jql.pack_linear(w, lut, labels=lab, bias=bias,
                                          outliers=out, bits=bits,
                                          nnz_pad_multiple=64)
        spec, got = quant_linear.pack_linear(
            _t(w), _t(lut), labels=None if lab is None else _t(lab),
            bias=_t(bias), outliers=_t(out), bits=bits, nnz_pad_multiple=64)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert spec.nnz == int((want["sp_vals"] != 0).sum())
        assert len(got["sp_vals"]) == want_spec.nnz_pad
    np.testing.assert_array_equal(
        formats.pack_codes(_t(labels.T), bits).numpy(),
        jformats.pack_codes(labels.T, bits))


def _dense(config, seed=0):
    mod = jopt if isinstance(config, jopt.OPTConfig) else jllama
    p = mod.random_dense_params(config, jax.random.PRNGKey(seed))
    if isinstance(config, jopt.OPTConfig):  # nonzero biases, norms
        rng = np.random.default_rng(seed)
        p = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
            np.shape(a)).astype(np.float32) if np.ndim(a) == 1 else a, p)
    return jax.tree.map(np.asarray, p)


CALIB = np.random.default_rng(0).integers(0, 128, (2, 32)).astype(np.int32)


def _grads(config, seed):
    """Random grad^2 per layer module (Fisher itself is held on its own)."""
    rng = np.random.default_rng(seed)
    return [{n: (rng.random((o, i)) ** 4 * 1e-6).astype(np.float32)
             for n, (o, i) in config.linear_shapes().items()}
            for _ in range(config.n_layers)]


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_fisher_matches(family):
    config = LLAMA if family == "llama" else OPT
    dense = _dense(config)
    want = jgradients.compute_fisher(family, config, dense, CALIB)
    got = gradients.compute_fisher(family, _port_config(config), dense,
                                   CALIB, device="cpu")
    for lw, lg in zip(want, got):
        assert sorted(lw) == sorted(lg)
        for n in lw:
            scale = np.abs(lw[n]).max()
            assert scale > 0
            assert np.abs(lg[n].numpy() - lw[n]).max() <= FISHER_TOL * scale


def _assert_trees(got, want):
    """Quantized trees: LUTs and codes within the k-means tolerances, the
    sidecar's positions equal, everything else equal."""
    for k, v in want.items():
        if k == "layers":
            for lg, lw in zip(got["layers"], v):
                _assert_trees(lg, lw)
        elif isinstance(v, dict) and "lut" in v:
            g = got[k]
            assert sorted(g) == sorted(k_ for k_ in v if not k_.startswith(
                ("sg_", "sgb_")))
            bits = int(np.log2(v["lut"].shape[1]))
            in_f = (v["qweight"].shape[0] * jformats.CODES_PER_WORD[bits])
            _assert_luts(g["lut"], v["lut"],
                         jformats.unpack_codes(g["qweight"], bits, in_f),
                         jformats.unpack_codes(v["qweight"], bits, in_f))
            for name in ("sp_rows", "sp_cols", "bias"):
                if name in v:
                    np.testing.assert_array_equal(g[name], v[name])
            if "sp_vals" in v:
                np.testing.assert_allclose(g["sp_vals"], v["sp_vals"],
                                           atol=1e-6)
        elif isinstance(v, dict):
            _assert_trees(got[k], v)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("family,bits,structured,sens", [
    ("llama", 4, True, 0.45), ("llama", 3, False, 0.0),
    ("opt", 4, False, 0.45)])
def test_quantize_model_matches(family, bits, structured, sens, tmp_path):
    config = LLAMA if family == "llama" else OPT
    dense = _dense(config, seed=bits)
    grads = _grads(config, bits)
    kw = dict(gradients_per_layer=grads if sens else None, sensitivity=sens,
              quantize_lm_head=True, structured=structured)
    jspecs, jparams = jpipeline.quantize_model(
        family, config, dense, bits, method="batched", build_spmv=False, **kw)
    specs, params = pipeline.quantize_model(
        family, _port_config(config), dense, bits, device="cpu",
        method="batched", **kw)
    _assert_trees(params, jparams)
    for ls, lj in zip(specs["layers"], jspecs["layers"]):
        for n in lj:
            assert ls[n].quant.bits == lj[n].quant.bits == bits
            assert ls[n].has_bias == lj[n].has_bias == (family == "opt")
    # the 4-bit structured model's every table decomposes
    model = fuse.fuse_for_decode(_load_port(tmp_path, family, config, specs,
                                            params))
    lins = fuse.quant_linears(model)
    assert all(("struct_a" in m.tensors()) == structured for m in lins)


@pytest.mark.parametrize("family,bits,sens", [("llama", 3, 0.45),
                                              ("opt", 4, 0.0)])
def test_quantize_model_defaults_give_the_jax_codebooks(family, bits, sens):
    """With default arguments both pipelines fit their codebooks with the
    native solver: the same packed words, LUTs and sidecar bit for bit."""
    config = LLAMA if family == "llama" else OPT
    dense = _dense(config, seed=bits + 10)
    kw = dict(gradients_per_layer=_grads(config, bits) if sens else None,
              sensitivity=sens, quantize_lm_head=True)
    _, jparams = jpipeline.quantize_model(family, config, dense, bits,
                                          build_spmv=False, **kw)
    _, params = pipeline.quantize_model(family, _port_config(config), dense,
                                        bits, device="cpu", **kw)

    def same(got, want):
        for k, v in want.items():
            if isinstance(v, dict):
                same(got[k], v)
            elif isinstance(v, list):
                for a, b in zip(got[k], v):
                    same(a, b)
            else:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(v), err_msg=k)

    compared = 0
    for layer, jlayer in zip(params["layers"], jparams["layers"]):
        for name, jp in jlayer.items():
            if isinstance(jp, dict) and "lut" in jp:
                same({n: layer[name][n] for n in ("qweight", "lut")},
                     {n: jp[n] for n in ("qweight", "lut")})
                compared += 1
    assert compared == config.n_layers * (7 if family == "llama" else 6)
    same({n: params["lm_head"][n] for n in ("qweight", "lut")},
         {n: jparams["lm_head"][n] for n in ("qweight", "lut")})


def _load_port(tmp_path, family, config, specs, params):
    path = str(tmp_path / "port_ckpt")
    checkpoint.save_quantized(path, family, _port_config(config), specs,
                              params)
    return checkpoint.load_quantized(path, "cpu")[1]


def _jax_logits(path, tokens):
    mt, config, specs, params = jcheckpoint.load_quantized(path)
    mod = jopt if mt == "opt" else jllama
    return np.asarray(mod.forward(config, specs, params, jnp.asarray(tokens),
                                  backend="xla"))


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_checkpoints_load_in_both_packages(family, tmp_path):
    """The port's checkpoint in the JAX loader and the JAX package's in the
    port's: the same manifest and arrays, logits within 1e-4."""
    config = OPT if family == "opt" else LLAMA
    dense = _dense(config, seed=7)
    kw = dict(gradients_per_layer=_grads(config, 7), sensitivity=0.45,
              quantize_lm_head=True)
    specs, params = pipeline.quantize_model(
        family, _port_config(config), dense, 4, device="cpu", **kw)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    checkpoint.save_quantized(port_dir, family, _port_config(config), specs,
                              params)
    jspecs, jparams = jpipeline.quantize_model(
        family, config, dense, 4, method="batched", build_spmv=False, **kw)
    jcheckpoint.save_quantized(jax_dir, family, config, jspecs, jparams)
    manifests = [json.load(open(f"{d}/manifest.json"))
                 for d in (port_dir, jax_dir)]
    assert manifests[0] == manifests[1]
    for d in (port_dir, jax_dir):
        want = _jax_logits(d, CALIB)
        got = checkpoint.load_quantized(d, "cpu")[1].forward(
            torch.as_tensor(CALIB).long()).numpy()
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def _write_hf_dir(tmp_path, config, params, safetensors=False):
    """An HF-style directory of a tiny LLaMA: config.json and the state
    dict, as pytorch_model.bin or model.safetensors."""
    from safetensors.torch import save_file

    hf_cfg = {
        "model_type": "llama", "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.n_layers,
        "num_attention_heads": config.n_heads,
        "num_key_value_heads": config.n_kv_heads,
        "max_position_embeddings": config.max_seq, "rms_norm_eps": 1e-5,
    }
    d = tmp_path / ("hf_safe" if safetensors else "hf_bin")
    d.mkdir()
    (d / "config.json").write_text(json.dumps(hf_cfg))
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": _t(params["embed"]),
          "model.norm.weight": _t(params["final_norm"]),
          "lm_head.weight": _t(params["lm_head"]["w"])}
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        for n, name in names.items():
            sd[p + name + ".weight"] = _t(lp[n]["w"])
        sd[p + "input_layernorm.weight"] = _t(lp["input_norm"])
        sd[p + "post_attention_layernorm.weight"] = _t(lp["post_norm"])
    if safetensors:  # one bf16 tensor among f32 ones
        sd["model.norm.weight"] = sd["model.norm.weight"].to(torch.bfloat16)
        save_file(sd, str(d / "model.safetensors"))
    else:
        torch.save(sd, str(d / "pytorch_model.bin"))
    return str(d)


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import load_file

    path = _write_hf_dir(tmp_path, LLAMA, _dense(LLAMA), safetensors=True)
    want = load_file(f"{path}/model.safetensors")
    got = hf.read_safetensors(f"{path}/model.safetensors")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    mt, config, params = hf.load_dense_model(path)
    assert mt == "llama" and config.n_layers == LLAMA.n_layers
    assert params["final_norm"].dtype == torch.float32


def test_fisher_and_quantize_commands(tmp_path, capsys):
    """`fisher` then `quantize --gradient` of the port on an HF directory,
    beside the JAX package's commands on the same directory: the same
    grad^2 chunks within 1e-4, and the same checkpoint."""
    dense = _dense(LLAMA, seed=4)
    hf_dir = _write_hf_dir(tmp_path, LLAMA, dense)
    common = ["--model", hf_dir]
    fisher = ["fisher", *common, "--nsamples", "2", "--seqlen", "32"]
    cli.main([*fisher, "--device", "cpu", "--output", str(tmp_path / "g")])
    jcli.main([*fisher, "--output", str(tmp_path / "jg")])
    for li in range(LLAMA.n_layers):
        g = np.load(tmp_path / "g" / f"layer_{li}.npz")
        jg = np.load(tmp_path / "jg" / f"layer_{li}.npz")
        for n in jg.files:
            scale = np.abs(jg[n]).max()
            assert np.abs(g[n] - jg[n]).max() <= FISHER_TOL * scale
    quant = ["quantize", *common, "--gradient", str(tmp_path / "jg"),
             "--bits", "4", "--sensitivity", "0.45", "--outlier-range",
             "1.8", "--method", "batched", "--quantize-lm-head"]
    cli.main([*quant, "--device", "cpu", "--output", str(tmp_path / "q")])
    jcli.main([*quant, "--output", str(tmp_path / "jq")])
    assert "saved quantized checkpoint" in capsys.readouterr().out
    # the JAX command also stores its SpMV slot plans (sg_*), the port none
    manifests = [json.load(open(tmp_path / d / "manifest.json"))
                 for d in ("q", "jq")]
    for m in manifests:
        for meta in m["modules"].values():
            for k in ("sg_rows", "sg_oh", "sg_ih"):
                meta.pop(k, None)
    assert manifests[0] == manifests[1]
    jmt, jconfig, jspecs, jparams = jcheckpoint.load_quantized(
        str(tmp_path / "jq"), to_device=False)
    _, _, _, params = jcheckpoint.load_quantized(str(tmp_path / "q"),
                                                 to_device=False)
    _assert_trees(params, jparams)
