"""The port's staged offline workflow (chunk -> outlier-config -> nuq ->
pack) on a tiny HF directory, on the CPU:

* it equals the port's one-shot ``quantize_model`` on the same tree and
  thresholds, array for array, and a second ``nuq`` skips every layer;
* with ``method="native"`` each artifact (the chunks, the outlier config,
  ``lut_{i}.npz``, ``outliers_{i}.npz``, the packed checkpoint's arrays)
  equals the JAX package's ``staged`` one array for array;
* the stages cross packages: the JAX package's chunks feed the port's
  ``nuq`` and give the port's own artifacts;
* ``fit_module_luts(method="sklearn")`` equals the JAX package's (LUTs and
  labels);
* the four commands through ``python -m squeezellm_tpu_torch ... --device
  cpu``, then ``eval`` on the packed checkpoint.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.quantize import kmeans as jkmeans
from squeezellm_tpu.quantize import staged as jstaged
from squeezellm_tpu_torch import checkpoint
from squeezellm_tpu_torch.quantize import kmeans, pipeline, staged
from squeezellm_tpu_torch.utils import hf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = jllama.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                         n_layers=2, n_heads=4, n_kv_heads=4, max_seq=32)
HF_NAMES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
            "v": "self_attn.v_proj", "o": "self_attn.o_proj",
            "gate": "mlp.gate_proj", "up": "mlp.up_proj",
            "down": "mlp.down_proj"}


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny LLaMA as an HF directory: config.json and pytorch_model.bin
    of a random tree in bf16, as HF checkpoints hold their weights."""
    d = tmp_path_factory.mktemp("hf") / "tiny-llama"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": CFG.vocab_size,
        "hidden_size": CFG.hidden_size,
        "intermediate_size": CFG.intermediate_size,
        "num_hidden_layers": CFG.n_layers,
        "num_attention_heads": CFG.n_heads,
        "num_key_value_heads": CFG.n_kv_heads,
        "max_position_embeddings": CFG.max_seq, "rms_norm_eps": 1e-5}))
    p = jax.tree.map(np.asarray, jllama.random_dense_params(
        CFG, jax.random.PRNGKey(3)))

    def t(a):
        return torch.from_numpy(np.array(a)).to(torch.bfloat16)

    sd = {"model.embed_tokens.weight": t(p["embed"]),
          "model.norm.weight": t(p["final_norm"]),
          "lm_head.weight": t(p["lm_head"]["w"])}
    for i, lp in enumerate(p["layers"]):
        for n, name in HF_NAMES.items():
            sd[f"model.layers.{i}.{name}.weight"] = t(lp[n]["w"])
        sd[f"model.layers.{i}.input_layernorm.weight"] = t(lp["input_norm"])
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = t(
            lp["post_norm"])
    torch.save(sd, str(d / "pytorch_model.bin"))
    return str(d)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_npz(got, want):
    g, w = _npz(got), _npz(want)
    assert sorted(g) == sorted(w), (got, sorted(g), sorted(w))
    for k in w:
        assert g[k].dtype == w[k].dtype, (got, k)
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{got} {k}")


def _port_stages(hf_dir, root, chunks=None):
    """The port's four stages into root/; returns their paths."""
    paths = {k: os.path.join(root, k)
             for k in ("chunks", "nuq", "ckpt", "oc.json")}
    if chunks is None:
        assert staged.chunk_model(hf_dir, paths["chunks"]) == CFG.n_layers
    else:
        paths["chunks"] = chunks
    staged.make_outlier_config(paths["chunks"], 1.8, paths["oc.json"])
    assert staged.nuq(paths["chunks"], paths["nuq"], 4,
                      outlier_config_json=paths["oc.json"],
                      device="cpu") == CFG.n_layers
    staged.pack(hf_dir, paths["nuq"], 4, paths["ckpt"], device="cpu")
    return paths


@pytest.fixture(scope="module")
def port_run(hf_dir, tmp_path_factory):
    return _port_stages(hf_dir, str(tmp_path_factory.mktemp("port")))


@pytest.fixture(scope="module")
def jax_run(hf_dir, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax"))
    paths = {k: os.path.join(root, k)
             for k in ("chunks", "nuq", "ckpt", "oc.json")}
    jstaged.chunk_model(hf_dir, paths["chunks"])
    jstaged.make_outlier_config(paths["chunks"], 1.8, paths["oc.json"])
    jstaged.nuq(paths["chunks"], paths["nuq"], 4,
                outlier_config_json=paths["oc.json"], method="native")
    jstaged.pack(hf_dir, paths["nuq"], 4, paths["ckpt"], build_spmv=False)
    return paths


def test_staged_equals_quantize_model_and_resumes(hf_dir, port_run,
                                                  capsys):
    # a second chunk and a second nuq find every layer's file and skip it
    staged.chunk_model(hf_dir, port_run["chunks"], verbose=True)
    assert staged.nuq(port_run["chunks"], port_run["nuq"], 4,
                      outlier_config_json=port_run["oc.json"],
                      device="cpu", verbose=True) == 0
    out = capsys.readouterr().out
    assert out.count("skip existing") == out.count("skip layer") == 2
    model_type, config, dense = hf.load_dense_model(hf_dir)
    with open(port_run["oc.json"]) as f:
        thresholds = json.load(f)["outlier_config"]
    _, want = pipeline.quantize_model(model_type, config, dense, 4,
                                      outlier_config=thresholds,
                                      device="cpu")
    for li in range(CFG.n_layers):
        got = _npz(os.path.join(port_run["ckpt"], f"layer_{li:03d}.npz"))
        flat = {f"{n}.{k}" if isinstance(v, dict) else n: vv
                for n, v in want["layers"][li].items()
                for k, vv in (v.items() if isinstance(v, dict)
                              else [(None, v)])}
        assert sorted(got) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        assert any(k.endswith("sp_vals") for k in got)
    model = checkpoint.load_quantized(port_run["ckpt"], "cpu")[1]
    logits = model.forward(torch.tensor([[1, 2, 3, 4]]))
    assert torch.isfinite(logits).all()


def test_staged_artifacts_equal_the_jax_package(port_run, jax_run):
    for li in range(CFG.n_layers):
        for d, f in (("chunks", f"layer_{li}.npz"), ("nuq", f"lut_{li}.npz"),
                     ("nuq", f"outliers_{li}.npz"),
                     ("ckpt", f"layer_{li:03d}.npz")):
            _same_npz(os.path.join(port_run[d], f),
                      os.path.join(jax_run[d], f))
    _same_npz(os.path.join(port_run["ckpt"], "globals.npz"),
              os.path.join(jax_run["ckpt"], "globals.npz"))
    for name in ("oc.json", "chunks/chunks.json"):
        with open(os.path.join(os.path.dirname(port_run["ckpt"]),
                               name)) as f, open(os.path.join(
                os.path.dirname(jax_run["ckpt"]), name)) as g:
            assert json.load(f) == json.load(g)


def test_jax_chunks_feed_the_port_stages(hf_dir, port_run, jax_run,
                                         tmp_path):
    cross = _port_stages(hf_dir, str(tmp_path), chunks=jax_run["chunks"])
    for li in range(CFG.n_layers):
        for d, f in (("nuq", f"lut_{li}.npz"), ("nuq", f"outliers_{li}.npz"),
                     ("ckpt", f"layer_{li:03d}.npz")):
            _same_npz(os.path.join(cross[d], f), os.path.join(port_run[d], f))


@pytest.mark.parametrize("with_grad", [False, True])
def test_sklearn_kmeans_equals_the_jax_package(with_grad):
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((6, 96)) * 0.02).astype(np.float32)
    w[rng.random(w.shape) < 0.05] = 0  # zeroed outlier slots
    g = (rng.random(w.shape) ** 4).astype(np.float32) if with_grad else None
    want_lut, want_labels = jkmeans.fit_module_luts(w, g, 3,
                                                    method="sklearn")
    lut, labels = kmeans.fit_module_luts(
        torch.from_numpy(w), None if g is None else torch.from_numpy(g), 3,
        method="sklearn")
    assert lut.dtype == torch.float32 and labels.dtype == torch.uint8
    np.testing.assert_array_equal(lut.numpy(), want_lut)
    np.testing.assert_array_equal(labels.numpy(), want_labels)


def test_staged_commands(hf_dir, port_run, tmp_path):
    """The commands as a user runs them give the functions' artifacts,
    and `eval` reads the packed checkpoint."""
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(*args):
        res = subprocess.run([sys.executable, "-m", "squeezellm_tpu_torch",
                              *args], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        return res.stdout

    d = {k: str(tmp_path / k) for k in ("chunks", "nuq", "ckpt", "oc.json")}
    run("chunk", "--model", hf_dir, "--output", d["chunks"])
    run("outlier-config", "--chunks", d["chunks"], "--range", "1.8",
        "--output", d["oc.json"])
    run("nuq", "--chunks", d["chunks"], "--bits", "4", "--outlier-config",
        d["oc.json"], "--output", d["nuq"], "--device", "cpu")
    run("pack", "--model", hf_dir, "--nuq", d["nuq"], "--wbits", "4",
        "--no-spmv", "--output", d["ckpt"], "--device", "cpu")
    for li in range(CFG.n_layers):
        _same_npz(os.path.join(d["ckpt"], f"layer_{li:03d}.npz"),
                  os.path.join(port_run["ckpt"], f"layer_{li:03d}.npz"))
    line = run("eval", "--model", d["ckpt"], "--device", "cpu", "--seqlen",
               "16", "--nsamples", "2", "--group", "1").strip().splitlines()
    assert np.isfinite(json.loads(line[-1])["ppl"])
