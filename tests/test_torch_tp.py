"""The port's tensor-parallel forward against the JAX package on the CPU.

Ranks are processes (`parallel.multihost.launch`, gloo, a file rendezvous
under tmp_path); one launch a tp covers every case at that tp. Each rank
shards the full port model carried from a JAX-format tree
(`parallel.tp.shard_model`) and returns the prefill's last logits and
three teacher-forced decode steps' (`torch_tp_workers.step_logits`):

* every rank's logits bit-equal to every other rank's;
* f32, unfused: within TOL_F32 of max |logit| of the JAX package's
  `tp_shard_map.make_tp_step_fns` (`backend="xla"`) at the same tp, and of
  the port's single-device model: LLaMA (GQA at tp=2) with no sidecar, with
  a 2% sidecar and top-X, 3-bit at tp=4 (row-parallel splits inside a
  word), and OPT with its biases (row-parallel biases pre-scaled);
* fused (q|k|v, gate|up of the local shards) in f32 against the port's
  fused single-device model within TOL_F32, and bf16 mode against the
  single-device model's bf16 mode within TOL_BF16;
* the collectives: two all-reduces a layer and one vocab gather a call;
* a dp=2 x tp=2 mesh (`gspmd.make_mesh`, four ranks): each dp group's rows
  through its tp group equal the single-device forward's, the counterpart
  of tests/test_sharding.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from squeezellm_tpu import formats as jformats
from squeezellm_tpu.models import common as jcommon
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.models import opt as jopt
from squeezellm_tpu.ops.quant_linear import QuantLinearSpec
from squeezellm_tpu.parallel import tp_shard_map as tpm
from squeezellm_tpu_torch.models import fuse
from squeezellm_tpu_torch.parallel import multihost
from test_torch_model import _module_meta
import torch_tp_workers as workers

# logits, relative to max |logit|: f32 on both sides, the row-parallel
# sums added in another order than one device's (or the JAX package's)
TOL_F32 = 1e-5
# bf16 mode: each row-parallel output is a sum of tp partials each rounded
# to bf16 (2**-9 relative) before the all-reduce, where one device rounds
# the whole sum once; two such sums a layer over two layers, the residual
# stream carried in bf16: a few bf16 steps at the top of the logit range
TOL_BF16 = 2.0**-6
PROMPT = np.array([[3, 141, 59, 26, 5, 35, 89]], np.int64)
FED = [79, 32, 38]  # teacher-forced decode tokens
JOIN_S = 240  # every launch's limit: a deadlock fails the test


def _linear(rng, o, i, bits, density, topx, bias):
    """One random quantized linear in the JAX package's format."""
    nw = jformats.n_words(i, bits)
    p = {"qweight": rng.integers(-2**31, 2**31, (nw, o),
                                 dtype=np.int64).astype(np.int32),
         "lut": np.sort(rng.standard_normal((o, 2**bits)).astype(np.float32)
                        * 0.1, axis=1)}
    nnz_pad = 0
    if density:
        dense = np.zeros((o, i), np.float32)
        mask = rng.random((o, i)) < density
        dense[mask] = rng.standard_normal(mask.sum()).astype(np.float32) * 0.3
        coo = jformats.SparseCOO.from_dense(dense, pad_multiple=64)
        p.update(sp_rows=coo.rows, sp_cols=coo.cols, sp_vals=coo.vals)
        nnz_pad = len(coo.vals)
    if topx:
        p["topx_weights"] = (rng.standard_normal((i, topx))
                             .astype(np.float32) * 0.1)
        p["topx_indices"] = rng.choice(o, topx, replace=False).astype(np.int32)
    if bias:
        p["bias"] = (0.1 * rng.standard_normal(o)).astype(np.float32)
    q = QuantLinearSpec(bits=bits, in_features=i, out_features=o,
                        has_bias=bias, nnz_pad=nnz_pad, topx=topx)
    return jcommon.LinearSpec(in_features=i, out_features=o, has_bias=bias,
                              quant=q), p


def make_tree(model_type, config, bits, seed, density=0.0, topx=0):
    """(specs, params) of a random quantized LLaMA or OPT (biases on OPT's
    six layer linears), lm_head quantized without sidecar."""
    rng = np.random.default_rng(seed)
    h, opt = config.hidden_size, model_type == "opt"

    def norm():
        w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
        return {"w": w, "b": (0.1 * rng.standard_normal(h)).astype(
            np.float32)} if opt else w

    spec_layers, layers = [], []
    for _ in range(config.n_layers):
        sd, pd = {}, {}
        for name, (o, i) in config.linear_shapes().items():
            sd[name], pd[name] = _linear(rng, o, i, bits, density, topx, opt)
        for n in (("attn_norm", "ffn_norm") if opt
                  else ("input_norm", "post_norm")):
            pd[n] = norm()
        spec_layers.append(sd)
        layers.append(pd)
    head_spec, head = _linear(rng, config.vocab_size, h, bits, 0.0, 0, False)
    params = {"embed": rng.standard_normal((config.vocab_size, h))
              .astype(np.float32), "layers": layers, "final_norm": norm(),
              "lm_head": head}
    if opt:
        params["embed_pos"] = (0.5 * rng.standard_normal(
            (config.max_seq + 2, h))).astype(np.float32)
    return {"layers": tuple(spec_layers), "lm_head": head_spec}, params


def port_tree(model_type, config, specs, params):
    """What a rank takes: (type, config dict, module meta, params)."""
    return (model_type, dataclasses.asdict(config), _module_meta(specs),
            params)


def jax_tp_logits(model_type, config, specs, params, tp):
    """The JAX package's shard_map TP: prefill then FED, as step_logits."""
    mesh = tpm.make_tp_mesh(tp)
    lspecs, sparams, pspecs = tpm.shard_model_params(model_type, config,
                                                     specs, params, tp)
    dparams = tpm.put_params(sparams, pspecs, mesh)
    prefill, decode = tpm.make_tp_step_fns(model_type, config, lspecs,
                                           pspecs, mesh, backend="xla")
    logits, cache = prefill(dparams, jnp.asarray(PROMPT, jnp.int32),
                            tpm.init_tp_cache(config, mesh))
    rows = [np.asarray(logits[0, -1])]
    for i, tok in enumerate(FED):
        logits, cache = decode(dparams, jnp.asarray([[tok]], jnp.int32),
                               jnp.asarray(PROMPT.shape[1] + i, jnp.int32),
                               cache)
        rows.append(np.asarray(logits[0, -1]))
    return np.stack(rows)


def single_logits(tree, fused, mode):
    model = workers.port_model(tree)
    if fused:
        fuse.fuse_for_decode(model)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    with torch.no_grad():
        return workers.step_logits(model, PROMPT, FED, dtype=dtype,
                                   mode=mode)


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def llama_config(tp):
    # hd 32; GQA (2 kv heads, one a rank) at tp=2, 4 kv heads at tp=4
    return jllama.LlamaConfig(vocab_size=256, hidden_size=128,
                              intermediate_size=256, n_layers=2, n_heads=4,
                              n_kv_heads=2 if tp == 2 else 4, max_seq=64)


OPT_CONFIG = jopt.OPTConfig(vocab_size=256, hidden_size=128, ffn_dim=256,
                            n_layers=2, n_heads=4, max_seq=64)

# (label, model type, bits, sidecar density, top-X, fused, mode, vs JAX)
CASES = {
    2: [("llama w4, no sidecar", "llama", 4, 0.0, 0, False, "exact", True),
        ("llama w4, 2% sidecar, top-X", "llama", 4, 0.02, 3, False, "exact",
         True),
        ("llama w4, 2% sidecar, top-X, fused", "llama", 4, 0.02, 3, True,
         "exact", False),
        ("llama w4, 2% sidecar, top-X, fused, bf16", "llama", 4, 0.02, 3,
         True, "bf16", False),
        ("opt w4, biases, 2% sidecar", "opt", 4, 0.02, 0, False, "exact",
         True)],
    4: [("llama w3, 2% sidecar, top-X", "llama", 3, 0.02, 3, False, "exact",
         True),
        ("llama w3, 2% sidecar, top-X, fused", "llama", 3, 0.02, 3, True,
         "exact", False),
        ("llama w4, bf16", "llama", 4, 0.02, 3, False, "bf16", False),
        ("opt w4, biases", "opt", 4, 0.0, 2, False, "exact", True)],
}


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_logits_match_jax_and_single_device(tp, tmp_path):
    trees, cases = {}, []
    for label, mt, bits, density, topx, fused, mode, _ in CASES[tp]:
        config = OPT_CONFIG if mt == "opt" else llama_config(tp)
        key = (mt, bits, density, topx)
        if key not in trees:
            specs, params = make_tree(mt, config, bits, seed=len(trees) + tp,
                                      density=density, topx=topx)
            trees[key] = (config, specs, params,
                          port_tree(mt, config, specs, params))
        cases.append((trees[key][3], fused, mode))
    ranks = multihost.launch(workers.forward_cases, tp,
                             args=(cases, PROMPT, FED),
                             init_file=str(tmp_path / "rendezvous"),
                             join_timeout_s=JOIN_S)
    for (label, mt, bits, density, topx, fused, mode, vs_jax), case, got \
            in zip(CASES[tp], cases, zip(*ranks)):
        logits = [g[0] for g in got]
        for r in range(1, tp):  # every rank ends with the same logits
            assert np.array_equal(logits[r], logits[0]), (label, r)
        n_layers = llama_config(tp).n_layers
        calls = 1 + len(FED)
        assert got[0][1] == {"all_reduce": 2 * n_layers * calls,
                             "gather": calls}, label
        tol = TOL_BF16 if mode == "bf16" else TOL_F32
        err = rel(logits[0], single_logits(case[0], fused, mode))
        assert err < tol, (label, "single device", err)
        if vs_jax:
            config, specs, params, _ = trees[(mt, bits, density, topx)]
            err = rel(logits[0], jax_tp_logits(mt, config, specs, params,
                                               tp))
            assert err < TOL_F32, (label, "JAX tp_shard_map", err)


def test_dp_by_tp_mesh_forward(tmp_path):
    config = llama_config(2)
    specs, params = make_tree("llama", config, 4, seed=7, density=0.02,
                              topx=3)
    tree = port_tree("llama", config, specs, params)
    tokens = np.random.default_rng(1).integers(0, config.vocab_size, (4, 8))
    ranks = multihost.launch(workers.dp_tp_forward, 4,
                             args=(tree, tokens, 2, 2),
                             init_file=str(tmp_path / "rendezvous"),
                             join_timeout_s=JOIN_S)
    # ranks 0, 1 form dp group 0's tp group, ranks 2, 3 dp group 1's
    assert [(d, t) for d, t, _ in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    with torch.no_grad():
        want = workers.port_model(tree).forward(
            torch.as_tensor(tokens)).numpy()
    for d in range(2):
        a, b = ranks[2 * d][2], ranks[2 * d + 1][2]
        assert np.array_equal(a, b)
        assert rel(a, want[2 * d: 2 * d + 2]) < TOL_F32
