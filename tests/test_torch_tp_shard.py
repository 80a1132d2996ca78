"""The port's sharding plan against the JAX package's, without processes.

* `parallel.tp.shard_linear` at tp=2 and tp=4, column- (q) and row-parallel
  (down), 4-bit and 3-bit, with a sidecar, top-X and a bias, and a dense
  linear with a bias: each rank's shard equals the JAX
  `tp_shard_map.shard_linear` arrays at that rank: qweight bit-equal (the
  row-parallel split falls inside a word: 55 and 25 inputs a rank), LUT
  and bias equal (the row-parallel bias pre-scaled by 1/tp), top-X equal
  once the JAX padding channels are dropped, the sidecar the same set of
  (row, column, value) entries once the JAX zero padding is dropped;
* the shards dequantize to the full weight's blocks, and a column- or
  row-parallel product reassembles the full linear's output;
* `gspmd.validate_shardable` gives the JAX package's messages;
* `gspmd.param_partition_specs` (placements over ('dp', 'tp')) mirrors
  the JAX `param_partition_specs` tree, LLaMA and OPT; the cache's
  placements mirror `cache_partition_specs`.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from jax.sharding import PartitionSpec as P

from squeezellm_tpu.models import common as jcommon
from squeezellm_tpu.models import llama as jllama
from squeezellm_tpu.models import opt as jopt
from squeezellm_tpu.parallel import gspmd as jgspmd
from squeezellm_tpu.parallel import tp_shard_map as tpm
from squeezellm_tpu_torch import carry
from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.ops import plain_ops
from squeezellm_tpu_torch.parallel import gspmd, tp
from test_torch_model import _module_meta
from test_torch_tp import OPT_CONFIG, _linear, make_tree

IN = {2: 110, 4: 100}  # inputs: 55 / 25 a rank, inside a 3- and 4-bit word


def _full(name, bits, tp_size, bias=True):
    """(JAX spec, JAX params, the port's full Linear) of one linear."""
    rng = np.random.default_rng(tp_size * 10 + bits)
    o, i = (48, IN[tp_size]) if name == "q" else (40, IN[tp_size])
    spec, p = _linear(rng, o, i, bits, 0.05, 5, bias)
    meta = {"quant": True, "bits": bits, "has_bias": bias}
    return spec, p, carry.linear_from_tree(i, meta, p, "cpu")


def _entries(rowptr, cols, vals):
    rows = np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr))
    return set(zip(rows.tolist(), cols.tolist(), vals.tolist()))


@pytest.mark.parametrize("tp_size", [2, 4])
@pytest.mark.parametrize("name", ["q", "down"])
@pytest.mark.parametrize("bits", [4, 3])
def test_shard_linear_equals_jax(tp_size, name, bits):
    spec, p, full = _full(name, bits, tp_size)
    col = name == "q"
    jlocal, jp, _ = tpm.shard_linear(name, spec, p, tp_size)
    w_full = plain_ops.dequantize(full.qweight, full.lut, bits,
                                  full.spec.in_features)
    x = torch.randn(3, full.spec.in_features, generator=torch.Generator()
                    .manual_seed(tp_size))
    want = full(x)
    parts = []
    for r in range(tp_size):
        local = tp.shard_linear(name, full, r, tp_size)
        t = {k: v.numpy() for k, v in local.tensors().items()}
        q = local.spec.quant
        assert (q.in_features, q.out_features) == (
            jlocal.quant.in_features, jlocal.quant.out_features)
        np.testing.assert_array_equal(t["qweight"], jp["qweight"][r])
        np.testing.assert_array_equal(
            t["lut"], jp["lut"][r] if col else jp["lut"])
        np.testing.assert_array_equal(
            t["bias"], jp["bias"][r] if col else jp["bias"])
        # the sidecar: the JAX shard's live entries, as a set
        jr, jc, jv = (jp[k][r] for k in ("sp_rows", "sp_cols", "sp_vals"))
        live = jv != 0
        want_e = set(zip(jr[live].tolist(), jc[live].tolist(),
                         jv[live].tolist()))
        got_e = (_entries(t["sp_rowptr"], t["sp_cols"], t["sp_vals"])
                 if q.nnz else set())
        assert got_e == want_e and q.nnz == len(want_e)
        # top-X: the JAX padding (zero-weight channels at index 0) dropped
        if col:
            n = q.topx
            ji = jp["topx_indices"][r]
            lo, hi = r * q.out_features, (r + 1) * q.out_features
            assert n == int(((p["topx_indices"] >= lo)
                             & (p["topx_indices"] < hi)).sum())
            if n:
                np.testing.assert_array_equal(t["topx_indices"], ji[:n])
                np.testing.assert_array_equal(t["topx_weights"],
                                              jp["topx_weights"][r][:, :n])
        else:
            np.testing.assert_array_equal(t["topx_indices"],
                                          jp["topx_indices"])
            np.testing.assert_array_equal(t["topx_weights"],
                                          jp["topx_weights"][r])
        # the shard dequantizes to its block of the full weight
        w = plain_ops.dequantize(local.qweight, local.lut, bits,
                                 q.in_features)
        lo_i = r * q.in_features
        block = (w_full[:, r * q.out_features:(r + 1) * q.out_features]
                 if col else w_full[lo_i: lo_i + q.in_features])
        assert torch.equal(w, block)
        xl = x if col else x[:, lo_i: lo_i + q.in_features]
        parts.append(local(xl))
    got = torch.cat(parts, -1) if col else sum(parts)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("tp_size", [2, 4])
def test_dense_linear_shards_equal_jax(tp_size):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((24, 16)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    spec = jcommon.LinearSpec(in_features=16, out_features=24, has_bias=True)
    for name in ("q", "o"):
        wj = w if name == "q" else w.T.copy()  # o: 16 inputs split
        bj = b if name == "q" else b[:16].copy()
        sj = spec if name == "q" else dataclasses.replace(
            spec, in_features=24, out_features=16)
        _, jp, _ = tpm.shard_linear(name, sj, {"w": wj, "b": bj}, tp_size)
        full = carry.linear_from_tree(wj.shape[1],
                                      {"quant": False, "has_bias": True},
                                      {"w": wj, "b": bj}, "cpu")
        for r in range(tp_size):
            t = tp.shard_linear(name, full, r, tp_size).tensors()
            np.testing.assert_array_equal(t["w"].numpy(), jp["w"][r])
            np.testing.assert_array_equal(
                t["b"].numpy(), jp["b"][r] if name == "q" else jp["b"])


def test_validate_shardable_gives_jax_messages():
    cases = [(jllama.LlamaConfig(), 4), (jllama.LlamaConfig(n_heads=6,
                                                            n_kv_heads=6), 4),
             (jllama.LlamaConfig(n_kv_heads=2), 4),
             (jllama.LlamaConfig(intermediate_size=11010), 4),
             (jllama.LlamaConfig(vocab_size=32001), 2),
             (jopt.OPTConfig(ffn_dim=8190), 4)]
    for config, tp_size in cases:
        mt = "opt" if isinstance(config, jopt.OPTConfig) else "llama"
        assert (gspmd.validate_shardable(mt, config, tp_size)
                == jgspmd.validate_shardable(mt, config, tp_size))


def _placement(spec):
    """A JAX PartitionSpec as (dp, tp) placements of a tensor."""
    dims = [i for i, a in enumerate(spec) if a == "tp"]
    return (Replicate(), Shard(dims[0]) if dims else Replicate())


def _as_placements(tree):
    if isinstance(tree, P):
        return _placement(tree)
    if isinstance(tree, dict):
        return {("sp_rowptr" if k == "sp_rows" else k): _as_placements(v)
                for k, v in tree.items()}
    return [_as_placements(v) for v in tree]


@pytest.mark.parametrize("model_type", ["llama", "opt"])
def test_placement_tree_mirrors_jax_partition_specs(model_type):
    config = OPT_CONFIG if model_type == "opt" else jllama.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256, n_layers=2,
        n_heads=4, n_kv_heads=2, max_seq=64)
    specs, params = make_tree(model_type, config, 4, seed=2, density=0.05,
                              topx=2)
    # a dense lm_head, whose {'w'} the JAX tree places column-parallel
    rng = np.random.default_rng(0)
    params["lm_head"] = {"w": rng.standard_normal(
        (config.vocab_size, config.hidden_size)).astype(np.float32)}
    specs = dict(specs, lm_head=jcommon.LinearSpec(
        in_features=config.hidden_size, out_features=config.vocab_size))
    model = carry.from_tree(model_type, dataclasses.asdict(config),
                            _module_meta(specs), params, "cpu")
    want = _as_placements(jgspmd.param_partition_specs(
        model_type, config, specs, params))
    assert gspmd.param_partition_specs(model) == want
    cache = common.init_kv_cache(2, 16, config.n_layers, config.n_kv_heads,
                                 config.head_dim, torch.float32, "cpu")
    assert gspmd.cache_partition_specs(cache) == [
        {k: tuple(Shard(i) for i, a in enumerate(s) if a is not None)
         for k, s in layer.items()}
        for layer in jgspmd.cache_partition_specs(cache)]
