"""Weights carried across: the JAX package's parameter tree (numpy arrays)
-> the port's model.

One code path for the checkpoint loader and the tests. The COO sparse
sidecar becomes CSR: entries with ``vals == 0`` are dropped (the padding
points at row 0 at the end of the array), the rest sorted stably by row.
SpMV slot plans and other TPU-side derived arrays in the tree are not read.
``pools_from_jax`` carries a JAX ``PagedKVPool``'s page pools across the
same way.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from squeezellm_tpu_torch import formats
from squeezellm_tpu_torch.models import registry
from squeezellm_tpu_torch.models.common import Linear, LinearSpec
from squeezellm_tpu_torch.ops.quant_linear import QuantLinearSpec


def to_tensor(a, device) -> torch.Tensor:
    """numpy (or array-like, bf16 included) or a tensor -> torch tensor on
    device."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def csr_from_coo(rows, cols, vals, out_features: int, in_features: int):
    """COO sidecar -> (rowptr (out+1,), cols, vals) as numpy, without the
    ``vals == 0`` padding, sorted stably by row."""
    rows = np.asarray(rows).astype(np.int64)
    cols = np.asarray(cols).astype(np.int64)
    vals = np.asarray(vals).astype(np.float32)
    live = vals != 0
    rows, cols, vals = rows[live], cols[live], vals[live]
    if rows.size and (rows.min() < 0 or rows.max() >= out_features
                      or cols.min() < 0 or cols.max() >= in_features):
        raise ValueError("sparse sidecar index out of range for "
                         f"({out_features}, {in_features})")
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    rowptr = np.zeros(out_features + 1, np.int32)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=out_features))
    return rowptr, cols.astype(np.int32), vals


def _in_features(config, name: str) -> int:
    """Inputs of a layer's linear, fused names (qkv, gateup) included:
    only the down projection reads the MLP's inner width."""
    if name == "down":
        return config.linear_shapes()["down"][1]
    return config.hidden_size


def linear_from_tree(in_f: int, meta: Dict[str, Any], p,
                     device) -> Linear:
    """One linear of the tree (dense {'w', 'b'?} or quantized, ``in_f``
    inputs) as a port Linear."""
    has_bias = bool(meta.get("has_bias", False))
    if not meta.get("quant"):
        w = to_tensor(p["w"], device)
        tensors = {"w": w}
        if has_bias:
            tensors["b"] = to_tensor(p["b"], device)
        return Linear(LinearSpec(in_features=w.shape[1],
                                 out_features=w.shape[0],
                                 has_bias=has_bias), tensors)
    bits = int(meta["bits"])
    lut = np.asarray(p["lut"], np.float32)
    out_f = lut.shape[0]
    qweight = np.asarray(p["qweight"])
    if qweight.shape != (formats.n_words(in_f, bits), out_f):
        raise ValueError(f"qweight shape {qweight.shape} does not "
                         f"fit ({in_f} in, {out_f} out, {bits} bits)")
    tensors = {"qweight": to_tensor(qweight.astype(np.int32), device),
               "lut": to_tensor(lut, device)}
    nnz = 0
    if "sp_rows" in p:
        rowptr, cols, vals = csr_from_coo(p["sp_rows"], p["sp_cols"],
                                          p["sp_vals"], out_f, in_f)
        nnz = len(vals)
        if nnz:
            tensors.update(sp_rowptr=to_tensor(rowptr, device),
                           sp_cols=to_tensor(cols, device),
                           sp_vals=to_tensor(vals, device))
    topx = 0
    if "topx_weights" in p:
        idx = np.asarray(p["topx_indices"]).astype(np.int32)
        if idx.size and (idx.min() < 0 or idx.max() >= out_f):
            raise ValueError("topx index out of range")
        tensors.update(
            topx_weights=to_tensor(np.asarray(p["topx_weights"], np.float32),
                                   device),
            topx_indices=to_tensor(idx, device))
        topx = len(idx)
    if has_bias:
        tensors["bias"] = to_tensor(np.asarray(p["bias"], np.float32), device)
    q = QuantLinearSpec(bits=bits, in_features=in_f, out_features=out_f,
                        has_bias=has_bias, nnz=nnz, topx=topx)
    return Linear(LinearSpec(in_features=in_f, out_features=out_f,
                             has_bias=has_bias, quant=q), tensors)


def dense_module_meta(model_type: str, config) -> Dict[str, Dict[str, Any]]:
    """The ``module_meta`` of an all-dense tree (``utils.hf``): every layer
    linear and the lm_head dense, the layer linears with a bias on OPT."""
    bias = model_type == "opt"
    meta = {f"{li}.{name}": {"quant": False, "has_bias": bias}
            for li in range(config.n_layers)
            for name in config.linear_shapes()}
    meta["lm_head"] = {"quant": False}
    return meta


def from_tree(model_type: str, config_dict: Dict[str, Any],
              module_meta: Dict[str, Dict[str, Any]], params_np,
              device="cuda"):
    """Build the port's model from the JAX package's parameter tree.

    config_dict: the config's fields (the manifest's ``config``);
    module_meta: the manifest's ``modules`` dict (``"<layer>.<name>"`` and
    ``"lm_head"`` -> {quant, bits, has_bias, topx, ...}); params_np: the
    tree {'embed', 'layers': [{name: {...}, 'input_norm', 'post_norm'}],
    'final_norm', 'lm_head'} of numpy arrays. An OPT tree has 'embed_pos'
    beside 'embed', and its norms ('attn_norm' and 'ffn_norm' in a layer,
    'final_norm') are {'w', 'b'} pairs."""
    mod = registry.get_model_module(model_type)
    config = registry.config_class(model_type)(**config_dict)
    is_opt = model_type == "opt"

    def norm(p):  # an OPT layer norm: (w, b)
        return to_tensor(p["w"], device), to_tensor(p["b"], device)

    layers = []
    for li, lp in enumerate(params_np["layers"]):
        prefix = f"{li}."
        names = [k[len(prefix):] for k in module_meta if k.startswith(prefix)]
        linears = {
            name: linear_from_tree(_in_features(config, name),
                                   module_meta[prefix + name], lp[name],
                                   device)
            for name in names
        }
        if is_opt:
            layers.append(mod.DecoderLayer(
                config, linears, {n: norm(lp[n])
                                  for n in ("attn_norm", "ffn_norm")}))
        else:
            layers.append(mod.DecoderLayer(
                config, linears, to_tensor(lp["input_norm"], device),
                to_tensor(lp["post_norm"], device)))
    head_meta = module_meta.get("lm_head", {"quant": False})
    lm_head = linear_from_tree(config.hidden_size, head_meta,
                               params_np["lm_head"], device)
    embed = to_tensor(params_np["embed"], device)
    if is_opt:
        return mod.OPT(config, embed, to_tensor(params_np["embed_pos"],
                                                device), layers,
                       norm(params_np["final_norm"]), lm_head)
    return mod.Llama(config, embed, layers,
                     to_tensor(params_np["final_norm"], device), lm_head)


def pools_from_jax(pools_np, n_kv_heads: int, device="cuda"):
    """A JAX ``PagedKVPool.pools`` list (numpy arrays: per layer 'pk'/'pv'
    (P, ps, Hkv*hd) and, for an int8 pool, the scale sidecars 'sk'/'sv'
    (P, HkvP, ps) with the head rows padded to 8) -> the port's pool
    tensors: the same pages, the sidecars cut to their ``n_kv_heads`` live
    rows."""
    out = []
    for layer in pools_np:
        d = {name: to_tensor(layer[name], device) for name in ("pk", "pv")}
        for name in ("sk", "sv"):
            if name in layer:
                d[name] = to_tensor(
                    np.asarray(layer[name])[:, :n_kv_heads], device)
        out.append(d)
    return out
