"""Write and read the shared quantized checkpoint format.

The format (the JAX package's ``checkpoint.py`` defines it; a checkpoint
either package writes loads in the other):

  ckpt_dir/
    manifest.json   format name and version, model_type, wbits, config,
                    per-module flags (quant, bits, has_bias, topx, ...)
    globals.npz     embed, final_norm, lm_head (dotted keys)
    layer_XXX.npz   per-layer module tensors + layer norms

``save_quantized`` writes the tree ``quantize.pipeline.quantize_model``
returns. It writes no SpMV slot plans (a TPU layout): the manifest's
``sg_rows``, ``sg_oh`` and ``sg_ih`` are 0, which the JAX loader takes as
"no plan". ``load_quantized`` sends the tensors through
:func:`carry.from_tree`, the same path the tests use for trees handed over
in memory.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np

from squeezellm_tpu_torch import carry

FORMAT_NAME = "squeezellm-tpu"
FORMAT_VERSION = 1


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _module_meta(spec, p) -> Dict[str, Any]:
    """A linear's manifest entry; ``nnz_pad`` is the stored COO length."""
    meta = {"has_bias": spec.has_bias, "quant": spec.is_quant}
    if spec.is_quant:
        meta.update(bits=spec.quant.bits,
                    nnz_pad=int(len(p["sp_vals"])) if "sp_vals" in p else 0,
                    topx=spec.quant.topx, sg_rows=0, sg_oh=0, sg_ih=0)
    return meta


def save_quantized(path: str, model_type: str, config, specs,
                   params) -> None:
    """Write (specs, params) as the JAX package's ``save_quantized`` does:
    specs the port's LinearSpec tree, params a tree of numpy arrays (the
    quantized linears in COO form)."""
    os.makedirs(path, exist_ok=True)
    modules = {}
    for li, (spec_d, layer) in enumerate(zip(specs["layers"],
                                             params["layers"])):
        for name, spec in spec_d.items():
            modules[f"{li}.{name}"] = _module_meta(spec, layer[name])
    if specs["lm_head"].is_quant:
        modules["lm_head"] = _module_meta(specs["lm_head"], params["lm_head"])
    wbits = next((m["bits"] for m in modules.values() if m["quant"]), None)
    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "model_type": model_type,
        "wbits": wbits,
        "n_layers": len(params["layers"]),
        "config": (config.manifest() if hasattr(config, "manifest")
                   else dataclasses.asdict(config)),
        "modules": modules,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    g = {k: v for k, v in params.items() if k != "layers"}
    np.savez(os.path.join(path, "globals.npz"), **_flatten(g))
    for li, layer in enumerate(params["layers"]):
        np.savez(os.path.join(path, f"layer_{li:03d}.npz"),
                 **_flatten(layer))


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _load_npz(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def load_quantized(path: str, device="cuda"):
    """Returns (model_type, model) with every tensor on ``device``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_NAME:
        raise ValueError(f"{path}: not a {FORMAT_NAME} checkpoint")
    if manifest.get("version") != FORMAT_VERSION:
        raise ValueError(f"{path}: format version {manifest.get('version')}"
                         f", this reader knows {FORMAT_VERSION}")
    params = _load_npz(os.path.join(path, "globals.npz"))
    params["layers"] = [
        _load_npz(os.path.join(path, f"layer_{li:03d}.npz"))
        for li in range(manifest["n_layers"])
    ]
    model = carry.from_tree(manifest["model_type"], manifest["config"],
                            manifest["modules"], params, device)
    return manifest["model_type"], model
