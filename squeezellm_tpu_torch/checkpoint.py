"""Read the shared quantized checkpoint format into the port's model.

The format (written by the JAX package's ``checkpoint.save_quantized``):

  ckpt_dir/
    manifest.json   format name and version, model_type, wbits, config,
                    per-module flags (quant, bits, has_bias, topx, ...)
    globals.npz     embed, final_norm, lm_head (dotted keys)
    layer_XXX.npz   per-layer module tensors + layer norms

The tensors go through :func:`carry.from_tree`, the same path the tests
use for trees handed over in memory.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from squeezellm_tpu_torch import carry

FORMAT_NAME = "squeezellm-tpu"
FORMAT_VERSION = 1


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
