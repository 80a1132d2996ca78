"""Architecture adapter: model type -> implementation (LLaMA family).

The counterpart of the JAX package's ``models/registry.py``; OPT waits for
its own slice of the port.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from squeezellm_tpu_torch.models import llama as llama_mod

# mistral/vicuna/xgen are llama-architecture variants (different configs).
_REGISTRY = {
    "llama": llama_mod,
    "mistral": llama_mod,
    "vicuna": llama_mod,
    "xgen": llama_mod,
}


def get_model_module(model_type: str):
    if model_type == "opt":
        raise NotImplementedError(
            "OPT is not ported yet: it comes with the OPT slice of the port")
    if model_type not in _REGISTRY:
        raise ValueError(
            f"unknown model type {model_type!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[model_type]


def parse_model_type(name_or_path: str,
                     hf_config: Optional[dict] = None) -> str:
    """Model type from an HF config dict (preferred) or the path name."""
    if hf_config is not None and "model_type" in hf_config:
        mt = hf_config["model_type"]
        if mt in _REGISTRY or mt == "opt":
            return mt
        if mt == "llama2":
            return "llama"
    low = str(name_or_path).lower()
    for t in ("opt", "mistral", "xgen", "vicuna"):
        if t in low:
            return t
    return "llama"


def load_config(model_dir: str):
    """(model_type, config) from an HF-style model dir with config.json."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    model_type = parse_model_type(model_dir, hf)
    return model_type, get_model_module(model_type).LlamaConfig.from_hf_config(hf)
