"""Architecture adapter: model type -> implementation (the LLaMA family,
OPT, and Mellum's sparse experts).

The counterpart of the JAX package's ``models/registry.py``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from squeezellm_tpu_torch.models import llama as llama_mod
from squeezellm_tpu_torch.models import moe as moe_mod
from squeezellm_tpu_torch.models import opt as opt_mod

# mistral/vicuna/xgen are llama-architecture variants (different configs).
_REGISTRY = {
    "llama": llama_mod,
    "mistral": llama_mod,
    "vicuna": llama_mod,
    "xgen": llama_mod,
    "opt": opt_mod,
    # LLaMA-family attention with sparse experts (models/moe.py)
    "mellum": moe_mod,
}


def get_model_module(model_type: str):
    if model_type not in _REGISTRY:
        raise ValueError(
            f"unknown model type {model_type!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[model_type]


def parse_model_type(name_or_path: str,
                     hf_config: Optional[dict] = None) -> str:
    """Model type from an HF config dict (preferred) or the path name."""
    if hf_config is not None and "model_type" in hf_config:
        mt = hf_config["model_type"]
        if mt in _REGISTRY:
            return mt
        if mt == "llama2":
            return "llama"
    low = str(name_or_path).lower()
    for t in ("opt", "mistral", "xgen", "vicuna"):
        if t in low:
            return t
    return "llama"


def config_class(model_type: str):
    mod = get_model_module(model_type)
    return {opt_mod: opt_mod.OPTConfig,
            moe_mod: moe_mod.MoEConfig}.get(mod, llama_mod.LlamaConfig)


def load_config(model_dir: str):
    """(model_type, config) from an HF-style model dir with config.json."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    model_type = parse_model_type(model_dir, hf)
    return model_type, config_class(model_type).from_hf_config(hf)
