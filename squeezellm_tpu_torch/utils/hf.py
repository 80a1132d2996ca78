"""Dense HF checkpoints, the input of ``fisher``, ``quantize``, ``chunk``
and ``pack``, and the model directory's tokenizer.

The port of the JAX package's ``utils/hf.py``. A
model directory holds ``config.json`` and its weights as ``*.safetensors``
or ``pytorch_model*.bin`` (``*.pt``). The ``.bin`` files go through
``torch.load`` (weights only); the safetensors files are read here
directly, since the machine with the card has no ``safetensors`` package:
an 8-byte little-endian header length, a JSON header naming each tensor's
dtype, shape and byte range, then the raw little-endian bytes.

The tokenizer is read from the files a model family ships: XGen's
``gpt2.tiktoken`` / ``encoder.json`` through the port's own
:class:`~squeezellm_tpu_torch.utils.xgen_tokenizer.XgenTokenizer`, every
other family's through ``transformers.AutoTokenizer`` (imported at first
use). The repository's ``models/`` directories hold ``config.json`` only.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Tuple

import torch

from squeezellm_tpu_torch.models import registry

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        raw = (torch.frombuffer(data, dtype=torch.uint8, offset=begin,
                                count=end - begin) if end > begin
               else torch.empty(0, dtype=torch.uint8))
        out[name] = raw.view(dtype).reshape(info["shape"]).clone()
    return out


def load_dense_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """The state dict of an HF model directory, on the CPU."""
    safes = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if safes:
        sd = {}
        for path in safes:
            sd.update(read_safetensors(path))
        return sd
    bins = (sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
            or sorted(glob.glob(os.path.join(model_dir, "*.pt"))))
    if bins:
        sd = {}
        for path in bins:
            sd.update(torch.load(path, map_location="cpu", weights_only=True))
        return sd
    raise FileNotFoundError(
        f"no weights (*.safetensors / pytorch_model*.bin) in {model_dir}")


def load_dense_model(model_dir: str,
                     dtype=torch.float32) -> Tuple[str, object, dict]:
    """HF model dir -> (model_type, config, dense params tree on the CPU)."""
    model_type, config = registry.load_config(model_dir)
    sd = load_dense_state_dict(model_dir)
    params = registry.get_model_module(model_type).from_torch_state_dict(
        config, sd, dtype)
    return model_type, config, params


# the tokenizer files of each family, any one of which makes a tokenizer
TOKENIZER_FILES = ("tokenizer.model", "tokenizer.json", "vocab.json",
                   "gpt2.tiktoken", "encoder.json")


def has_tokenizer(model_dir: str) -> bool:
    return any(os.path.exists(os.path.join(model_dir, f))
               for f in TOKENIZER_FILES)


def load_tokenizer(model_dir: str):
    """The model directory's tokenizer: XGen's assets through the port's
    byte-level BPE, others through ``transformers.AutoTokenizer``; a
    directory without assets raises a FileNotFoundError naming the files
    each family needs."""
    if any(os.path.exists(os.path.join(model_dir, f))
           for f in ("gpt2.tiktoken", "encoder.json")):
        from squeezellm_tpu_torch.utils.xgen_tokenizer import XgenTokenizer

        return XgenTokenizer.from_assets(model_dir)
    if not has_tokenizer(model_dir):
        raise FileNotFoundError(
            f"no tokenizer assets in {model_dir!r}. The models/ zoo ships "
            "config.json only (tokenizer files are download-blocked and "
            "license-encumbered — see models/README.md): drop in "
            "tokenizer.model (llama/vicuna/mistral), vocab.json + "
            "merges.txt (opt), or gpt2.tiktoken/encoder.json (xgen) from "
            "the family's HF repo. Token-ID workflows (quantize, "
            "benchmark, serve-bench, prompt_tokens) need no tokenizer.")
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_dir, use_fast=False,
                                         trust_remote_code=True)
