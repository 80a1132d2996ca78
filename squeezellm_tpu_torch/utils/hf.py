"""Dense HF checkpoints: the input of ``fisher`` and ``quantize``.

The port of the JAX package's ``utils/hf.py`` (state dict loading). A
model directory holds ``config.json`` and its weights as ``*.safetensors``
or ``pytorch_model*.bin`` (``*.pt``). The ``.bin`` files go through
``torch.load`` (weights only); the safetensors files are read here
directly, since the machine with the card has no ``safetensors`` package:
an 8-byte little-endian header length, a JSON header naming each tensor's
dtype, shape and byte range, then the raw little-endian bytes.
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

