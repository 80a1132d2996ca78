"""The reference's packed checkpoints (``.pt``) -> the shared checkpoint
format.

The port of the JAX package's ``convert.py``. A published SqueezeLLM
checkpoint is a state dict of the reference's ``QuantLinearLUT`` buffers:

  <prefix>.qweight        int32 (in // 32 * bits, out), the reference layout
                          (``formats.pack_codes_ref``: 3-bit codes spill
                          across word boundaries)
  <prefix>.lookup_table   (out, 2**bits)
  <prefix>.rows/cols/vals CSR sparse sidecar, already zero-corrected
  <prefix>.full_rows/full_row_indices   hybrid top-X dense channels
  <prefix>.bias           where the linear has one (OPT)
  sparse_threshold.<name> nnz sentinels (dropped: sizes are recomputed)

beside the model's other tensors (embeddings, norms, lm_head), which
published checkpoints hold in fp16. Every packed weight is unpacked and
repacked in the shared layout on ``device`` (a 7B-wide w3 model holds
~6.5e9 codes), and the tree is written by ``checkpoint.save_quantized``
with no SpMV slot plans (a TPU layout the port does not build): the JAX
package's ``convert_reference_checkpoint(..., build_spmv=False)``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from squeezellm_tpu_torch import checkpoint, formats
from squeezellm_tpu_torch.models import registry
from squeezellm_tpu_torch.models.common import LinearSpec
from squeezellm_tpu_torch.ops.quant_linear import QuantLinearSpec


def _tensor(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.asarray(t))


def _f32(t) -> np.ndarray:
    """A tensor (fp16 in published checkpoints) as f32 numpy."""
    return _tensor(t).detach().cpu().float().numpy()


def _linear(sd, p: str, in_f: int, out_f: int, wbits: int,
            nnz_pad_multiple: int, device):
    """One quantized linear of the reference state dict -> (QuantLinearSpec,
    numpy params of the shared format)."""
    qweight = _tensor(sd[p + "qweight"]).to(device)
    params = {
        "qweight": formats.convert_ref_qweight(qweight, wbits,
                                               in_f).cpu().numpy(),
        "lut": _f32(sd[p + "lookup_table"]),
    }
    has_bias = (p + "bias") in sd
    if has_bias:
        params["bias"] = _f32(sd[p + "bias"])
    nnz = 0
    if (p + "rows") in sd:
        coo = formats.SparseCOO.from_csr(sd[p + "rows"], sd[p + "cols"],
                                         sd[p + "vals"], in_f,
                                         pad_multiple=nnz_pad_multiple)
        params.update(sp_rows=coo.rows, sp_cols=coo.cols, sp_vals=coo.vals)
        nnz = coo.nnz
    topx = 0
    if (p + "full_rows") in sd and _tensor(sd[p + "full_rows"]).numel():
        params["topx_weights"] = _f32(sd[p + "full_rows"])
        params["topx_indices"] = _tensor(
            sd[p + "full_row_indices"]).cpu().numpy().astype(np.int32)
        topx = params["topx_indices"].shape[0]
    spec = QuantLinearSpec(bits=wbits, in_features=in_f,
                           out_features=out_f, has_bias=has_bias, nnz=nnz,
                           topx=topx)
    return spec, params


def convert_state_dict(sd: Dict[str, object], model_type: str, config,
                       wbits: int, nnz_pad_multiple: int = 512,
                       device="cuda"):
    """Reference state dict (tensors or numpy) -> (specs, params): the
    port's LinearSpec tree and a tree of numpy arrays in the checkpoint
    format, as ``quantize.pipeline.quantize_model`` returns them. The
    lm_head stays dense (the reference keeps it fp16); without an
    ``lm_head.weight`` it is the embedding (tied)."""
    is_opt = model_type == "opt"
    module_map = registry.get_model_module(model_type).HF_NAMES
    layer_prefix = "model.decoder.layers" if is_opt else "model.layers"
    shapes = config.linear_shapes()
    spec_layers, param_layers = [], []
    for li in range(config.n_layers):
        spec_d, param_d = {}, {}
        for name, hf_name in module_map.items():
            out_f, in_f = shapes[name]
            qspec, param_d[name] = _linear(
                sd, f"{layer_prefix}.{li}.{hf_name}.", in_f, out_f, wbits,
                nnz_pad_multiple, device)
            spec_d[name] = LinearSpec(in_features=in_f, out_features=out_f,
                                      has_bias=qspec.has_bias, quant=qspec)
        lp = f"{layer_prefix}.{li}."
        if is_opt:
            for key, hf_name in (("attn_norm", "self_attn_layer_norm"),
                                 ("ffn_norm", "final_layer_norm")):
                param_d[key] = {"w": _f32(sd[f"{lp}{hf_name}.weight"]),
                                "b": _f32(sd[f"{lp}{hf_name}.bias"])}
        else:
            param_d["input_norm"] = _f32(sd[lp + "input_layernorm.weight"])
            param_d["post_norm"] = _f32(
                sd[lp + "post_attention_layernorm.weight"])
        spec_layers.append(spec_d)
        param_layers.append(param_d)

    top = "model.decoder." if is_opt else "model."
    embed = _f32(sd[top + "embed_tokens.weight"])
    head = (_f32(sd["lm_head.weight"]) if "lm_head.weight" in sd
            else embed)
    params = {"embed": embed, "lm_head": {"w": head}}
    if is_opt:
        params["embed_pos"] = _f32(sd[top + "embed_positions.weight"])
        params["final_norm"] = {"w": _f32(sd[top + "final_layer_norm.weight"]),
                                "b": _f32(sd[top + "final_layer_norm.bias"])}
    else:
        params["final_norm"] = _f32(sd[top + "norm.weight"])
    params["layers"] = param_layers
    specs = {"layers": tuple(spec_layers),
             "lm_head": LinearSpec(in_features=head.shape[1],
                                   out_features=head.shape[0])}
    return specs, params


def _tick(stats, key, t0, device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    if stats is not None:
        stats[key] = now - t0
    return now


def convert_reference_checkpoint(ckpt_path: str, model_dir: str, wbits: int,
                                 out_path: str,
                                 model_type: Optional[str] = None,
                                 nnz_pad_multiple: int = 512, device="cuda",
                                 stats: Optional[Dict[str, float]] = None
                                 ) -> None:
    """Read a reference ``.pt`` checkpoint and the model directory's
    ``config.json``, and write the shared checkpoint to ``out_path``.
    stats: an optional dict that receives the seconds of 'load' (the
    ``.pt`` onto the host), 'convert' (unpack and repack on ``device``)
    and 'save'."""
    detected, config = registry.load_config(model_dir)
    model_type = model_type or detected
    t = time.perf_counter()
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    # sentinels and rope tables: metadata, not weights
    sd = {k: v for k, v in sd.items()
          if not k.startswith("sparse_threshold.")
          and not k.endswith("rotary_emb.inv_freq")}
    t = _tick(stats, "load", t, device)
    specs, params = convert_state_dict(sd, model_type, config, wbits,
                                       nnz_pad_multiple=nnz_pad_multiple,
                                       device=device)
    del sd
    t = _tick(stats, "convert", t, device)
    checkpoint.save_quantized(out_path, model_type, config, specs, params)
    _tick(stats, "save", t, "cpu")
