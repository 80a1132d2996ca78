"""End to end quantization: dense model params -> quantized (specs, params),
on the card one layer at a time.

The port of the JAX package's ``quantize/pipeline.py``, the in-memory form
of the reference's offline pipeline (chunk -> outlier config -> k-means ->
pack) in one pass per layer:

  per layer, per module:
    1. (optional) extract outliers: sensitivity top-s% by grad^2 and/or
       |w| >= an IQR threshold                      [outliers.py]
    2. fit per-output-channel weighted k-means codebooks on the zeroed
       dense weight (free, or 4-bit structured)      [kmeans.py]
    3. pack codes + LUT + zero-corrected sparse COO  [ops.quant_linear]

A layer's weights (and gradients) move to ``device`` as f32 only while it
is quantized, and its packed arrays come back to the host as numpy, so a
7B model never needs all its f32 weights on the card at once. The result
is the checkpoint's tree: ``checkpoint.save_quantized`` writes it and
``carry.from_tree`` makes the port's model of it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from squeezellm_tpu_torch.models.common import LinearSpec
from squeezellm_tpu_torch.ops.quant_linear import pack_linear
from squeezellm_tpu_torch.quantize import kmeans as kmeans_mod
from squeezellm_tpu_torch.quantize import outliers as outliers_mod


def to_device(t, device) -> torch.Tensor:
    """A weight, gradient or bias (tensor or numpy) as f32 on device."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t, np.float32))
    return t.detach().to(device=device, dtype=torch.float32)


def to_host(t):
    """A tensor as numpy (f32 when it was a float type), a dict of them (an
    OPT norm's {'w', 'b'}) as a dict of numpy; numpy as it is."""
    if isinstance(t, dict):
        return {k: to_host(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return t


class _Stages:
    """Host-clock seconds of each stage, added into ``stats`` (after a
    device sync, so that a stage's queued work counts to it); nothing is
    timed when ``stats`` is None."""

    def __init__(self, stats: Optional[Dict[str, float]], device):
        self.stats, self.device = stats, torch.device(device)
        self.t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        if self.stats is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stats[stage] = self.stats.get(stage, 0.0) + now - self.t
        self.t = now


def _fit(w, g, bits, method, seed, structured):
    if structured and bits == 4:
        return kmeans_mod.fit_structured_luts(w, g, seed=seed)
    return kmeans_mod.fit_module_luts(w, g, bits, method=method, seed=seed)


def fit_layer(
    weights: Dict[str, Any],
    gradients: Optional[Dict[str, Any]],
    bits: int,
    sensitivity: float = 0.0,
    outlier_thresholds: Optional[Dict[str, float]] = None,
    method: str = "auto",
    seed: int = 0,
    structured: bool = False,
    device="cuda",
    stats: Optional[Dict[str, float]] = None,
):
    """Steps 1-2 of one decoder layer on ``device``: the outliers pulled
    out, then each module's codebooks fitted on its zeroed weight (the
    ``nuq`` stage stores what this returns). Returns (zeroed weights,
    outlier matrices or None, {module_name: (lut, labels)}), tensors on
    ``device``; stats: see ``quantize_layer``."""
    clock = _Stages(stats, device)
    include_sparse = sensitivity > 0 or outlier_thresholds is not None
    w_dev = {n: to_device(w, device) for n, w in weights.items()}
    g_dev = (None if gradients is None
             else {n: to_device(gradients[n], device) for n in weights})
    clock("load")
    outlier_mats = None
    if include_sparse:
        outlier_mats = outliers_mod.remove_outliers(
            w_dev, sensitivity=sensitivity,
            outlier_config=outlier_thresholds, gradients=g_dev)
    clock("outliers")
    codebooks = {}
    for name, w in w_dev.items():
        g = None if g_dev is None else g_dev[name]
        codebooks[name] = _fit(w, g, bits, method, seed, structured)
        clock("kmeans")
    return w_dev, outlier_mats, codebooks


def quantize_layer(
    weights: Dict[str, Any],
    gradients: Optional[Dict[str, Any]],
    bits: int,
    sensitivity: float = 0.0,
    outlier_thresholds: Optional[Dict[str, float]] = None,
    biases: Optional[Dict[str, Any]] = None,
    method: str = "auto",
    nnz_pad_multiple: int = 512,
    seed: int = 0,
    structured: bool = False,
    device="cuda",
    stats: Optional[Dict[str, float]] = None,
) -> Dict[str, Tuple[Any, Dict[str, np.ndarray]]]:
    """Quantize one decoder layer's modules on ``device``: ``fit_layer``,
    then step 3.

    structured (bits=4 only; at 3 bits the codebooks are free, as in the
    JAX package): additive codebooks ``lut[c] = A[c&7] + (c>>3)*d``
    (``kmeans.fit_structured_luts``), which ``models.fuse`` detects and
    sends through K10. stats: an optional dict to which the seconds of
    each stage are added ('load': to the device, 'outliers', 'kmeans',
    'pack'). Returns {module_name: (QuantLinearSpec, numpy params)}."""
    w_dev, outlier_mats, codebooks = fit_layer(
        weights, gradients, bits, sensitivity=sensitivity,
        outlier_thresholds=outlier_thresholds, method=method, seed=seed,
        structured=structured, device=device, stats=stats)
    clock = _Stages(stats, device)
    out = {}
    for name, w in w_dev.items():
        lut, labels = codebooks[name]
        bias = None if biases is None or name not in biases else to_device(
            biases[name], device)
        out[name] = pack_linear(
            w, lut, labels=labels, bias=bias,
            outliers=None if outlier_mats is None else outlier_mats[name],
            bits=bits, nnz_pad_multiple=nnz_pad_multiple)
        clock("pack")
    return out


def quantize_model(
    model_type: str,
    config,
    dense_params,
    bits: int,
    gradients_per_layer=None,
    sensitivity: float = 0.0,
    outlier_config: Optional[list] = None,
    method: str = "auto",
    nnz_pad_multiple: int = 512,
    verbose: bool = False,
    quantize_lm_head: bool = False,
    structured: bool = False,
    device="cuda",
    stats: Optional[Dict[str, float]] = None,
):
    """Quantize a dense params tree into (specs, params).

    dense_params: the tree ``utils.hf.load_dense_model`` returns
    ({'embed', 'layers': [{module: {'w', 'b'?}, norms...}], 'final_norm',
    'lm_head': {'w'}}, tensors or numpy, any float type, on any device).
    Embeddings and norms stay dense (numpy f32); the lm_head stays dense
    unless ``quantize_lm_head`` (no sensitivity or outliers; structured at
    4 bits when ``structured``). gradients_per_layer: optional list of
    {module: (out, in) grad^2}; outlier_config: optional list of per-layer
    {module: threshold}. stats: as ``quantize_layer``'s, summed over the
    layers and the lm_head. Returns the port's LinearSpec tree and a tree
    of numpy arrays in the checkpoint format."""
    module_names = list(config.linear_shapes())
    spec_layers, param_layers = [], []
    n_layers = len(dense_params["layers"])
    for li, layer_p in enumerate(dense_params["layers"]):
        weights = {n: layer_p[n]["w"] for n in module_names}
        biases = {n: layer_p[n]["b"] for n in module_names
                  if isinstance(layer_p[n], dict) and "b" in layer_p[n]}
        q = quantize_layer(
            weights,
            None if gradients_per_layer is None else gradients_per_layer[li],
            bits, sensitivity=sensitivity,
            outlier_thresholds=(None if outlier_config is None
                                else outlier_config[li]),
            biases=biases or None, method=method,
            nnz_pad_multiple=nnz_pad_multiple, structured=structured,
            device=device, stats=stats)
        spec_d, param_d = {}, {}
        for k, v in layer_p.items():
            if k in module_names:
                continue
            param_d[k] = to_host(v)
        for name, (qspec, qparams) in q.items():
            spec_d[name] = LinearSpec(in_features=qspec.in_features,
                                      out_features=qspec.out_features,
                                      has_bias=qspec.has_bias, quant=qspec)
            param_d[name] = qparams
        spec_layers.append(spec_d)
        param_layers.append(param_d)
        if verbose:
            print(f"quantized layer {li + 1}/{n_layers}")

    params = {k: to_host(v) for k, v in dense_params.items()
              if k != "layers"}
    head_w = dense_params["lm_head"]["w"]
    lm_head_spec = LinearSpec(in_features=head_w.shape[1],
                              out_features=head_w.shape[0])
    if quantize_lm_head:
        clock = _Stages(stats, device)
        w = to_device(head_w, device)
        clock("load")
        lut, labels = _fit(w, None, bits, method, 0, structured)
        clock("kmeans")
        qspec, params["lm_head"] = pack_linear(w, lut, labels=labels,
                                               bits=bits)
        clock("pack")
        lm_head_spec = LinearSpec(in_features=qspec.in_features,
                                  out_features=qspec.out_features,
                                  quant=qspec)
        if verbose:
            print("quantized lm_head")
    specs = {"layers": tuple(spec_layers), "lm_head": lm_head_spec}
    params["layers"] = param_layers
    return specs, params

