"""The staged offline workflow, one restartable job a step: the port of the
JAX package's ``quantize/staged.py`` (the reference's four scripts,
quantization/README.md), with the same artifacts on disk, so a stage of
one package reads what the other's previous stage wrote:

  chunk           HF checkpoint -> chunks/layer_{i}.npz {module: W (out,
                  in) f32} and chunks.json (= chunk_models.py; also for
                  grad^2 checkpoints shaped like the model)
  outlier-config  chunks -> outlier_config.json, IQR thresholds
                  (= generate_outlier_config.py)
  nuq             chunks (+ grad^2 chunks) -> nuq/lut_{i}.npz
                  {name}.lut / {name}.labels, and nuq/outliers_{i}.npz
                  {name}.rows/.cols/.vals (COO, row-major) when outliers
                  are pulled out; per-output-channel weighted k-means on
                  ``device``; layers whose lut_{i}.npz exists are skipped
                  (= nuq.py)
  pack            HF checkpoint + nuq artifacts -> the shared quantized
                  checkpoint (= pack.py)

``pipeline.quantize_model`` does the same in memory. ``nuq`` and ``pack``
run its per-layer code (``pipeline.fit_layer``, ``pack_linear``), so the
two stages give the bits ``quantize_model`` gives for the same tree and
outlier config.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from squeezellm_tpu_torch.models.common import LinearSpec
from squeezellm_tpu_torch.quantize import outlier_config as oc_mod
from squeezellm_tpu_torch.quantize.pipeline import (fit_layer, to_device,
                                                    to_host)


def chunk_model(model_dir: str, out_dir: str, verbose: bool = False) -> int:
    """Split an HF checkpoint into per-layer npz chunks of its linears'
    f32 weights; existing chunks are kept. Returns the number of layers."""
    from squeezellm_tpu_torch.utils import hf

    model_type, config, params = hf.load_dense_model(model_dir)
    names = list(config.linear_shapes())
    os.makedirs(out_dir, exist_ok=True)
    for li, layer in enumerate(params["layers"]):
        path = os.path.join(out_dir, f"layer_{li}.npz")
        if os.path.exists(path):
            if verbose:
                print(f"skip existing {path}")
            continue
        np.savez(path, **{n: layer[n]["w"].numpy() for n in names})
        if verbose:
            print(f"wrote {path}")
    meta = {"model_type": model_type, "n_layers": config.n_layers,
            "model_dir": os.path.abspath(model_dir)}
    with open(os.path.join(out_dir, "chunks.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return config.n_layers


def _npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _n_layers(chunks_dir: str) -> int:
    with open(os.path.join(chunks_dir, "chunks.json")) as f:
        return json.load(f)["n_layers"]


def _chunk(chunks_dir: str, li: int) -> Dict[str, np.ndarray]:
    return _npz(os.path.join(chunks_dir, f"layer_{li}.npz"))


def make_outlier_config(chunks_dir: str, threshold_range: float,
                        out_json: str, verbose: bool = False) -> dict:
    """IQR thresholds of every chunk's modules, written to ``out_json``."""
    cfg = oc_mod.make_outlier_config(
        (_chunk(chunks_dir, li) for li in range(_n_layers(chunks_dir))),
        threshold_range,
        verbose=verbose)
    with open(out_json, "w") as f:
        json.dump(cfg, f, indent=2)
    return cfg


def nuq(chunks_dir: str, out_dir: str, bits: int,
        gradient_chunks_dir: Optional[str] = None, sensitivity: float = 0.0,
        outlier_config_json: Optional[str] = None, method: str = "auto",
        seed: int = 0, device="cuda", verbose: bool = False,
        stats: Optional[Dict[str, float]] = None) -> int:
    """Per-layer codebooks (and outliers), resumable: a layer whose
    lut_{i}.npz exists is skipped. stats: as ``pipeline.fit_layer``'s,
    summed over the layers fitted. Returns the number of layers fitted."""
    os.makedirs(out_dir, exist_ok=True)
    thresholds = None
    if outlier_config_json:
        with open(outlier_config_json) as f:
            thresholds = json.load(f)["outlier_config"]
    fitted = 0
    for li in range(_n_layers(chunks_dir)):
        lut_path = os.path.join(out_dir, f"lut_{li}.npz")
        if os.path.exists(lut_path):
            if verbose:
                print(f"skip layer {li} (exists)")
            continue
        grads = (None if not gradient_chunks_dir
                 else _chunk(gradient_chunks_dir, li))
        _, outlier_mats, codebooks = fit_layer(
            _chunk(chunks_dir, li), grads, bits, sensitivity=sensitivity,
            outlier_thresholds=None if thresholds is None else thresholds[li],
            method=method, seed=seed, device=device, stats=stats)
        arrays = {}
        for name, (lut, labels) in codebooks.items():
            arrays[f"{name}.lut"] = lut.cpu().numpy()
            arrays[f"{name}.labels"] = labels.cpu().numpy()
        if outlier_mats is not None:
            coo = {}
            for name, m in outlier_mats.items():
                idx = torch.nonzero(m)  # row-major, as np.nonzero
                coo[f"{name}.rows"] = idx[:, 0].to(torch.int32).cpu().numpy()
                coo[f"{name}.cols"] = idx[:, 1].to(torch.int32).cpu().numpy()
                coo[f"{name}.vals"] = m[idx[:, 0], idx[:, 1]].float().cpu(
                ).numpy()
            np.savez(os.path.join(out_dir, f"outliers_{li}.npz"), **coo)
        # the codebooks last: their file marks the layer done
        np.savez(lut_path, **arrays)
        fitted += 1
        if verbose:
            print(f"layer {li} done")
    return fitted


def pack(model_dir: str, nuq_dir: str, bits: int, output: str,
         nnz_pad_multiple: int = 512, device="cuda",
         verbose: bool = False) -> None:
    """Collate the nuq artifacts with the HF checkpoint's weights into the
    shared quantized checkpoint: each linear's outlier slots zeroed, its
    codes the stored labels, packed on ``device``. No SpMV slot plans are
    written (the JAX package's ``build_spmv=False``)."""
    from squeezellm_tpu_torch import checkpoint
    from squeezellm_tpu_torch.ops.quant_linear import pack_linear
    from squeezellm_tpu_torch.utils import hf

    model_type, config, params = hf.load_dense_model(model_dir)
    names = list(config.linear_shapes())
    spec_layers, param_layers = [], []
    for li, layer in enumerate(params["layers"]):
        luts = _npz(os.path.join(nuq_dir, f"lut_{li}.npz"))
        opath = os.path.join(nuq_dir, f"outliers_{li}.npz")
        coo = _npz(opath) if os.path.exists(opath) else {}
        spec_d = {}
        param_d = {k: to_host(v) for k, v in layer.items()
                   if k not in names}
        for name in names:
            w = to_device(layer[name]["w"], device).clone()
            outliers = None
            if f"{name}.rows" in coo:
                r, c = (torch.from_numpy(coo[f"{name}.{k}"]).long().to(device)
                        for k in ("rows", "cols"))
                outliers = torch.zeros_like(w)
                outliers[r, c] = to_device(coo[f"{name}.vals"], device)
                w[r, c] = 0.0  # the dense weight is zeroed at outlier slots
            bias = layer[name].get("b")
            qspec, param_d[name] = pack_linear(
                w, to_device(luts[f"{name}.lut"], device),
                labels=torch.from_numpy(luts[f"{name}.labels"]).to(device),
                bias=None if bias is None else to_device(bias, device),
                outliers=outliers, bits=bits,
                nnz_pad_multiple=nnz_pad_multiple)
            spec_d[name] = LinearSpec(in_features=qspec.in_features,
                                      out_features=qspec.out_features,
                                      has_bias=qspec.has_bias, quant=qspec)
        spec_layers.append(spec_d)
        param_layers.append(param_d)
        if verbose:
            print(f"packed layer {li + 1}/{config.n_layers}")
    out_params = {k: to_host(v) for k, v in params.items()
                  if k != "layers"}
    out_params["layers"] = param_layers
    head = params["lm_head"]["w"]
    specs = {"layers": tuple(spec_layers),
             "lm_head": LinearSpec(in_features=head.shape[1],
                                   out_features=head.shape[0])}
    checkpoint.save_quantized(output, model_type, config, specs, out_params)
