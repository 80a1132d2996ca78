"""IQR-rule outlier thresholds: the port's own numpy copy of the JAX
package's ``quantize/outlier_config.py`` (the reference's
``generate_outlier_config.py:37-78``).

Per layer and module, ``threshold = max(|q1 - r*IQR|, |q3 + r*IQR|)``; the
result is ``{outlier_threshold: measured global %, outlier_config:
[per-layer {module: thres}]}``. numpy's quantile (linear interpolation) on
the host, as the JAX package takes it, so the thresholds are the same
floats; ``outliers.remove_outliers_by_threshold`` then applies them on the
device.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def module_threshold(weight, threshold_range: float) -> float:
    w = _host(weight)
    q1 = np.quantile(w, 0.25)
    q3 = np.quantile(w, 0.75)
    lo = q1 - threshold_range * (q3 - q1)
    hi = q3 + threshold_range * (q3 - q1)
    return float(max(abs(lo), abs(hi)))


def make_outlier_config(layers: Iterable[Dict[str, object]],
                        threshold_range: float,
                        verbose: bool = False) -> dict:
    """layers: iterable of {module_name: (out, in) weight} dicts (numpy
    arrays or tensors)."""
    total_params = 0
    total_outliers = 0
    per_layer: List[Dict[str, float]] = []
    for li, layer in enumerate(layers):
        layer_json = {}
        for name, w in layer.items():
            w = _host(w)
            thres = module_threshold(w, threshold_range)
            n_out = int((np.abs(w) > thres).sum())
            total_params += w.size
            total_outliers += n_out
            if verbose:
                print(f"{li} {name} % outlier: {n_out / w.size * 100:.3f}%")
            layer_json[name] = thres
        per_layer.append(layer_json)
    pct = round(total_outliers / max(total_params, 1) * 100, 2)
    return {"outlier_threshold": pct, "outlier_config": per_layer}
