"""Outlier extraction, sensitivity-based and threshold-based, in PyTorch on
the weights' device.

The port of the JAX package's ``quantize/outliers.py`` (the reference's
``squeezellm/outliers.py:4-111``):

  * sensitivity: per module, the top ``s``% of weights ranked by grad^2 move
    to the sparse sidecar: the threshold is the ``num``-th largest
    gradient (``num = int(size * s / 100)``) and weights strictly above it
    are taken;
  * threshold: weights with ``|w| >= thres`` move out;
  * both passes stack (sensitivity first); the dense weights are zeroed at
    every extracted slot.

Operates on {module_name: (out, in) tensor} dicts; returns the outlier
matrices and replaces the dict's weights with their zeroed dense parts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def remove_outliers_by_sensitivity(weights: Dict[str, torch.Tensor],
                                   gradients: Dict[str, torch.Tensor],
                                   sensitivity: float,
                                   verbose: bool = False):
    """Extract the top ``sensitivity``% weights by grad^2 per module."""
    outliers = {}
    tot_out = tot_all = 0
    for name in list(weights):
        w = weights[name].float()
        g = gradients[name].to(w.device, torch.float32)
        num = int(g.numel() * sensitivity / 100)
        if num <= 0:
            outliers[name] = torch.zeros_like(w)
            continue
        # the num-th largest gradient; extract strictly above it
        thres = torch.topk(g.reshape(-1), num, sorted=False).values.min()
        t = g > thres
        outliers[name] = torch.where(t, w, 0.0)
        weights[name] = torch.where(t, 0.0, w)
        tot_out += int(t.sum())
        tot_all += t.numel()
    if verbose and tot_all:
        print(f"p outlier (sensitivity): {tot_out / tot_all * 100:.4f}%")
    return outliers


def remove_outliers_by_threshold(weights: Dict[str, torch.Tensor],
                                 outlier_config: Dict[str, float],
                                 outliers: Optional[Dict[str, torch.Tensor]]
                                 = None, verbose: bool = False):
    """Extract weights with ``|w| >= thres`` (per-module thresholds); adds
    into ``outliers`` when given (stacked after the sensitivity pass)."""
    if outliers is None:
        outliers = {n: torch.zeros_like(w.float()) for n, w in weights.items()}
    tot_out = tot_all = 0
    for name in list(weights):
        thres = float(outlier_config[name])
        w = weights[name].float()
        t = w.abs() >= thres
        outliers[name] = outliers[name] + torch.where(t, w, 0.0)
        weights[name] = torch.where(t, 0.0, w)
        tot_out += int(t.sum())
        tot_all += t.numel()
    if verbose and tot_all:
        print(f"p outlier (threshold): {tot_out / tot_all * 100:.4f}%")
    return outliers


def remove_outliers(weights: Dict[str, torch.Tensor],
                    sensitivity: float = 0.0,
                    outlier_config: Optional[Dict[str, float]] = None,
                    gradients: Optional[Dict[str, torch.Tensor]] = None,
                    verbose: bool = False):
    """The sensitivity pass (when ``sensitivity`` is not 0), then the
    threshold pass (when ``outlier_config`` is given), as the reference's
    ``remove_outliers`` (outliers.py:78-111)."""
    if outlier_config is None and sensitivity == 0:
        raise ValueError("remove_outliers needs a sensitivity or an "
                         "outlier config")
    outliers = None
    if sensitivity != 0:
        if gradients is None:
            raise ValueError("the sensitivity pass needs gradients")
        outliers = remove_outliers_by_sensitivity(weights, gradients,
                                                  sensitivity, verbose)
    if outlier_config is not None:
        outliers = remove_outliers_by_threshold(weights, outlier_config,
                                                outliers, verbose)
    return outliers
