"""Fisher information (grad^2) for sensitivity-weighted k-means, by torch
autograd on the card.

The port of the JAX package's ``quantize/gradients.py``: backpropagate the
causal-LM loss through the dense model over calibration samples and sum
the squared gradients of every layer linear's weight, the diagonal
empirical Fisher that ``quantize_model`` takes as the k-means sample
weight (reference nuq.py:163-176) and as the sensitivity ranking.

The model runs its plain path (``plain=True``: the JAX package
differentiates ``backend="xla"``, so no kernel needs a backward), in f32.
``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``). Each weight's gradient is squared into its
accumulator as soon as autograd has it and then freed, so the card holds
the weights, the accumulators and one layer's gradients at a time: a 7B
model in f32 takes about 2 x 27 GB.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

import numpy as np
import torch

from squeezellm_tpu_torch import carry
from squeezellm_tpu_torch.models.common import Linear


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device, dtype) for v in tree]
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.array(tree))
    return t.detach().to(device=device, dtype=dtype)


def layer_linears(layer, names) -> Dict[str, Linear]:
    """A decoder layer's linears by module name (q..down)."""
    return {path.rsplit(".", 1)[-1]: m for path, m in layer.named_modules()
            if isinstance(m, Linear) and path.rsplit(".", 1)[-1] in names}


def compute_fisher(model_type: str, config, dense_params, calib_tokens,
                   batch_size: int = 1, remat: bool = True,
                   dtype=torch.float32, verbose: bool = False,
                   device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Sum grad^2 of the causal-LM loss over calibration samples.

    dense_params: the dense tree (``utils.hf.load_dense_model``);
    calib_tokens: (nsamples, seqlen) ints (``data.get_loaders``' seeded
    windows). Returns one {module_name: (out, in) f32 grad^2} dict per
    layer, tensors on ``device``: the ``gradients_per_layer`` input of
    ``pipeline.quantize_model``."""
    names = list(config.linear_shapes())
    # each tensor to the device in dtype on its own, so the card never holds
    # two copies of the weights
    model = carry.from_tree(model_type, dataclasses.asdict(config),
                            carry.dense_module_meta(model_type, config),
                            _tree_to(dense_params, device, dtype), device)
    accs = []
    for layer in model.layers:
        acc = {}
        for name, lin in layer_linears(layer, names).items():
            # a leaf of its own: the caller's tensor (which from_tree may
            # share on the same device) keeps requires_grad off
            w = lin.w.detach().requires_grad_(True)
            lin.add_tensors(w=w)
            acc[name] = torch.zeros(w.shape, dtype=torch.float32,
                                    device=w.device)

            def square_into(p, a=acc[name]):
                a.add_(p.grad.float() ** 2)
                p.grad = None

            w.register_post_accumulate_grad_hook(square_into)
        accs.append(acc)
    tokens = torch.as_tensor(np.asarray(calib_tokens), dtype=torch.long)
    n = tokens.shape[0]
    for i in range(0, n, batch_size):
        batch = tokens[i: i + batch_size].to(device)
        logits = model.forward(batch, dtype=dtype, plain=True, remat=remat)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        ll = logp.gather(-1, batch[:, 1:, None])[..., 0]
        loss = -ll.mean()
        del logits, logp, ll
        loss.backward()
        if verbose:
            print(f"fisher: sample {min(i + batch_size, n)}/{n}")
    return accs


def save_gradient_chunks(grads: List[Dict[str, torch.Tensor]], out_dir: str,
                         model_type: str, model_dir: str = "") -> None:
    """Write grad^2 as per-layer chunk files (``layer_{i}.npz`` and
    ``chunks.json``), the JAX package's format: ``quantize --gradient``
    of either package reads them."""
    os.makedirs(out_dir, exist_ok=True)
    for li, g in enumerate(grads):
        np.savez(os.path.join(out_dir, f"layer_{li}.npz"),
                 **{n: t.detach().cpu().numpy() for n, t in g.items()})
    with open(os.path.join(out_dir, "chunks.json"), "w") as f:
        json.dump({"model_type": model_type, "n_layers": len(grads),
                   "model_dir": model_dir}, f, indent=2)
