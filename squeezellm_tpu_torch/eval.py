"""Perplexity evaluator, GPTQ protocol.

The counterpart of the JAX package's ``eval.py``: non-overlapping seqlen
strides over the eval corpus, shifted cross-entropy per stride, ppl =
exp(sum(nll) / (nsamples * seqlen)). Each group of strides is one full
forward; at 1024 rows and more every quantized linear of it goes through
K4 (``ops/dequant_dense``) and one dense matmul, the attention through K3.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def stride_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean token NLL of shifted next-token prediction, per stride.

    logits: (B, S, V); tokens: (B, S) ints. Returns (B,) f32: each
    stride's mean over its own S-1 shifted positions, the log-softmax in
    f32."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean(dim=-1)


@torch.no_grad()
def perplexity(model, eval_tokens, seqlen: int = 2048,
               nsamples: Optional[int] = None, group: int = 8, *,
               dtype=torch.float32, mode: str = "exact",
               plain: bool = False, verbose: bool = False) -> float:
    """eval_tokens: (1, N) ints. Returns the perplexity (float).

    group: strides per forward (the batch dim). Strides are causally
    independent, so batching changes no number; the last group is padded
    with a repeated stride and trimmed. Each stride's mean NLL times
    seqlen is summed (the reference's accumulation), and the NLLs stay on
    the device until the end of their group. plain: run each kernel's
    plain PyTorch version whatever the device (the reference)."""
    flat = np.asarray(eval_tokens).reshape(-1)
    total = flat.shape[0] // seqlen
    n = total if nsamples is None else min(nsamples, total)
    if n == 0:
        raise ValueError(f"eval corpus too short: {flat.shape[0]} tokens < "
                         f"seqlen {seqlen}")
    g = max(1, min(group, n))
    nlls = []
    for i0 in range(0, n, g):
        # pad the last group with a repeat of the last stride
        rows = [flat[j * seqlen: (j + 1) * seqlen]
                for j in (min(i, n - 1) for i in range(i0, i0 + g))]
        tok = torch.as_tensor(np.stack(rows).astype(np.int64),
                              device=model.device)
        logits = model.forward(tok, dtype=dtype, mode=mode, plain=plain)
        nll = (stride_nll(logits, tok) * seqlen).cpu().numpy()
        del logits
        nlls.extend(float(v) for v in nll[: n - i0])
        if verbose:
            running = float(np.exp(np.sum(nlls) / (len(nlls) * seqlen)))
            print(f"sample {len(nlls)}/{n}  running ppl {running:.4f}")
    return float(np.exp(np.sum(nlls) / (n * seqlen)))
