"""The work a step or an admission needs, counted from the configuration
and the tokens, and the least time the card could take for it.

The counts say nothing of which kernel does the work, so a roofline share
reads the same work whatever a later change runs. Bytes count each input
read once and each output written once: the packed weights (codes, LUTs,
sidecar with its row pointers, top-X rows, biases), the dense head, the
embedding rows, the KV rows read and written, the logits. Operations are
2 x the multiply-adds of every linear on every row that needs it (the head
on the rows whose logits are used) and of attention over the rows each
query actually attends (capped by the sliding window).

The peaks are NVIDIA's data sheet for one H100 SXM (dense, at 700 W):
3.35 TB/s of HBM and 989 TFLOP/s in bf16; the bound is the larger of
bytes over the one and operations over the other (``chip_smoke.bound_ms``'s
arithmetic at the bf16 rate, the configurations' activation type).
"""

from __future__ import annotations

from typing import Iterable

from pbench import weights

HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_S, flops / BF16_FLOP_S)


def attended_sum(n: int, window) -> int:
    """sum over positions i = 1..n of min(i, window): the keys a causal
    prefill of n tokens attends."""
    if window is None or n <= window:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


class Work:
    def __init__(self, cfg: dict):
        q = weights.quant(cfg)
        bits, topx = q["bits"], q["topx"]
        self.layers = cfg["num_hidden_layers"]
        self.hidden = h = cfg["hidden_size"]
        self.vocab = cfg["vocab_size"]
        self.heads = cfg["num_attention_heads"]
        self.head_dim = weights.head_dim(cfg)
        self.window = cfg.get("sliding_window")
        self.opt = weights.is_opt(cfg)
        shapes = weights.linear_shapes(cfg).values()
        self.layer_macs = sum(o * i for o, i in shapes)
        packed = 0
        for o, i in shapes:
            nnz = weights.sidecar_count(o, i, q["sparsity"])
            packed += (o * i * bits / 8 + o * 2**bits * 4
                       + nnz * 8 + (o + 1) * 4 + i * topx * 4 + topx * 4
                       + (o * 4 if self.opt else 0))
        norms = (4 if self.opt else 2) * h * 4
        self.weight_bytes = self.layers * (packed + norms) + self.vocab * h * 2
        # k and v rows of one token in one layer, bf16
        self.kv_row = 2 * weights.kv_heads(cfg) * self.head_dim * 2
        self.embed_row = h * 2 * (2 if self.opt else 1)

    def _attended(self, ctx: int) -> int:
        return ctx if self.window is None else min(ctx, self.window)

    def decode_step(self, contexts: Iterable[int]):
        """(bytes, flops) of one decode step of the active slots, slot s
        attending ``contexts[s]`` keys (its new row included)."""
        ctx = [self._attended(c) for c in contexts]
        a, keys = len(ctx), sum(ctx)
        flops = (2 * a * (self.layers * self.layer_macs
                          + self.vocab * self.hidden)
                 + 4 * self.heads * self.head_dim * self.layers * keys)
        nbytes = (self.weight_bytes + a * self.embed_row
                  + self.layers * self.kv_row * (keys + a)
                  + a * self.vocab * 4)
        return nbytes, flops

    def window_steps(self, contexts, k: int):
        """(bytes, flops, bound seconds) of k decode steps from
        ``contexts``, each step one key more a slot."""
        nb = fl = bound = 0.0
        for j in range(k):
            b, f = self.decode_step([c + j for c in contexts])
            nb, fl, bound = nb + b, fl + f, bound + bound_s(b, f)
        return nb, fl, bound

    def prefill(self, n: int):
        """(bytes, flops) of one prompt of n tokens (no cached prefix):
        every row through the layers, the last row through the head."""
        keys = attended_sum(n, self.window)
        flops = (2 * n * self.layers * self.layer_macs
                 + 2 * self.vocab * self.hidden
                 + 4 * self.heads * self.head_dim * self.layers * keys)
        nbytes = (self.weight_bytes + n * self.embed_row
                  + self.layers * self.kv_row * n + self.vocab * 4)
        return nbytes, flops
