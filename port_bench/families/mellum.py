"""Mellum2-12B-A2.5B: the LLaMA family's attention (GQA with its own
``head_dim``, sliding and full layers, each layer type with its own rope)
and a mixture of 64 Dense-and-Sparse experts, 8 a token, in every layer.

The port's model is ``models/llama.py`` with ``models/moe.py``'s
sparse-expert blocks, built here from ``pbench/experts.py``'s raw weights
by the port's own packing (``pbench/port._linear``), stacking
(``models.moe.Experts``) and fusion (``models.fuse.fuse_for_decode``:
q|k|v, and gate|up expert by expert); the plain reference is
``reference/mellum.py``; the work is :class:`Work`.
"""

import torch

from pbench import experts, port, weights
from pbench.work import attended_sum, bound_s
from reference import mellum as ref

logits = ref.logits


@torch.no_grad()
def build_model(cfg: dict, seed: int, device):
    """The port's model of configuration ``cfg`` with the seed's weights,
    fused for decode, its MoE counters attached."""
    from squeezellm_tpu_torch.models import fuse, llama, moe, registry
    from squeezellm_tpu_torch.models.common import Linear, LinearSpec

    pconf = registry.config_class(cfg["model_type"]).from_hf_config(cfg)
    bits = weights.quant(cfg)["bits"]
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        lins = {n: port._linear(r, bits)
                for n, r in experts.attn(cfg, seed, i, device).items()}
        per = [{n: port._linear(r, bits) for n, r in
                experts.expert(cfg, seed, i, e, device).items()}
               for e in range(cfg["num_experts"])]
        stacked = {n: moe.Experts.stack([p[n] for p in per])
                   for n in ("gate", "up", "down")}
        del per
        rest = experts.rest(cfg, seed, i, device)
        layers.append(llama.DecoderLayer(
            pconf, lins, rest["input_norm"], rest["post_norm"],
            mlp=moe.MoEBlock(pconf, rest["router"], stacked),
            layer_type=pconf.layer_type(i)))
    g = weights.globals_(cfg, seed, device)
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    head = Linear(LinearSpec(in_features=h, out_features=v),
                  {"w": g["lm_head"]})
    model = llama.Llama(pconf, g["embed"], layers, g["final_norm"], head)
    return fuse.fuse_for_decode(moe.attach_counters(model))


def _packed(shapes, q) -> float:
    """Bytes of the packed linears of ``shapes`` (``pbench/work.py``'s
    count: codes, LUTs, sidecar with its row pointers, top-X rows)."""
    bits, topx = q["bits"], q["topx"]
    total = 0.0
    for o, i in shapes.values():
        nnz = weights.sidecar_count(o, i, q["sparsity"])
        total += (o * i * bits / 8 + o * 2**bits * 4 + nnz * 8
                  + (o + 1) * 4 + i * topx * 4 + topx * 4)
    return total


class Work:
    """``pbench/work.py``'s counts for the sparse-expert layers: attention
    over the keys each layer type attends (sliding layers at most the
    window), the router's dense product, and the experts: in a step of
    ``rows`` tokens E (1 - (1 - k / E)^rows) distinct experts a layer in
    expectation (routing taken as uniform) times one expert's packed
    bytes, and the FLOPs of the k experts of every row only.
    ``moe_decode`` and ``moe_prefill`` count the experts alone (the K13
    rooflines), ``experts_read`` the expected experts a decode step reads
    over the layers (``eng.stats["moe_experts_read"]``'s yardstick)."""

    def __init__(self, cfg: dict):
        q = weights.quant(cfg)
        self.layers = cfg["num_hidden_layers"]
        self.hidden = h = cfg["hidden_size"]
        self.vocab = cfg["vocab_size"]
        self.heads = cfg["num_attention_heads"]
        self.head_dim = weights.head_dim(cfg)
        self.window = cfg["sliding_window"]
        types = cfg["layer_types"]
        self.sliding = sum(t == "sliding_attention" for t in types)
        self.full = len(types) - self.sliding
        self.n_experts = cfg["num_experts"]
        self.top_k = cfg["num_experts_per_tok"]
        attn = experts.attn_shapes(cfg)
        ex = experts.expert_shapes(cfg)
        self.attn_macs = (sum(o * i for o, i in attn.values())
                          + self.n_experts * h)
        self.expert_macs = sum(o * i for o, i in ex.values())
        self.expert_bytes = _packed(ex, q)
        # every step reads these whole: attention, router, norms, head
        self.fixed_bytes = (self.layers * (_packed(attn, q)
                                           + self.n_experts * h * 4
                                           + 2 * h * 4)
                            + self.vocab * h * 2)
        # all of them, every expert's included
        self.weight_bytes = (self.fixed_bytes + self.layers * self.n_experts
                             * self.expert_bytes)
        self.kv_row = 2 * weights.kv_heads(cfg) * self.head_dim * 2
        self.embed_row = h * 2

    def _experts(self, rows: int) -> float:
        """Expected distinct experts of one layer that ``rows`` tokens
        choose."""
        e, k = self.n_experts, self.top_k
        return e * (1 - (1 - k / e) ** rows)

    def experts_read(self, rows: int) -> float:
        """Expected experts one decode step of ``rows`` tokens reads, over
        the layers."""
        return self.layers * self._experts(rows)

    def moe_decode(self, rows: int):
        """(bytes, flops) of the experts in one step of ``rows`` tokens."""
        return (self.experts_read(rows) * self.expert_bytes,
                2 * rows * self.top_k * self.expert_macs * self.layers)

    def moe_prefill(self, n: int):
        """(bytes, flops) of the experts in a prompt of n tokens."""
        return self.moe_decode(n)

    def _attention(self, keys_sliding: int, keys_full: int) -> float:
        return 4 * self.heads * self.head_dim * (
            self.sliding * keys_sliding + self.full * keys_full)

    def decode_step(self, contexts):
        """(bytes, flops) of one decode step of the active slots."""
        ctx = list(contexts)
        a = len(ctx)
        ks = sum(min(c, self.window) for c in ctx)
        kf = sum(ctx)
        mb, mf = self.moe_decode(a)
        flops = (2 * a * (self.layers * self.attn_macs
                          + self.vocab * self.hidden)
                 + mf + self._attention(ks, kf))
        nbytes = (self.fixed_bytes + mb + a * self.embed_row
                  + self.kv_row * (self.sliding * ks + self.full * kf
                                   + self.layers * a)
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
        mb, mf = self.moe_prefill(n)
        flops = (2 * n * self.layers * self.attn_macs + mf
                 + 2 * self.vocab * self.hidden
                 + self._attention(attended_sum(n, self.window),
                                   attended_sum(n, None)))
        nbytes = (self.fixed_bytes + mb + n * self.embed_row
                  + self.layers * self.kv_row * n + self.vocab * 4)
        return nbytes, flops
