"""Sparse-expert decoder (Mellum 2) in PyTorch: the LLaMA family's layers
with a mixture of Dense-and-Sparse quantized experts in place of the MLP.

The JAX package has no sparse experts; this module follows the published
architecture (HF ``config.json`` of ``JetBrains/Mellum2-12B-A2.5B``):
GQA attention with its own ``head_dim``, sliding and full layers each with
their own rope (``LlamaConfig.layer_types`` / ``ropes``, ``models/llama``),
RMSNorm, and in every layer

    p = softmax(h @ R^T)   (R: experts x hidden, f32)
    w = p[top k] / sum(p[top k])           (norm_topk_prob)
    x += sum_{i in top k} w_i * down_i(silu(gate_i(h)) * up_i(h)),  h = rms(x)

Routing (:func:`route`) runs on the device with no host sync: router
logits in f32 (an f64 product rounded, so a row's logits do not depend on
the rows beside it) from the hidden state in the activations' type, a
stable sort (ties to the lower expert), the (token, expert) pairs sorted
by expert and by token within one, the experts' offsets and K13's tile map
written on the device. Each expert linear is Dense-and-Sparse quantized
like a dense layer's (``ops/quant_linear``), the experts of one linear
stacked (:class:`Experts`), gate|up fused per expert by
``models.fuse.fuse_for_decode``. One K13 launch (``ops/moe_lut``) serves a
layer's gate|up and one its down; the combine sums each token's k outputs
in f32 in a fixed order and adds the residual last (``moe_lut.moe_combine``).
``plain=True`` runs the plain versions (K13's loops over the experts).

Spans: ``moe.route``, ``linear.moe_dec`` / ``linear.moe_mma`` (the K13
body the call runs on the card), ``act``, ``moe.combine``. Counters: a
decode step adds its pairs and the experts at least one of them chose,
over the layers, to ``model.moe_stats`` (``attach_counters``), on the
device; the serving engines read them at a window's one sync
(``eng.stats["moe_pairs"]``, ``["moe_experts_read"]``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from squeezellm_tpu_torch.models import llama
from squeezellm_tpu_torch.models.common import Linear, LinearSpec
from squeezellm_tpu_torch.ops import moe_lut
from squeezellm_tpu_torch.ops.quant_linear import QuantLinearSpec
from squeezellm_tpu_torch.tracing import span


@dataclasses.dataclass(frozen=True)
class MoEConfig(llama.LlamaConfig):
    """``LlamaConfig`` with every layer's MLP made of ``n_experts``
    experts of width ``expert_size``, ``top_k`` a token, their weights
    renormalised over the top k when ``norm_topk``."""

    n_experts: int = 64
    top_k: int = 8
    expert_size: int = 896
    norm_topk: bool = True

    def linear_shapes(self) -> Dict[str, tuple]:
        """(out, in) of each quantizable linear outside the experts."""
        shapes = super().linear_shapes()
        return {n: shapes[n] for n in ("q", "k", "v", "o")}

    def expert_shapes(self) -> Dict[str, tuple]:
        """(out, in) of each linear of one expert."""
        h, f = self.hidden_size, self.expert_size
        return {"gate": (f, h), "up": (f, h), "down": (h, f)}

    @staticmethod
    def from_hf_config(d: dict) -> "MoEConfig":
        """From an HF config.json dict (mellum): every layer sparse."""
        kinds = d.get("mlp_layer_types") or []
        if any(k != "sparse" for k in kinds):
            raise ValueError("dense MLP layers beside sparse ones are not "
                             "supported")
        return MoEConfig(**llama.LlamaConfig.hf_fields(d),
                         n_experts=d["num_experts"],
                         top_k=d["num_experts_per_tok"],
                         expert_size=d["moe_intermediate_size"],
                         norm_topk=d.get("norm_topk_prob", True))


@dataclasses.dataclass
class Route:
    """One layer's routing of T tokens, k experts each (P = T k pairs):
    ``tok`` (P,) the token of each pair, the pairs sorted by expert and by
    token within one; ``offsets`` (E + 1,) int32, expert e's pairs at
    ``[offsets[e], offsets[e + 1])``; ``inv`` (T, k) where token t's j-th
    choice lies among the pairs; ``weights`` (T, k) f32; ``tiles`` K13's
    tile map (``moe_lut.tile_map``) of ``row_tile`` rows a tile, or None
    (the plain versions take none)."""

    tok: torch.Tensor
    offsets: torch.Tensor
    inv: torch.Tensor
    weights: torch.Tensor
    k: int
    tiles: Optional[torch.Tensor] = None
    row_tile: int = 0


def route(h: torch.Tensor, router: torch.Tensor, k: int, norm: bool,
          tile: Optional[int] = None) -> Route:
    """Route the rows of h (T, hidden) to k of the router's (E, hidden)
    experts, on h's device with no host sync (no ``.item()``, no
    ``nonzero``, no boolean indexing). tile: K13's rows a tile, for its
    tile map; None: no map."""
    T, n_exp = h.shape[0], router.shape[0]
    dev = h.device
    logits = torch.matmul(h.double(), router.double().t()).float()
    p = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    w, e = top[:, :k], idx[:, :k]
    if norm:  # the sum in a fixed order
        s = w[:, :1]
        for j in range(1, k):
            s = s + w[:, j:j + 1]
        w = w / s
    key = (e * T + torch.arange(T, device=dev)[:, None]).reshape(-1)
    order = torch.argsort(key)
    pairs = order.numel()
    offsets = torch.searchsorted(
        e.reshape(-1)[order],
        torch.arange(n_exp + 1, device=dev)).to(torch.int32)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(pairs, device=dev)).view(T, k)
    r = Route(tok=order // k, offsets=offsets, inv=inv,
              weights=w.contiguous(), k=k)
    if tile is not None:
        r.tiles = moe_lut.tile_map(
            offsets, moe_lut.n_tiles(n_exp, T, pairs, tile), tile)
        r.row_tile = tile
    return r


class Experts(nn.Module):
    """The E quantized linears of one kind in a layer's experts, stacked:
    ``qweight`` (E, n_words, out), ``lut`` (E, out, 2**bits), the
    sidecars' ``sp_rowptr`` (E, out + 1) into the concatenated
    ``sp_cols`` / ``sp_vals``, ``topx_weights`` (E, X, in) (each expert's
    (in, X) rows transposed) and ``topx_indices`` (E, X). ``spec`` is one
    expert's (its ``nnz`` the experts' sum)."""

    def __init__(self, spec: QuantLinearSpec, n_experts: int,
                 tensors: Dict[str, torch.Tensor]):
        super().__init__()
        self.spec = spec
        self.n_experts = n_experts
        self._names = tuple(tensors)
        for name, t in tensors.items():
            self.register_buffer(name, t)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self._names}

    @staticmethod
    def stack(linears: List[Linear]) -> "Experts":
        """Stack quantized linears of one shape, bits and top-X count."""
        specs = [m.spec.quant for m in linears]
        ts = [m.tensors() for m in linears]
        s0 = specs[0]
        if any((s.bits, s.in_features, s.out_features, s.topx, s.has_bias)
               != (s0.bits, s0.in_features, s0.out_features, s0.topx, False)
               for s in specs):
            raise ValueError("experts must share bits, shape and top-X "
                             "count, and have no bias")
        new = {"qweight": torch.stack([t["qweight"] for t in ts]),
               "lut": torch.stack([t["lut"] for t in ts])}
        nnz = sum(s.nnz for s in specs)
        if nnz:
            base, ptrs = 0, []
            for s, t in zip(specs, ts):
                if s.include_sparse:
                    ptrs.append(t["sp_rowptr"] + base)
                    base += s.nnz
                else:
                    ptrs.append(torch.full(
                        (s.out_features + 1,), base, dtype=torch.int32,
                        device=t["qweight"].device))
            new["sp_rowptr"] = torch.stack(ptrs).to(torch.int32)
            new["sp_cols"] = torch.cat([t["sp_cols"] for s, t in
                                        zip(specs, ts) if s.include_sparse])
            new["sp_vals"] = torch.cat([t["sp_vals"] for s, t in
                                        zip(specs, ts) if s.include_sparse])
        if s0.topx:
            new["topx_weights"] = torch.stack(
                [t["topx_weights"].t() for t in ts]).contiguous()
            new["topx_indices"] = torch.stack(
                [t["topx_indices"] for t in ts]).to(torch.int32)
        spec = QuantLinearSpec(bits=s0.bits, in_features=s0.in_features,
                               out_features=s0.out_features, nnz=nnz,
                               topx=s0.topx)
        return Experts(spec, len(linears), new)

    def expert(self, e: int) -> Linear:
        """Expert e's linear, as ``Linear`` takes it (views where it can)."""
        t, s = self.tensors(), self.spec
        new = {"qweight": t["qweight"][e], "lut": t["lut"][e]}
        nnz = 0
        if "sp_rowptr" in t:
            rp = t["sp_rowptr"][e]
            lo, hi = int(rp[0]), int(rp[-1])
            nnz = hi - lo
            if nnz:
                new.update(sp_rowptr=(rp - lo).contiguous(),
                           sp_cols=t["sp_cols"][lo:hi],
                           sp_vals=t["sp_vals"][lo:hi])
        if s.topx:
            new.update(topx_weights=t["topx_weights"][e].t().contiguous(),
                       topx_indices=t["topx_indices"][e])
        q = QuantLinearSpec(bits=s.bits, in_features=s.in_features,
                            out_features=s.out_features, nnz=nnz,
                            topx=s.topx)
        return Linear(LinearSpec(in_features=s.in_features,
                                 out_features=s.out_features, quant=q), new)

    def forward(self, x: torch.Tensor, r: Route, *, mode: str = "exact",
                plain: bool = False, decode: bool = False) -> torch.Tensor:
        """(P, out) f32 of the pairs' rows x (P, in), each through its
        expert: K13 (``linear.moe_dec`` in a decode call, else
        ``linear.moe_mma``), or its plain version."""
        t, s = self.tensors(), self.spec
        variant = "dec" if decode else "mma"
        with span("linear.moe_" + variant):
            kw = dict(rowptr=t.get("sp_rowptr"), cols=t.get("sp_cols"),
                      vals=t.get("sp_vals"),
                      topx_weights=t.get("topx_weights"),
                      topx_indices=t.get("topx_indices"), mode=mode)
            if plain:
                return moe_lut.moe_lut_matmul_plain(
                    x, r.offsets, t["qweight"], t["lut"], s.bits, **kw)
            return moe_lut.moe_lut_matmul(
                x.contiguous(), r.offsets, t["qweight"], t["lut"], s.bits,
                variant=variant, tiles=r.tiles, row_tile=r.row_tile,
                per_row=r.k, **kw)


class MoEBlock(nn.Module):
    """A layer's sparse MLP: the router (E, hidden) f32 and the experts
    (``gate``, ``up`` and ``down``, or ``gateup`` and ``down`` fused),
    with the residual added last (module docstring)."""

    def __init__(self, config: MoEConfig, router: torch.Tensor,
                 experts: Dict[str, Experts]):
        super().__init__()
        self.config = config
        self.register_buffer("router", router.float().contiguous())
        self.experts = nn.ModuleDict(experts)
        # the model's (pairs, experts read) of its decode steps, shared by
        # every block (``attach_counters``)
        self.stats: Optional[torch.Tensor] = None

    def forward(self, x, step: llama.Step, residual=None):
        cfg = self.config
        b, s, hidden = x.shape
        h = x.reshape(-1, hidden)
        lin = step.lin()
        kernel = not step.plain and h.device.type == "cuda"
        variant = "dec" if lin["decode"] else "mma"
        with span("moe.route"):
            r = route(h, self.router, cfg.top_k, cfg.norm_topk,
                      moe_lut.row_tile(h.shape[0], variant) if kernel
                      else None)
            xs = h.index_select(0, r.tok)
            if self.stats is not None and step.lengths is not None:
                counts = r.offsets[1:] - r.offsets[:-1]
                self.stats[0] += r.tok.numel()
                self.stats[1] += (counts > 0).sum()
        ex = self.experts
        if "gateup" in ex:
            gu = ex["gateup"](xs, r, **lin).to(x.dtype)
            gate, up = gu[:, :cfg.expert_size], gu[:, cfg.expert_size:]
        else:
            gate = ex["gate"](xs, r, **lin).to(x.dtype)
            up = ex["up"](xs, r, **lin).to(x.dtype)
        with span("act"):
            a = torch.nn.functional.silu(gate) * up
        d = ex["down"](a, r, **lin)
        with span("moe.combine"):
            res = None if residual is None else residual.reshape(-1, hidden)
            fn = (moe_lut.moe_combine if kernel
                  else moe_lut.moe_combine_plain)
            out = fn(d, r.inv, r.weights, res)
        return out.to(x.dtype).reshape(b, s, hidden)


def attach_counters(model) -> torch.nn.Module:
    """Give ``model`` one (2,) int64 tensor on its device,
    ``model.moe_stats``, that every MoE block's decode steps add their
    pairs and the experts they read to; returns the model."""
    t = torch.zeros(2, dtype=torch.int64, device=model.device)
    for m in model.modules():
        if isinstance(m, MoEBlock):
            m.stats = t
    model.moe_stats = t
    return model
