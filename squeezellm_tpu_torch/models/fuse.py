"""Decode-time module fusion: concatenate q|k|v and gate|up (LLaMA) or
q|k|v (OPT) along output channels into single quantized linears.

The counterpart of the JAX package's ``models/fuse.py`` (``_fuse_linears``,
``fuse_for_decode`` and ``attach_decode_luts``). The inputs are shared, so
packed words and LUTs concatenate along the output axis, the CSR sidecars
stack row blocks, and top-X indices move to the fused output space. No
SpMV slot plans are built: K1 folds the CSR sidecar itself.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from squeezellm_tpu_torch.models.common import Linear, LinearSpec
from squeezellm_tpu_torch.ops.quant_linear import QuantLinearSpec
from squeezellm_tpu_torch.quantize.kmeans import structured_decomposition

FUSE_GROUPS = (("qkv", ("q", "k", "v")), ("gateup", ("gate", "up")))


def _fusable(linears: Sequence) -> bool:
    if any(m is None or not m.spec.is_quant for m in linears):
        return False
    q0 = linears[0].spec.quant
    return all(m.spec.quant.bits == q0.bits
               and m.spec.in_features == linears[0].spec.in_features
               for m in linears)


def fuse_linears(linears: List[Linear]) -> Linear:
    """Concatenate quantized linears (same bits, same input) along the
    output dim."""
    specs = [m.spec.quant for m in linears]
    ps = [m.tensors() for m in linears]
    bits, in_f = specs[0].bits, specs[0].in_features
    offsets = [0]
    for s in specs:
        offsets.append(offsets[-1] + s.out_features)
    out_f = offsets[-1]
    dev = ps[0]["qweight"].device
    new = {
        "qweight": torch.cat([p["qweight"] for p in ps], dim=1),
        "lut": torch.cat([p["lut"] for p in ps], dim=0),
    }
    nnz = sum(s.nnz for s in specs)
    if nnz:
        ptrs, base = [torch.zeros(1, dtype=torch.int32, device=dev)], 0
        for s, p in zip(specs, ps):
            if s.include_sparse:
                ptrs.append(p["sp_rowptr"][1:] + base)
                base += s.nnz
            else:
                ptrs.append(torch.full((s.out_features,), base,
                                       dtype=torch.int32, device=dev))
        new["sp_rowptr"] = torch.cat(ptrs)
        new["sp_cols"] = torch.cat([p["sp_cols"] for s, p in zip(specs, ps)
                                    if s.include_sparse])
        new["sp_vals"] = torch.cat([p["sp_vals"] for s, p in zip(specs, ps)
                                    if s.include_sparse])
    topx = sum(s.topx for s in specs)
    if topx:
        new["topx_weights"] = torch.cat(
            [p["topx_weights"] for s, p in zip(specs, ps) if s.topx], dim=1)
        new["topx_indices"] = torch.cat(
            [p["topx_indices"] + off
             for s, p, off in zip(specs, ps, offsets) if s.topx])
    has_bias = any(s.has_bias for s in specs)
    if has_bias:
        new["bias"] = torch.cat([
            p["bias"] if s.has_bias
            else torch.zeros(s.out_features, dtype=torch.float32, device=dev)
            for s, p in zip(specs, ps)])
    q = QuantLinearSpec(bits=bits, in_features=in_f, out_features=out_f,
                        has_bias=has_bias, nnz=nnz, topx=topx)
    return Linear(LinearSpec(in_features=in_f, out_features=out_f,
                             has_bias=has_bias, quant=q), new)


def fuse_for_decode(model):
    """Fuse every fusable q|k|v and gate|up group of a Llama or OPT model
    in place (one layer at a time, so the old tensors are freed as it
    goes), a sparse-expert block's gate|up expert by expert
    (:func:`fuse_experts`), then ``attach_decode_luts``; returns the
    model. Unfusable groups stay as they are; OPT has no gate|up group
    (its MLP is up, ReLU, down)."""
    for layer in model.layers:
        for block in (layer.attn, getattr(layer, "mlp", None)):
            if block is None:
                continue
            if hasattr(block, "experts"):  # a sparse-expert MLP
                fuse_experts(block.experts)
                continue
            for fused_name, names in FUSE_GROUPS:
                members = [block.proj[n] if n in block.proj else None
                           for n in names]
                if not _fusable(members):
                    continue
                fused = fuse_linears(members)
                for n in names:
                    del block.proj[n]
                block.proj[fused_name] = fused
    return attach_decode_luts(model)


def fuse_experts(experts) -> None:
    """Fuse gate|up expert by expert in a sparse-expert block's stacked
    linears (``models.moe.Experts``, a ModuleDict of ``gate``, ``up`` and
    ``down``), in place, on the stacked tensors: expert e's ``gateup`` is
    what ``fuse_linears`` makes of its gate and up (the codes, LUTs and
    top-X rows side by side, its sidecar gate's entries then up's)."""
    if "gate" not in experts or "up" not in experts:
        return
    gate, up = experts["gate"], experts["up"]
    g, u = gate.tensors(), up.tensors()
    f, n_exp = gate.spec.out_features, gate.n_experts
    new = {"qweight": torch.cat([g["qweight"], u["qweight"]], dim=2),
           "lut": torch.cat([g["lut"], u["lut"]], dim=1)}
    nnz = gate.spec.nnz + up.spec.nnz
    if nnz:
        dev = g["qweight"].device
        ptr, cols, vals, key = [], [], [], []
        for j, t, spec in ((0, g, gate.spec), (1, u, up.spec)):
            rp = t.get("sp_rowptr")
            if rp is None:
                rp = torch.zeros(n_exp, spec.out_features + 1,
                                 dtype=torch.int32, device=dev)
            rp = rp.long()
            ptr.append(rp - rp[:, :1])  # each expert's from 0
            cols.append(t.get("sp_cols", rp.new_zeros(0, dtype=torch.int32)))
            vals.append(t.get("sp_vals", rp.new_zeros(0, dtype=torch.float32)))
            ent = torch.arange(spec.nnz, device=dev)
            key.append(2 * torch.searchsorted(rp[:, -1].contiguous(), ent,
                                              right=True) + j)
        # expert e's entries move to after every earlier expert's of both
        base = (ptr[0][:, -1] + ptr[1][:, -1]).cumsum(0)
        base = (base - ptr[0][:, -1] - ptr[1][:, -1])[:, None]
        new["sp_rowptr"] = torch.cat(
            [ptr[0] + base, ptr[1][:, 1:] + base + ptr[0][:, -1:]],
            dim=1).to(torch.int32)
        order = torch.argsort(torch.cat(key), stable=True)
        new["sp_cols"] = torch.cat(cols)[order]
        new["sp_vals"] = torch.cat(vals)[order]
    topx = gate.spec.topx + up.spec.topx
    if topx:
        parts = [(t["topx_weights"], t["topx_indices"] + off)
                 for t, s, off in ((g, gate.spec, 0), (u, up.spec, f))
                 if s.topx]
        new["topx_weights"] = torch.cat([w for w, _ in parts], dim=1)
        new["topx_indices"] = torch.cat([i for _, i in parts], dim=1)
    spec = QuantLinearSpec(bits=gate.spec.bits,
                           in_features=gate.spec.in_features,
                           out_features=f + up.spec.out_features, nnz=nnz,
                           topx=topx)
    del experts["gate"], experts["up"]
    experts["gateup"] = type(gate)(spec, n_exp, new)


def quant_linears(model):
    """Every quantized linear of the model, the lm_head's included."""
    return [m for m in model.modules()
            if isinstance(m, Linear) and m.spec.is_quant]


def attach_decode_luts(model, transposed: bool = False):
    """Attach decode-path tables to every 4-bit quantized linear, in place
    (idempotent); returns the model.

    * ``struct_a`` (out, 8) and ``struct_d`` (out,) f32 where the LUT is a
      STRUCTURED codebook ``lut[c] = A[c & 7] + (c >> 3) * d``
      (``quantize.kmeans.fit_structured_luts``; detected with the JAX
      package's ``structured_decomposition``): ``quant_linear`` then sends
      calls under 1024 rows through K10. The JAX package attaches the same
      A and d as its TPU table (16, out) with d / 8 in row 8.
    * with ``transposed=True``, ``qweight_t`` (out, n_words) int32, the
      packed words transposed: calls of at most 8 rows go through K11 and
      the sidecar through K12. The TPU's period-16 wide table is not
      attached; K11 reads the LUT.

    Unlike the JAX package, the lm_head gets them too."""
    for lin in quant_linears(model):
        if lin.spec.quant.bits != 4:
            continue
        t = lin.tensors()
        if "struct_a" not in t:
            dec = structured_decomposition(t["lut"])
            if dec is not None:
                lin.add_tensors(**{
                    name: torch.from_numpy(a).to(t["lut"].device)
                    for name, a in zip(("struct_a", "struct_d"), dec)})
        if transposed and "qweight_t" not in t:
            lin.add_tensors(qweight_t=t["qweight"].t().contiguous())
    return model
