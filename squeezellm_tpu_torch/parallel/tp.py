"""Megatron tensor parallelism: one rank's shards of a model.

The counterpart of the JAX package's ``parallel/tp_shard_map.py``. There
the packed weights, LUTs, sidecars and KV cache are resharded on the host
into stacked per-device arrays, and the steps run under ``shard_map`` with
the kernels unchanged on each shard. Here every rank is a process of its
own (SPMD, ``parallel/multihost``): :func:`shard_model` makes the rank's
local model, whose linears go through the same kernels (K1-K12) at their
local shapes, and whose blocks all-reduce the row-parallel outputs and
gather the lm_head's vocab blocks (``models/common.all_reduce`` and
``gather_vocab``, reached through ``Step.tp``). The local model's
``prefill``, ``decode_step`` and ``verify_window`` are the JAX package's
``make_tp_step_fns``.

The sharding plan (``parallel/gspmd``), by linear:

* column-parallel (q, k, v, gate, up, lm_head): the output channels
  split; a rank holds ``qweight[:, its block]``, its LUT rows, the CSR
  rows of its block, its top-X channels (rebased; a rank may hold none)
  and its bias block;
* row-parallel (o, down): the inputs split at CODE granularity: the packed
  words are unpacked, sliced and packed again, since a split need not fall
  on a word (LLaMA-2-7B's down at tp=2 splits its 11008 inputs at code
  5504, inside a 3-bit word of 10 codes); the LUT is replicated; a rank
  holds the sidecar entries of its input columns (rebased) and the top-X
  weights' rows of its inputs (indices global); the bias is pre-scaled by
  1/tp, as in the JAX package, so the all-reduce restores it and both
  packages share the order of operations.

Each rank keeps its exact sidecar entries. The JAX package pads every
shard's COO to the largest shard's count, and its top-X to the largest
shard's channels, because ``shard_map`` needs one static shape; it also
builds per-shard SpMV slot plans (``_shard_spmv``), a TPU layout. Neither
is ported, nor are ``put_params``, ``_unstack`` and the ``P`` specs,
which mean nothing without ``shard_map``. The decode-time tables
(``struct_a``/``struct_d``, ``qweight_t``) are not sharded: fusing and
``models.fuse.attach_decode_luts`` run on the local model, giving each
rank its fused ``[q_l | k_l | v_l]`` and ``[gate_l | up_l]``, K10 tables
and K11 words.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from squeezellm_tpu_torch import formats
from squeezellm_tpu_torch.models.common import Linear, LinearSpec, TPGroup
from squeezellm_tpu_torch.ops.quant_linear import QuantLinearSpec
from squeezellm_tpu_torch.parallel import gspmd


def _block(n: int, rank: int, tp: int) -> Tuple[int, int]:
    size = n // tp
    return rank * size, (rank + 1) * size


def _own(t: torch.Tensor) -> torch.Tensor:
    """A slice as a tensor of its own (the full model may be freed)."""
    return t.contiguous().clone()


def _csr_rows(rowptr, cols, vals, lo: int, hi: int):
    """Rows [lo, hi) of a CSR sidecar, the row pointers rebased."""
    a, b = int(rowptr[lo]), int(rowptr[hi])
    return rowptr[lo: hi + 1] - a, cols[a:b], vals[a:b]


def _csr_cols(rowptr, cols, vals, lo: int, hi: int):
    """The entries of input columns [lo, hi) of a CSR sidecar, columns
    rebased, each row's entries in their order."""
    out_f = rowptr.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(out_f, device=rowptr.device),
        (rowptr[1:] - rowptr[:-1]).long())
    keep = (cols >= lo) & (cols < hi)
    counts = torch.bincount(rows[keep], minlength=out_f)
    new_ptr = torch.zeros(out_f + 1, dtype=rowptr.dtype, device=rowptr.device)
    new_ptr[1:] = torch.cumsum(counts, 0).to(rowptr.dtype)
    return new_ptr, cols[keep] - lo, vals[keep]


def shard_linear(name: str, linear: Linear, rank: int, tp: int) -> Linear:
    """Rank ``rank``'s shard of one linear (module docstring): column-
    parallel for q, k, v, gate, up and the lm_head, row-parallel for o
    and down. Dense linears ({'w', 'b'?}) split the same way. Only the
    base tensors are read; decode-time tables are attached later, to the
    local model."""
    col = name in gspmd._COLUMN or name == "lm_head"
    spec = linear.spec
    o, i = spec.out_features, spec.in_features
    if col and o % tp:
        raise ValueError(f"{name}: out {o} % tp {tp} != 0")
    if not col and i % tp:
        raise ValueError(f"{name}: in {i} % tp {tp} != 0")
    lo, hi = _block(o if col else i, rank, tp)
    out_l, in_l = (hi - lo, i) if col else (o, hi - lo)
    t = linear.tensors()

    def bias(b):
        return _own(b[lo:hi]) if col else (b / tp).to(b.dtype)

    if not spec.is_quant:
        new = {"w": _own(t["w"][lo:hi] if col else t["w"][:, lo:hi])}
        if spec.has_bias:
            new["b"] = bias(t["b"])
        return Linear(LinearSpec(in_features=in_l, out_features=out_l,
                                 has_bias=spec.has_bias), new)

    q = spec.quant
    if col:
        new = {"qweight": _own(t["qweight"][:, lo:hi]),
               "lut": _own(t["lut"][lo:hi])}
    else:
        codes = formats.unpack_codes(t["qweight"], q.bits, i)[lo:hi]
        new = {"qweight": formats.pack_codes(codes, q.bits),
               "lut": _own(t["lut"])}
    nnz = 0
    if q.nnz:
        split = _csr_rows if col else _csr_cols
        rowptr, cols, vals = split(t["sp_rowptr"], t["sp_cols"],
                                   t["sp_vals"], lo, hi)
        nnz = vals.numel()
        if nnz:
            new.update(sp_rowptr=_own(rowptr), sp_cols=_own(cols),
                       sp_vals=_own(vals))
    topx = 0
    if q.topx:
        w, idx = t["topx_weights"], t["topx_indices"]
        if col:
            mine = (idx >= lo) & (idx < hi)
            w, idx = w[:, mine], idx[mine] - lo
        else:
            w = w[lo:hi]
        topx = idx.numel()
        if topx:
            new.update(topx_weights=_own(w), topx_indices=_own(idx))
    if q.has_bias:
        new["bias"] = bias(t["bias"])
    ql = QuantLinearSpec(bits=q.bits, in_features=in_l, out_features=out_l,
                         has_bias=q.has_bias, nnz=nnz, topx=topx)
    return Linear(LinearSpec(in_features=in_l, out_features=out_l,
                             has_bias=spec.has_bias, quant=ql), new)


def shard_model(model, group=None, *, fuse: bool = False):
    """This process's local model of the tensor-parallel group ``group``
    (a process group; None: the default group), whose rank and size it
    takes as the shard's (the counterpart of ``shard_model_params`` with
    the step functions of ``make_tp_step_fns``): a new Llama or OPT of the
    same config whose layers' linears and lm_head are the rank's shards
    (:func:`shard_linear`), embeddings and norms shared with ``model``,
    and ``tp`` set to the rank's :class:`~models.common.TPGroup`.
    ``model`` must be unfused, as the JAX package shards the unfused
    registry linears; ``fuse=True`` fuses the local model after
    (``models.fuse.fuse_for_decode``)."""
    from squeezellm_tpu_torch.models import fuse as fuse_mod
    from squeezellm_tpu_torch.models import llama, opt

    rank, tp = dist.get_rank(group), dist.get_world_size(group)
    is_opt = isinstance(model, opt.OPT)
    err = gspmd.validate_shardable("opt" if is_opt else "llama",
                                   model.config, tp)
    if err:
        raise ValueError(f"cannot shard over tp={tp}: {err}")
    layers = []
    for layer in model.layers:
        lins = gspmd.layer_linears(layer)
        fused = {"qkv", "gateup"} & set(lins)
        if fused:
            raise ValueError(f"shard the unfused model: {sorted(fused)} are "
                             f"fused (fuse the local model after)")
        local = {n: shard_linear(n, lin, rank, tp) for n, lin in lins.items()}
        if is_opt:
            layers.append(opt.DecoderLayer(model.config, local, {
                n: (getattr(layer, n + "_w"), getattr(layer, n + "_b"))
                for n in ("attn_norm", "ffn_norm")}))
        else:
            layers.append(llama.DecoderLayer(model.config, local,
                                             layer.input_norm,
                                             layer.post_norm))
    head = shard_linear("lm_head", model.lm_head.linear, rank, tp)
    if is_opt:
        out = opt.OPT(model.config, model.embed, model.embed_pos, layers,
                      (model.final_norm_w, model.final_norm_b), head)
    else:
        out = llama.Llama(model.config, model.embed, layers,
                          model.final_norm, head)
    out.tp = TPGroup(rank=rank, size=tp, group=group,
                     backend=dist.get_backend(group))
    return fuse_mod.fuse_for_decode(out) if fuse else out
