"""The tensor/data-parallel sharding plan as placements, and what divides.

The counterpart of the JAX package's ``parallel/gspmd.py``. There the
plan is a tree of ``PartitionSpec``s that XLA's partitioner reads; PyTorch
has no such partitioner worth building for this model, so here the plan is
a tree of ``torch.distributed.tensor`` placements over the ('dp', 'tp')
mesh, one ``(dp placement, tp placement)`` pair a tensor, and the explicit
per-rank path (``parallel/tp.py``) carries it out for the kernel and the
plain versions alike. The mesh's ``dp`` axis is the batch's split: each
dp group runs its own rows through a tp-sharded copy of the model.

Megatron column/row parallelism, as in the JAX package:

* q, k, v, gate, up and the lm_head (column-parallel): the output
  channels split; a quantized linear's ``qweight`` (n_words, out) on its
  dim 1, ``lut`` and ``bias`` on dim 0;
* o, down (row-parallel): the inputs split; ``qweight`` on its words (dim
  0; ``tp.shard_linear`` repacks at code granularity where the split falls
  inside a word), ``lut`` and ``bias`` replicated (``tp.shard_linear``
  pre-scales the bias by 1/tp);
* the sparse sidecar: replicated in this plan, as in the JAX package's;
  ``tp.shard_linear`` hands each rank the entries of its rows (column) or
  columns (row), since its entries are no dense dimension;
* embeddings and norms replicated; the KV cache over the batch (dp) and
  its head-flat last axis (tp).
"""

from __future__ import annotations

from typing import Dict, Optional

from torch.distributed.tensor import Replicate, Shard

from squeezellm_tpu_torch.parallel import multihost

# column-parallel (shard output channels) vs row-parallel (shard inputs)
_COLUMN = {"q", "k", "v", "gate", "up"}
_ROW = {"o", "down"}

REP = (Replicate(), Replicate())


def _tp(placement) -> tuple:
    """(dp, tp) placements of a tensor replicated over dp."""
    return (Replicate(), placement)


def make_mesh(tp: int, dp: int = 1):
    """The (dp, tp) DeviceMesh of the process group, whose size must be
    tp * dp."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tp * dp:
        raise ValueError(f"need {tp * dp} ranks, have {world}")
    return init_device_mesh(multihost.mesh_device_type(), (dp, tp),
                            mesh_dim_names=("dp", "tp"))


def linear_placements(name: str, linear) -> Dict[str, tuple]:
    """Placements of one linear's tensors (a port ``Linear`` of the
    unfused model: a fused q|k|v or gate|up is no block of columns)."""
    if name not in _COLUMN | _ROW | {"lm_head"}:
        raise ValueError(f"no placement for the linear {name!r}: place "
                         f"the unfused model")
    col = name in _COLUMN or name == "lm_head"
    spec = linear.spec
    if not spec.is_quant:  # w (out, in)
        out = {"w": _tp(Shard(0) if col else Shard(1))}
        if spec.has_bias:
            out["b"] = _tp(Shard(0)) if col else REP
        return out
    out = {"qweight": _tp(Shard(1) if col else Shard(0)),
           "lut": _tp(Shard(0)) if col else REP}
    if spec.has_bias:
        out["bias"] = _tp(Shard(0)) if col else REP
    q = spec.quant
    if q.nnz:
        out.update(sp_rowptr=REP, sp_cols=REP, sp_vals=REP)
    if q.topx:
        out["topx_weights"] = REP if col else _tp(Shard(0))
        out["topx_indices"] = REP
    return out


def layer_linears(layer) -> Dict[str, object]:
    """A decoder layer's linears by name (LLaMA or OPT, fused or not)."""
    out = dict(layer.attn.proj.items())
    if hasattr(layer, "mlp"):
        out.update(layer.mlp.proj.items())
    else:  # OPT: up and down sit on the layer
        out.update(up=layer.up, down=layer.down)
    return out


def param_partition_specs(model) -> dict:
    """The placement tree of a port model, keyed as the JAX package's
    parameter tree ({'embed', 'layers': [{name: {...}, norms}],
    'final_norm', 'lm_head'}; OPT with 'embed_pos' and {'w', 'b'} norms):
    the counterpart of ``param_partition_specs``."""
    opt = hasattr(model, "embed_pos")
    out = {"embed": REP}
    if opt:
        out["embed_pos"] = REP
        out["final_norm"] = {"w": REP, "b": REP}
    else:
        out["final_norm"] = REP
    out["lm_head"] = linear_placements("lm_head", model.lm_head.linear)
    layers = []
    for layer in model.layers:
        d = {name: linear_placements(name, lin)
             for name, lin in layer_linears(layer).items()}
        if opt:
            d["attn_norm"] = {"w": REP, "b": REP}
            d["ffn_norm"] = {"w": REP, "b": REP}
        else:
            d["input_norm"] = REP
            d["post_norm"] = REP
        layers.append(d)
    out["layers"] = layers
    return out


def cache_partition_specs(cache) -> list:
    """A token-major cache's placements: (B, S, H_kv * D) over the batch
    (dp) and the head-flat last axis (tp: a contiguous block of it is a
    rank's kv-head group); an int8 cache's (B, H_kv, S) scales over the
    batch and the heads."""
    return [{name: ((Shard(0), Shard(1)) if name in ("ks", "vs")
                    else (Shard(0), Shard(2))) for name in layer}
            for layer in cache]


def validate_shardable(model_type: str, config, tp: int) -> Optional[str]:
    """Check divisibility constraints; returns an error string or None."""
    if config.n_heads % tp:
        return f"n_heads {config.n_heads} % tp {tp} != 0"
    if config.n_kv_heads % tp:
        return f"n_kv_heads {config.n_kv_heads} % tp {tp} != 0"
    inter = getattr(config, "intermediate_size", getattr(config, "ffn_dim", 0))
    if inter % tp:
        return f"intermediate {inter} % tp {tp} != 0"
    if config.vocab_size % tp:
        return f"vocab {config.vocab_size} % tp {tp} != 0"
    return None
