"""Tensor parallelism over ``torch.distributed``: the counterpart of the
JAX package's ``parallel/`` (``multihost``, ``gspmd``, ``tp_shard_map``).

One process per rank (SPMD). Every rank holds its shards of the model
(Megatron column- and row-parallel quantized linears, KV heads split
between the ranks), its own KV cache or page pool over its heads, and an
identical copy of a serving engine's host bookkeeping; the model runs two
all-reduces a layer and gathers the lm_head's vocab blocks, so every rank
ends a step with the same logits and picks the same token.

* ``multihost``: process-group bring-up, the collective backend's rule,
  the ('dp', 'tp') mesh and a local launcher of the ranks;
* ``gspmd``: the sharding plan as placements, and what divides;
* ``tp``: the per-rank shards of a model (``shard_linear``,
  ``shard_model``).

The submodules are imported by name; this file imports none of them, so
that the models can import ``multihost`` without a cycle.
"""
