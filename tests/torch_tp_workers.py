"""Rank functions of the tensor-parallel tests (`parallel.multihost.launch`
runs each in its own process): they import neither JAX nor the JAX
package, so a spawned rank loads only the port. Each takes numpy trees in
the JAX package's format (`carry.from_tree`), builds the full port model
on the CPU, shards it over the launched group, runs its cases and returns
numpy arrays and token lists, which the tests compare in their own
process."""

import torch

from squeezellm_tpu_torch import carry, serving
from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.sampling import SamplingParams

THREADS = 2  # each rank's torch threads (several ranks share the CPU)


def port_model(tree):
    """The full port model of a (model type, config dict, module meta,
    params) tree, on the CPU."""
    model_type, config, meta, params = tree
    return carry.from_tree(model_type, config, meta, params, "cpu")


def step_logits(model, prompt, fed, *, dtype=torch.float32, mode="exact"):
    """The prefill's last logits of ``prompt`` (1, S), then one decode
    step's for each token of ``fed``, teacher-forced: (1 + len(fed), V)
    f32, over a fresh cache of the model's own kv heads."""
    cfg = model.config
    cache = common.init_kv_cache(1, cfg.max_seq, cfg.n_layers,
                                 common.kv_heads(model), cfg.head_dim, dtype,
                                 "cpu")
    kw = dict(dtype=dtype, mode=mode)
    rows = [model.prefill(torch.as_tensor(prompt), cache, **kw)[0, -1]]
    for i, tok in enumerate(fed):
        rows.append(model.decode_step(torch.tensor([[tok]]),
                                      prompt.shape[1] + i, cache, **kw)[0, -1])
    return torch.stack(rows).float().numpy()


def forward_cases(rank, cases, prompt, fed):
    """Each case (tree, fuse, mode): this rank's TP logits (step_logits)
    and the collectives its local model called."""
    from squeezellm_tpu_torch.parallel import tp

    torch.set_num_threads(THREADS)
    out = []
    with torch.no_grad():
        for tree, fuse, mode in cases:
            local = tp.shard_model(port_model(tree), fuse=fuse)
            dtype = torch.bfloat16 if mode == "bf16" else torch.float32
            logits = step_logits(local, prompt, fed, dtype=dtype,
                                 mode=mode)
            out.append((logits, dict(local.tp.counts)))
    return out


def dp_tp_forward(rank, tree, tokens, dp, tp_size):
    """A dp x tp mesh (``gspmd.make_mesh``): this rank's dp group runs its
    rows of ``tokens`` through the model sharded over its tp group.
    Returns (dp index, tp index, full-sequence logits of those rows)."""
    from squeezellm_tpu_torch.parallel import gspmd, tp

    torch.set_num_threads(THREADS)
    mesh = gspmd.make_mesh(tp=tp_size, dp=dp)
    d, t = mesh.get_coordinate()
    local = tp.shard_model(port_model(tree), group=mesh.get_group("tp"))
    rows = tokens.shape[0] // dp
    with torch.no_grad():
        logits = local.forward(torch.as_tensor(tokens[d * rows:
                                                      (d + 1) * rows]))
    return d, t, logits.numpy()


def _engine(model, tp_size, kind, kw):
    cls = {"dense": serving.TPContinuousBatchEngine,
           "paged": serving.TPPagedContinuousBatchEngine}[kind]
    return cls(model, tp=tp_size, **kw)


def serve_cases(rank, tree, cases, tp_size):
    """Each case (name, engine kind, engine kwargs, run kwargs, prompts):
    the TP engine's run() results {rid: tokens} on this rank (a case named
    "staggered..." runs :func:`run_staggered` with the run kwargs'
    max_new_tokens instead), and its stats under "<name> stats". A run
    kwarg ``sampling`` is a dict of SamplingParams' fields."""
    torch.set_num_threads(THREADS)
    out = {}
    model = port_model(tree)
    with torch.no_grad():
        for name, kind, ekw, rkw, prompts in cases:
            rkw = dict(rkw)
            if "sampling" in rkw:
                rkw["sampling"] = SamplingParams(**rkw["sampling"])
            eng = _engine(model, tp_size, kind, ekw)
            res = (run_staggered(eng, prompts, rkw["max_new_tokens"])
                   if name.startswith("staggered")
                   else eng.run(prompts, **rkw))
            out[name] = {rid: [int(t) for t in v] for rid, v in res.items()}
            out[name + " stats"] = dict(eng.stats)
    return out


def run_staggered(eng, prompts, max_new):
    """Requests joining while others decode, and a cancel: admit two,
    step, admit a third and cancel the first, admit a fourth, run to the
    end. Returns {rid: tokens} of the finished requests."""
    a = eng.add_request(prompts[0], max_new)
    eng.add_request(prompts[1], max_new)
    eng.step()
    eng.step_window(2)
    eng.add_request(prompts[2], max_new)
    eng.cancel(a)
    eng.add_request(prompts[3], max_new)
    done = {}
    while any(s.active for s in eng._slots):
        for rid, r in eng.step().items():
            if r["done"]:
                done[rid] = [int(t) for t in r["tokens"]]
    return done


def mesh_worker(rank):
    """pod_mesh on four ranks: its shape, axis names and tp groups, an
    all-reduce over the world and one over each tp group, the vocab
    gather's two forms; a tp that does not divide the ranks refused."""
    import torch.distributed as dist

    from squeezellm_tpu_torch.parallel import multihost

    mesh = multihost.pod_mesh(tp=2)
    try:
        multihost.pod_mesh(tp=3)
        refused = False
    except ValueError:
        refused = True
    x = torch.full((2,), float(rank + 1))
    dist.all_reduce(x)
    y = torch.full((1,), float(rank + 1))
    dist.all_reduce(y, group=mesh.get_group("tp"))
    # the vocab gather both ways on this gloo group: NCCL's form (an
    # all-gather) and gloo's (an all-reduce of zero-filled rows)
    from squeezellm_tpu_torch.models import common

    block = torch.arange(12.0).reshape(2, 1, 6) + 100 * rank
    gathered = [common.gather_vocab(block, common.TPGroup(
        rank=rank, size=4, group=None, backend=b)) for b in ("nccl", "gloo")]
    return dict(shape=tuple(mesh.shape), names=mesh.mesh_dim_names,
                gathered=[g.tolist() for g in gathered],
                coord=tuple(mesh.get_coordinate()),
                tp_ranks=sorted(dist.get_process_group_ranks(
                    mesh.get_group("tp"))),
                primary=multihost.is_primary(), refused=refused,
                world_sum=x.tolist(), tp_sum=y.item())


def fail_on(rank, bad_rank, how):
    """Rank ``bad_rank`` raises ("raise"), leaves without reporting
    ("exit") or outwaits the launcher ("sleep"); the others wait in a
    collective for it."""
    import os
    import time

    import torch.distributed as dist

    if rank == bad_rank:
        if how == "raise":
            raise ValueError("rank failed on purpose")
        if how == "exit":
            os._exit(0)
        time.sleep(60)
    dist.barrier()
    return rank


def card_tokens(rank, config_dict, prompts, graphs):
    """On the card: the TP dense and paged engines' greedy tokens through
    the kernels (graphed or eager) and through the plain path, each
    path's K1 launches; on a gloo group, whether asking for graphs was
    refused."""
    from squeezellm_tpu_torch import synthetic
    from squeezellm_tpu_torch.models import llama
    from squeezellm_tpu_torch.ops import lut_matmul

    cfg = llama.LlamaConfig(**config_dict)
    model = synthetic.quantized_llama(cfg, 4, sparsity=0.02, topx=2, seed=3,
                                      device="cuda")
    out = {}
    with torch.no_grad():
        for kind in ("dense", "paged"):
            kw = dict(slots=4, max_seq=96, graphs=graphs, fuse=True,
                      cache_dtype=torch.float32)
            if kind == "paged":
                kw.update(n_pages=32, page_size=16)
            for plain in (False, True):
                before = lut_matmul.lut_matmul.launches
                eng = _engine(model, 2, kind, dict(kw, plain=plain))
                res = eng.run(prompts, max_new_tokens=6)
                out[kind, plain] = (
                    {r: [int(t) for t in v] for r, v in res.items()},
                    lut_matmul.lut_matmul.launches - before)
        if eng.model.tp.backend == "gloo":
            try:
                _engine(model, 2, "dense", dict(slots=2, graphs=True))
                out["refused"] = False
            except ValueError:
                out["refused"] = True
        out["backend"] = eng.model.tp.backend
        out["device"] = str(eng.device)
    return out
