"""Process-group bring-up, the collective backend's rule, the ('dp', 'tp')
mesh and a local launcher of tensor-parallel ranks.

The counterpart of the JAX package's ``parallel/multihost.py``: there
``jax.distributed.initialize`` joins the controllers of a pod; here
``torch.distributed.init_process_group`` joins one process per rank.

The collective backend follows the machine, and :func:`backend_for` is the
one place that decides it:

* CUDA, with at least ``tp`` cards: NCCL, rank r on card r (the local
  rank under torchrun); its collectives can be captured in a step's CUDA
  graph;
* CUDA, with fewer cards than ranks (one card): gloo over CUDA tensors,
  every rank on card 0 (NCCL refuses two ranks on one device). Gloo takes
  only all-reduce and broadcast of CUDA tensors, and cannot be captured:
  the steps run eagerly, and an engine asked for graphs on such a group
  raises (``graphs.check_capturable``);
* CPU: gloo.

:func:`launch` runs a function in ``world`` processes of its own (one
command, as the JAX CLI runs its mesh) with a file rendezvous, and fails,
rather than waits, when a rank fails or a collective outlives the group's
timeout.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# a collective that waits longer than this fails its rank (a deadlock
# raises instead of stalling the run)
TIMEOUT_S = 300.0


def backend_for(device, tp: int) -> str:
    """The collective backend of ``tp`` ranks on ``device``'s type (module
    docstring): "nccl" where every rank can have a card of its own, else
    "gloo"."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


def rank_device(device, rank: int, backend: str) -> torch.device:
    """Rank ``rank``'s device: its own card under NCCL (the local rank,
    which torchrun exports, else the rank), card 0 or the one asked for
    under gloo on CUDA, the CPU for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cuda", dev.index or 0)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, *, backend: str = "gloo",
               timeout_s: float = TIMEOUT_S) -> None:
    """Join this process to the process group. A strict no-op on one
    process, and when a group already exists.

    With no arguments the size and rank come from torchrun's environment
    (WORLD_SIZE, RANK, and MASTER_ADDR/MASTER_PORT for ``env://``) or
    SLURM's (SLURM_NTASKS, SLURM_PROCID, with MASTER_ADDR/MASTER_PORT set
    by the job); without either, or with a size of 1, nothing happens.
    Explicit ``world_size``, ``rank`` and ``init_method`` (``tcp://host:
    port``, ``file://path``) always initialize."""
    if dist.is_initialized():
        return
    if world_size is None:
        env = os.environ.get("WORLD_SIZE") or os.environ.get("SLURM_NTASKS")
        world_size = int(env) if env else None
    if world_size is None or world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ.get("RANK", os.environ.get("SLURM_PROCID", 0)))
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def is_primary() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_device_type() -> str:
    """The DeviceMesh device type of the current group: "cuda" for NCCL,
    "cpu" for gloo (whose groups also carry CUDA tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def pod_mesh(tp: Optional[int] = None):
    """The ('dp', 'tp') DeviceMesh over every rank: ``tp`` consecutive
    ranks a tensor-parallel group (torchrun numbers ranks node by node, so
    a group stays within a node while tp is at most its ranks), the groups
    data-parallel across the rest. tp defaults to the ranks of a node
    (LOCAL_WORLD_SIZE, else every rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    tp = tp or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % tp:
        raise ValueError(f"{world} ranks not divisible by tp={tp}")
    return init_device_mesh(mesh_device_type(), (world // tp, tp),
                            mesh_dim_names=("dp", "tp"))


def _rank_main(fn, rank: int, world: int, init_method: str, backend: str,
               device: str, timeout_s: float, args: Sequence[Any],
               results) -> None:
    """One launched rank: join the group on the rank's device, run
    ``fn(rank, *args)``, report (rank, ok, result or traceback)."""
    try:
        dev = rank_device(device, rank, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
            dist.barrier()  # no rank leaves while another still sends
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def _raise_failures(results, procs, out, rank: int, payload: str) -> None:
    """Raise with every failure the ranks report within a second, and the
    ranks that exited without a report: the first failure read may be a
    rank that lost its peer, not the cause."""
    failed = {rank: f"rank {rank} failed:\n{payload}"}
    try:
        while True:
            r, ok, p = results.get(timeout=1.0)
            if ok:
                out[r] = p
            else:
                failed[r] = f"rank {r} failed:\n{p}"
    except queue_mod.Empty:
        pass
    for r, proc in enumerate(procs):
        if r not in failed and r not in out and proc.exitcode is not None:
            failed[r] = (f"rank {r} exited with code {proc.exitcode} and "
                         f"reported nothing")
    raise RuntimeError("\n".join(failed[r] for r in sorted(failed)))


def launch(fn: Callable, world: int, args: Sequence[Any] = (), *,
           device="cpu", init_file: Optional[str] = None,
           timeout_s: float = TIMEOUT_S,
           join_timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` new processes (``spawn``: CUDA
    may already be initialized here), joined in one process group of
    :func:`backend_for`'s backend over a file rendezvous, each on
    :func:`rank_device`; returns each rank's result (picklable), in rank
    order. ``fn`` must be importable by the child (a module-level
    function).

    init_file: the rendezvous file, which must not exist yet (a temporary
    directory's by default). timeout_s: the group's collective timeout.
    join_timeout_s: how long the ranks may take in all (None: no limit).
    A rank that fails or dies makes the others be killed and raises
    RuntimeError with its traceback; so does the join timeout."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    backend = backend_for(device, world)
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="tp-rendezvous-")
        init_file = os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, f"file://{os.path.abspath(init_file)}", backend,
        str(device), timeout_s, tuple(args), results))
        for r in range(world)]
    deadline = (None if join_timeout_s is None
                else time.monotonic() + join_timeout_s)
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                gone = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if deadline is not None and time.monotonic() > deadline:
                    late = sorted(set(range(world)) - set(out))
                    raise RuntimeError(f"ranks {late} did not finish in "
                                       f"{join_timeout_s} s")
                if not gone:
                    continue
                try:  # what the rank reported just before it exited
                    rank, ok, payload = results.get(timeout=2.0)
                except queue_mod.Empty:
                    raise RuntimeError(
                        f"rank {gone[0]} exited with code "
                        f"{procs[gone[0]].exitcode} and reported nothing"
                    ) from None
            if not ok:
                _raise_failures(results, procs, out, rank, payload)
            out[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
