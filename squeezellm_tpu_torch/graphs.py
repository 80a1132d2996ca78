"""Step programs captured once as CUDA graphs and replayed.

The counterpart of the JAX package's jitted step functions with a donated
cache (``engine.py`` ``_gen_step``, ``_bench_step``, the speculative loops;
``serving.py``'s decode and spec-window steps). A :class:`StepGraph` owns a
step's body: a function of no arguments that reads persistent input
buffers (token, position, ids, sampler arrays, page table), updates the
persistent cache in place and writes persistent output buffers. Its first
call runs the body for real on a side stream (the warm-up: lazy work such
as a kernel library's load, a workspace's allocation or a kernel's shared
memory limit happens there) and then captures it; every later call replays
the graph. Callers ``copy_`` into the inputs before a call and read the
outputs after it; a call copies nothing by itself.

On a CPU device, or with ``capture=False`` (an engine made with
``graphs=False``), every call runs the body eagerly over the same buffers:
the same steps, with no capture. On a CUDA device a failed capture raises.

Tensor parallelism. A step of a tensor-parallel shard (``model.tp``)
runs its collectives inside the body. On an NCCL group they are captured
with it: the warm-up call runs them for real first (it creates the NCCL
communicator), then the capture records them on the capture stream. Gloo
cannot be captured, so :func:`check_capturable`, which the engines call
before they capture, raises for a gloo group on a CUDA device: such a
group's steps run with ``graphs=False``.

Launch counts. The kernel wrappers count their launches on the host
(``lut_matmul.launches`` and the like), and a replay runs no Python. The
warm-up runs the step for real, so its launches count as they happen; the
capture runs nothing, so the counts it added are taken back, and what it
added is added again at every replay. A graphed run's counts therefore
equal those of the same run made eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

# integer and per-kernel (dict) counters a wrapper may carry
COUNTERS = ("launches", "ropeless_launches", "copy_launches",
            "variant_launches", "regime_launches")


def counted_wrappers() -> tuple:
    """The kernel wrappers, K1 to K12, then K13 and its combine."""
    from squeezellm_tpu_torch.ops import (decode_attn, dequant_dense,
                                          flash_attn, lut_matmul,
                                          lut_matmul_t, moe_lut, paged_attn,
                                          spmv)

    return (lut_matmul.lut_matmul, decode_attn.decode_attention,
            flash_attn.flash_attention, dequant_dense.dequant_dense,
            decode_attn.decode_attention_q8,
            paged_attn.paged_decode_attention,
            paged_attn.paged_decode_attention_q8,
            paged_attn.paged_verify_attention,
            paged_attn.paged_verify_attention_q8,
            lut_matmul.lut_matmul_struct, lut_matmul_t.lut_matmul_t,
            spmv.spmv, moe_lut.moe_lut_matmul, moe_lut.moe_combine)


Counts = Dict[Tuple[int, str], object]


def read_counts() -> Counts:
    """Every wrapper's counters as they stand (dicts copied)."""
    out: Counts = {}
    for i, fn in enumerate(counted_wrappers()):
        for name in COUNTERS:
            if hasattr(fn, name):
                v = getattr(fn, name)
                out[i, name] = dict(v) if isinstance(v, dict) else v
    return out


def count_increase(before: Counts, after: Counts) -> Counts:
    """What the counters gained from `before` to `after` (the counters
    that did not move left out, so that adding it back costs little)."""
    out: Counts = {}
    for key, v in after.items():
        b = before.get(key)
        if isinstance(v, dict):
            d = {k: n - (b or {}).get(k, 0) for k, n in v.items()}
            d = {k: n for k, n in d.items() if n}
        else:
            d = v - (b or 0)
        if d:
            out[key] = d
    return out


def add_counts(delta: Counts, sign: int = 1) -> None:
    """Add `delta` (or take it back, sign -1) to the wrappers' counters."""
    fns = counted_wrappers()
    for (i, name), v in delta.items():
        cur = getattr(fns[i], name)
        if isinstance(v, dict):
            for k, n in v.items():
                cur[k] = cur.get(k, 0) + sign * n
        else:
            setattr(fns[i], name, cur + sign * v)


def check_capturable(model) -> None:
    """Raise unless the steps of ``model`` can be captured: a tensor-
    parallel shard whose collectives run over gloo on a CUDA device
    cannot (module docstring). Asked for graphs, such an engine fails
    here instead of quietly running eagerly."""
    tp = getattr(model, "tp", None)
    if (tp is not None and tp.backend != "nccl"
            and model.device.type == "cuda"):
        raise ValueError(
            f"CUDA graphs need an NCCL group: this tensor-parallel shard's "
            f"collectives run over {tp.backend}, which a graph cannot "
            f"capture; pass graphs=False")


class StepGraph:
    """One step program over persistent buffers (module docstring).

    body: reads the static inputs, writes the static outputs and the
    cache; it must keep nothing it allocates past its return. device: where
    it runs. capture: False runs the body eagerly at every call. pool: a
    memory pool handle (``torch.cuda.graph_pool_handle()``) that the graphs
    of one engine share; they replay one at a time on one stream.

    ``delta`` is the counters' increase of one step, ``replays`` the
    replays so far."""

    def __init__(self, body: Callable[[], None], device, *,
                 capture: bool = True, pool=None):
        self.body = body
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.delta: Optional[Counts] = None
        self.replays = 0

    def __call__(self) -> None:
        if not self.capture:
            if self.delta is None:  # read once: counting costs host time
                before = read_counts()
                self.body()
                self.delta = count_increase(before, read_counts())
            else:
                self.body()
            return
        if self.graph is None:
            self._warm_up_and_capture()
            return
        self.graph.replay()
        add_counts(self.delta)
        self.replays += 1

    def _warm_up_and_capture(self) -> None:
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.body()  # this call's step, run for real
        main.wait_stream(side)
        before = read_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev):
            with torch.cuda.graph(graph, pool=self.pool):
                self.body()
        self.delta = count_increase(before, read_counts())
        add_counts(self.delta, -1)  # the capture ran nothing
        self.graph = graph
