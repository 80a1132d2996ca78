"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs ``squeezellm_tpu_torch``'s paged serving engine (bf16 activations,
K1 in bf16 mode, a bf16 page pool, graphed steps) at the cell's published
configuration with weights made on the card from the seed, warms up the
cell's shapes, drives the cell's traffic through the client loop
(``pbench/loop.py``) for ``--seconds`` of measured window, then checks a
sample of the served tokens against the plain reference
(``pbench/check.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read by
``metrics/<name>.py``), ``device`` and, traced, ``breakdown``; last the
numbers compared beside their limits (``checks``), which also close
standard error. Earlier lines of standard error give the set-up's parts,
the card's clock and power, each timing's median and sample count, and
the trace's reduction.

The configuration's architecture is its family (``pbench.spec.family``,
``families/<model_type>.py``): the port's model, the plain reference and
the work counts. Exits 4 without a result, before anything is built, when the
configuration's ``model_type`` has no family file (the last line of
standard error names it); 2 when no card (or too few) is present; 3 when
a module of JAX or of the JAX package is loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the harness's own modules, then the program at the checkout's root
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# caches at fixed paths inside the checkout; no library the port uses may
# load JAX or Flax on its own
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ.setdefault(_var, os.path.join(ROOT, "build", "cache", _sub))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "squeezellm_tpu")


def forbidden_modules(names=None):
    """Loaded modules whose top-level name (before the first dot), taken
    whole, is JAX's, jaxlib's, Flax's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    loop: object
    work: object
    trace: object
    peak_bytes: int
    setup_s: float


def warm_lengths(sizes, n: int = 5):
    """n prompt lengths of the mix, from its shortest to its longest."""
    ps = sorted(set(sizes.prompts))
    idx = sorted({round(i * (len(ps) - 1) / max(1, n - 1)) for i in range(n)})
    return [ps[i] for i in idx]


def warm_up(eng, lengths, window: int, seed: int, vocab: int) -> None:
    """Admit a prompt of each length (as many at a time as slots are free)
    and decode it through two windows: the step program's capture, the
    prefill's kernels at the cell's lengths, the library's first calls."""
    from pbench import mixes

    todo = [mixes.prompt_tokens(seed, 10**9 + i, n, vocab)
            for i, n in enumerate(lengths)]
    while todo:
        n = eng.free_slots()
        for p in todo[:n]:
            eng.add_requests([p], window + 1)
        todo = todo[n:]
        while eng.free_slots() < eng.n_slots:
            eng.step_window(window)


def prepare(c: dict, seed: int, device: str, seconds: float,
            trace: bool, fault=None) -> dict:
    """Everything before the loop for cell ``c`` (``spec.cell``): the
    kernels, the model (its family's ``build_model``), the engine (given
    to ``fault`` first, if one is given), the warm-up; each part's
    seconds."""
    import torch

    from pbench import mixes, port
    from pbench.trace import Tracer

    cfg, st = c["config"], c["settings"]
    parts = {}
    t = time.perf_counter()
    if device == "cuda":
        from squeezellm_tpu_torch import _build

        _build.lib()
    parts["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    model = c["family"].build_model(cfg, seed, device)
    eng = port.build_engine(model, st, cfg["serve"])
    if fault is not None:
        fault(eng)
    if device == "cuda":
        torch.cuda.synchronize()
    parts["model_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sizes = mixes.Sizes(c["mix"], seed)
    warm_up(eng, warm_lengths(sizes), st["window"], seed, cfg["vocab_size"])
    tracer = None
    if trace:
        tracer = Tracer(seconds)
        tracer.warm(torch)
    if device == "cuda":
        torch.cuda.synchronize()
    parts["warm_s"] = time.perf_counter() - t
    return {"cell": c, "cfg": cfg, "st": st, "model": model, "eng": eng,
            "tracer": tracer, "parts": parts}


def drive(ctx: dict, seed: int, seconds: float):
    from pbench import card, loop, spec

    c, st = ctx["cell"], ctx["st"]
    kind = spec.traffic_kind(c["mix"]["kind"], harness_dir=HERE)
    traffic = kind.make(c["mix"], seed, time.perf_counter())
    with card.CardSampler() as sampler:
        lp = loop.drive(ctx["eng"], traffic, window=st["window"],
                        slots=st["slots"], seconds=seconds, seed=seed,
                        vocab=ctx["cfg"]["vocab_size"],
                        tracer=ctx["tracer"])
    return lp, sampler.stats


def free_program(ctx: dict, device: str) -> None:
    import torch

    ctx.pop("eng", None)
    ctx.pop("model", None)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def _report_loop(lp) -> None:
    from pbench import stats

    ttft = [(r.first - r.due) * 1e3 for r in lp.requests if lp.inside(r.first)]
    tpot = [(r.last - r.first) / (r.landed - 1) * 1e3 for r in lp.requests
            if lp.inside(r.done) and r.landed > 1]
    log(f"window: {lp.seconds:.3f} s, {lp.decode_steps} decode steps, "
        f"{sum(w.tokens for w in lp.windows if lp.inside(w.t1))} tokens, "
        f"{len(lp.admissions)} admission calls in the run")
    log(f"ttft_ms: median {stats.median(ttft)}, p95 {stats.pct(ttft, 0.95)}, "
        f"n {len(ttft)}; tpot_ms: median {stats.median(tpot)}, "
        f"p95 {stats.pct(tpot, 0.95)}, n {len(tpot)}")
    sizes = {}
    for a in lp.admissions:
        if lp.inside(a.t1):
            sizes[len(a.prompts)] = sizes.get(len(a.prompts), 0) + 1
    log("admission calls in the window by requests admitted: "
        + json.dumps(dict(sorted(sizes.items()))))
    log("traffic: " + json.dumps(lp.traffic))


def main(argv=None, device: str = "cuda", fault=None) -> int:
    """One run; returns the exit code. ``device`` and ``fault`` (a
    function given the engine before its warm-up captures the step
    programs, which breaks the timed path) are for the harness's own
    tests."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pbench import check, spec
    from pbench import trace as trace_mod
    from pbench.card import power_limit

    try:
        entry = spec.cell(args.workload, harness_dir=HERE)
    except spec.MissingFamily as e:
        log(f"no result: {e}")
        return 4
    chips = entry["entry"]["chips"]
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            log(f"no result: {chips} CUDA device(s) needed, "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                " present")
            return 2
        torch.cuda.set_device(0)
        log("card: " + power_limit())
    start_s = time.perf_counter() - T_START  # imports, the card's start
    ctx = prepare(entry, args.seed, device, args.seconds, bool(args.trace),
                  fault)
    ctx["parts"]["start_s"] = start_s
    lp, clocks = drive(ctx, args.seed, args.seconds)
    setup_s = lp.opened - T_START
    peak = 0
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    tracer = ctx["tracer"]
    reduced = None
    if tracer is not None:
        t = time.perf_counter()
        ev = tracer.events()
        reduced = trace_mod.reduce(ev) if ev else None
        log(f"trace: reduced in {time.perf_counter() - t:.2f} s: " + (
            json.dumps({k: v for k, v in reduced.items()
                        if k not in ("device_ops", "idle_gaps")})
            if reduced else "no device operation in the traced window"))
    ctx["tracer"] = None
    cfg, st = ctx["cfg"], ctx["st"]
    free_program(ctx, device)

    parts = ctx["parts"]
    log("setup: " + json.dumps({"setup_s": setup_s, **parts,
                                "ramp_s": setup_s - sum(parts.values())}))
    log("window clocks: " + json.dumps(clocks))
    _report_loop(lp)
    run = Run(loop=lp, work=entry["family"].Work(cfg), trace=reduced,
              peak_bytes=peak, setup_s=setup_s)
    wanted = entry["per_layer"] if args.trace else entry["end_to_end"]
    readers = spec.readers(wanted, harness_dir=HERE)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t = time.perf_counter()
    reqs = check.sample(lp.requests, args.seed, st["check"]["served_tokens"],
                        st["slots"])
    verdict = check.judge(cfg, reqs, args.seed, cfg["vocab_size"], device,
                          st["check"]["max_logit_gap"])
    log(f"reference: {time.perf_counter() - t:.2f} s over "
        f"{verdict['sampled_requests']} requests, "
        f"{verdict['served_tokens']} served tokens")

    attempted = [r for r in lp.requests
                 if r.due <= lp.closed and not (r.done and r.done <= lp.opened)]
    result = {"correct": verdict["correct"], "attempted": len(attempted),
              "failed": sum(r.failed for r in attempted), "metrics": metrics}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": chips, "memory_peak_bytes": peak}
    if args.trace and reduced:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    result["device"] = dev
    if args.trace and reduced:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = verdict["checks"]

    found = forbidden_modules()
    if found:
        log(f"no result: modules of {found} are loaded in this process")
        return 3
    for name, c in verdict["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
