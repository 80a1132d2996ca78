"""The correctness check's control, run apart from the benchmark's runs.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10

For each seed, in one process: the cell's run as ``run.py`` makes it (set
up, warm up, the loop for ``--seconds``), then over the same sample of
finished requests two verdicts of ``pbench.check.judge`` under the cell's
own limit: the program's served tokens (``correct`` true), and the
control's, the reference in the program's place with activations and the
KV cache in float8 e4m3 (``correct`` false). One JSON line a seed, each
verdict with its numbers and limits; the program's readings set a limit's
lower end, the control's its upper end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    from pbench import check, spec

    cell = spec.cell(args.workload, harness_dir=run.HERE)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = run.prepare(cell, seed, device, args.seconds, False)
        lp, _ = run.drive(ctx, seed, args.seconds)
        cfg, st = ctx["cfg"], ctx["st"]
        run.free_program(ctx, device)
        reqs = check.sample(lp.requests, seed, st["check"]["served_tokens"],
                            st["slots"])
        limit = st["check"]["max_logit_gap"]
        got = {side: check.judge(cfg, reqs, seed, cfg["vocab_size"], device,
                                 limit, control=side == "control")
               for side in ("program", "control")}
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
