"""A short look at tensor parallelism on the card, before the whole smoke
run: two ranks sharing card 0 over gloo (as ``chip_smoke.run_tp`` runs
them) all-reduce f32, bf16 and f16 CUDA tensors and all-gather one, and
time an (8, 4096) f32 all-reduce; then K1 at the tp=2 local shapes
against its plain version (``chip_smoke.check_k1``), and ``run_tp`` at
``TP_LAYERS`` layers (default 2).

Run from the repository root on a machine with a card:

    python3 scripts/tp_probe.py          # TP_LAYERS=8 for the smoke's depth
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def probe(rank):
    """One rank: which dtypes gloo reduces on CUDA tensors, whether it
    gathers them, and an all-reduce's time."""
    import torch.distributed as dist

    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        t = torch.full((1000,), 1.0 + rank * 2**-8, dtype=dt, device="cuda")
        try:
            dist.all_reduce(t)
            out[str(dt)] = float(t[0])
        except RuntimeError as e:
            out[str(dt)] = f"{type(e).__name__}: {str(e)[:200]}"
    try:
        o = torch.empty(2000, device="cuda")
        dist.all_gather_into_tensor(o, torch.ones(1000, device="cuda"))
        out["all_gather_into_tensor"] = "ok"
    except RuntimeError as e:
        out["all_gather_into_tensor"] = f"{type(e).__name__}: {str(e)[:200]}"
    x = torch.randn(8, 4096, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    out["all_reduce_8x4096_f32_ms"] = (time.perf_counter() - t0) / 50 * 1e3
    return out


def main():
    from squeezellm_tpu_torch import _build
    from squeezellm_tpu_torch.models import registry
    from squeezellm_tpu_torch.parallel import multihost

    if not torch.cuda.is_available():
        print("tp_probe: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    print(f"built {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(multihost.launch(probe, 2, device="cuda",
                                      join_timeout_s=120)), flush=True)
    smi = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"])
    record = {"paths": [], "k1_bf16_flips": [], "failed": []}
    cs.check_k1(torch, cs.Timer(torch), record, cs.K1_TP_SHAPES,
                cs.K1_TP_ROWS, "k1_tp2_detail", "k1_tp2_per_decode_step",
                "K1 tp=2")
    _, config = registry.load_config(os.path.join(ROOT, "models",
                                                  "llama-2-7b"))
    cs.TP_LAYERS = int(os.environ.get("TP_LAYERS", 2))
    t0 = time.perf_counter()
    cs.run_tp(torch, config, record, smi)
    print(f"[run_tp: {time.perf_counter() - t0:.1f} s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
