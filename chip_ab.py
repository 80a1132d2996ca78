#!/usr/bin/env python3
"""Times two checkouts of the PyTorch port against each other on one card.

    python3 chip_ab.py DIR

DIR holds another checkout of the repository (for example a parent commit
unpacked with ``git archive <commit> | tar -x -C build/parent``; ``build/``
is ignored by git). Each side runs in a process of its own, in the order
DIR, this, this, DIR, and reports:

* K1 in bf16 mode (w4, the decode shapes' 0.45% sidecar) at AB_K1_ROWS,
  through the kernel the model's call at those rows takes on that side (a
  decode step of 1, 8, 12 or 16 slots: the decode tensor-core kernel on a
  side that has one, else the GEMV; a prompt or verify window of 40, 100
  or 1023 rows), and at the decode rows the GEMV beside it and the
  launch's bound (``chip_smoke.bound_ms``);
* K2 and K5 at chip_smoke.DECODE_LENS valid rows of a 2048-row cache, and
  K3 on bf16 q/k/v at chip_smoke.K3_LENS (mode "bf16" where the wrapper
  takes a mode; by the timer and the profiler, and a digest of its output
  bits, the same inputs on both sides), with causal SDPA at the eval
  stride;
* K4 (w4, the 0.45% sidecar folded in) at the five LLaMA-2-7B shapes in
  bf16 and exact mode, K11 (transposed words) at AB_K11_ROWS in bf16
  mode, and K12 (the sparse sum) on the four 0.45% sidecars at
  AB_K11_ROWS, x bf16 and f32, beside torch.sparse.mm (and, on a side
  whose K12 folds, folded as the transposed route calls it, and at 8 rows
  with x read as it is instead of copied to its interleaved layout), each
  by the timer and by the profiler's device time a launch;
* the device time of the w4 bf16 decode step of LLaMA-2-7B at a short and
  at a chip_smoke.LONG_CONTEXT-row context, of one bf16 eval stride, and
  of the bf16 decode step of a structured w4 LLaMA-2-7B with transposed
  words attached (K11 + K12);
* K6-K9 at chip_smoke.check_paged's timed case (8 slots x
  chip_smoke.PAGED_AT_ROWS valid rows, bf16, 128-row pages, W = 5) and at
  the paged serving run's contexts (PAGED_CONTEXTS), and, on a side whose
  ops.paged_attn has a CHUNK, at each of PAGED_CHUNKS positions a block;
* the device time of the paged engine's decode step at 8 slots and of one
  speculative window (LLaMA-2-7B w4, f32, chip_smoke.profile_paged_step and
  profile_spec_window), with K6's and K8's shares, and of its bf16 step at
  8 slots through K1 and with transposed words attached (K11 + K12).

Steps run eagerly on both sides (``graphs=False`` on a side whose engines
capture CUDA graphs), so the two sides' device times compare. On a side
whose engines have graphs, the decode steps, the paged steps and the
speculative window are also read graphed (under "..._graphed": host and
device time of the replayed steps).

It prints each reading with the card's name and power limit, then one JSON
line of them all. Kernel times use chip_smoke.Timer (L2 flushed, CUDA
events), device times the profiler. It calls only what both sides have.
"""

import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

import chip_smoke as cs

AB_K1_ROWS = (1, 8, 12, 16, 40, 100, 1023)
AB_K11_ROWS = (1, 8)
AB_K1_DECODE_ROWS = (1, 8, 12, 16)
# 8 slots' lengths in the paged serving run (prompts of 37-300 tokens and
# up to 32 new ones)
PAGED_CONTEXTS = (40, 64, 100, 137, 200, 300, 310, 330)
PAGED_CHUNKS = (256, 512, 1024)


def paged_ms(torch, timer, paged_attn, lengths):
    """K6-K9 (one launch, L2 flushed: Timer's reading and, under
    "k<n>_device", the profiler's device time) at 8 slots of `lengths`
    valid rows of a LLaMA-2-7B layer: bf16 activations, 128-row pages no
    two slots share, the verify windows W = 5 rows ending at each
    length."""
    res = {}
    for n in (6, 7, 8, 9):
        q8, verify = n in (7, 9), n in (8, 9)
        name = (("paged_verify_attention" if verify
                 else "paged_decode_attention") + ("_q8" if q8 else ""))
        gen = torch.Generator(device="cuda").manual_seed(20 + n)
        q, k, v, pools, pt, idx, kw = cs.paged_case(
            torch, gen, Hkv=32, ps=cs.PAGE_SIZE,
            maxp=cs.PAGED_MAX_SEQ // cs.PAGE_SIZE,
            index=[m - 5 if verify else m for m in lengths],
            W=5 if verify else None, q8=q8, dtype=torch.bfloat16,
            share=False)
        fn = getattr(paged_attn, name)
        res[f"k{n}"] = timer.ms(lambda: fn(q, k, v, *pools, pt, idx, **kw))
        res[f"k{n}_device"] = cs.flushed_device_ms(
            torch, timer, lambda: fn(q, k, v, *pools, pt, idx, **kw),
            cs.PAGED_KERNELS)
        del q, k, v, pools
    return res


def device_ms(torch, fn, n=5):
    """The profiler's device time a call of `fn`, over n calls."""
    by_name, _ = cs.device_ms_by_kernel(
        torch, lambda: [fn() for _ in range(n)])
    return None if by_name is None else sum(by_name.values()) / n


def k4_k11_ms(torch, timer, dequant_dense, lut_matmul_t):
    """K4 at the LLaMA-2-7B shapes (w4, both modes) and K11 at AB_K11_ROWS
    (bf16): {shape: {case: [timer ms, device ms]}} and the sums a forward
    (K4) and a decode step (K11, one row)."""
    from squeezellm_tpu_torch import synthetic

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    k4, k11 = {}, {}
    for name, out_f, in_f, per in cs.K4_SHAPES[:5]:
        sp = 0.0 if name == "lm_head" else 0.0045
        t = synthetic.random_quant_linear(gen, dev, out_f, in_f, 4, sp,
                                          0).tensors()
        kw = {}
        if "sp_rowptr" in t:
            kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                      vals=t["sp_vals"])
        k4[name] = {}
        for mode in ("bf16", "exact"):
            def fn():
                return dequant_dense.dequant_dense(t["qweight"], t["lut"], 4,
                                                   in_f, mode=mode, **kw)
            k4[name][mode] = [timer.ms(fn), device_ms(torch, fn), per]
        qwt = t["qweight"].t().contiguous()
        k11[name] = {}
        for M in AB_K11_ROWS:
            x = torch.randn(M, in_f, generator=gen,
                            device=dev).to(torch.bfloat16)

            def fn():
                return lut_matmul_t.lut_matmul_t(x, qwt, t["lut"],
                                                 mode="bf16")
            k11[name][M] = [timer.ms(fn), device_ms(torch, fn), per]
        del t, qwt
        torch.cuda.empty_cache()
    sums = {f"k4_forward_{mode}": [sum(k4[n][mode][i] * k4[n][mode][2]
                                       for n in k4) for i in (0, 1)]
            for mode in ("bf16", "exact")}
    sums["k11_step_1_row"] = [sum(k11[n][1][i] * k11[n][1][2] for n in k11)
                              for i in (0, 1)]
    return {"k4": k4, "k11": k11, "sums": sums}


def k12_ms(torch, timer, spmv):
    """K12 on the LLaMA-2-7B 0.45% sidecars at AB_K11_ROWS, x bf16 and f32:
    {shape: {"<M> <x dtype>": {case: [timer ms, device ms]}}} for the sum
    alone ("sum") and torch.sparse.mm on a pre-transposed x ("library");
    on a side whose spmv folds, also the fold into K11's output as the
    transposed route calls it ("fold"); and the sums a decode step (128
    launches) at each row count and dtype."""
    from squeezellm_tpu_torch import synthetic

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    folds = "y" in inspect.signature(spmv.spmv).parameters
    res, per = {}, {}
    for name, out_f, in_f, n in cs.K1_SHAPES[:4]:
        t = synthetic.random_quant_linear(gen, dev, out_f, in_f, 4, 0.0045,
                                          0).tensors()
        csr = (t["sp_rowptr"], t["sp_cols"], t["sp_vals"])
        lib = torch.sparse_csr_tensor(*csr, size=(out_f, in_f))
        per[name], res[name] = n, {}
        for M in AB_K11_ROWS:
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn(M, in_f, generator=gen, device=dev).to(dt)
                xt = x.float().t().contiguous()
                y = torch.randn(M, out_f, generator=gen, device=dev)
                y0 = (torch.randn(M, out_f, generator=gen, device=dev).to(dt)
                      if name in ("o", "down") else None)
                fns = {"sum": (lambda: spmv.spmv(x, *csr, out_f),
                               cs.K12_KERNELS),
                       "library": (lambda: torch.sparse.mm(lib, xt), None)}
                if folds:
                    fns["fold"] = (lambda: spmv.spmv(x, *csr, out_f, y=y,
                                                     y0=y0), cs.K12_KERNELS)
                case = {k: [timer.ms(fn), cs.flushed_device_ms(
                    torch, timer, fn, kernels)]
                    for k, (fn, kernels) in fns.items()}
                res[name][f"{M} {str(dt)[6:]}"] = case
        del t, csr, lib
    step = {}
    for key in res[next(iter(res))]:
        for case in res[next(iter(res))][key]:
            vals = [res[s][key][case] for s in res]
            step[f"{key} {case}"] = [
                None if any(v[i] is None for v in vals)
                else sum(v[i] * per[s] for v, s in zip(vals, res))
                for i in (0, 1)]
    return {"k12": res, "k12_step": step}


def worker(root):
    """One side: with the squeezellm_tpu_torch under `root` first on the
    path, takes every reading once and prints one JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, root)
    from squeezellm_tpu_torch import _build, data, engine, serving, synthetic
    from squeezellm_tpu_torch.models import common, fuse, registry
    from squeezellm_tpu_torch.ops import (decode_attn, dequant_dense,
                                          flash_attn, kv_quant, lut_matmul,
                                          lut_matmul_t, paged_attn,
                                          quant_linear, spmv)

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    timer = cs.Timer(torch)
    dev = torch.device("cuda")
    out = {"root": root, "k1": {}, "k1_gemv": {}, "k1_bound": {}, "k2": {},
           "k5": {}, "k3": {}, "k3_device": {}, "k3_sha": {}}
    # a decode step passes decode=True where the port has it (the decode
    # tensor-core kernel where the port has one, else the GEMV, at any slot
    # count); elsewhere the wrapper's plan picks by the rows
    call_site = "decode" in inspect.signature(
        quant_linear.quant_linear_apply).parameters
    decode_kernel = "dec" if "dec" in lut_matmul.VARIANTS else "gemv"
    gen = torch.Generator(device=dev).manual_seed(19)
    for name, out_f, in_f, _ in cs.K1_SHAPES:
        sp = 0.0 if name == "lm_head" else 0.0045
        t = synthetic.random_quant_linear(gen, dev, out_f, in_f, 4, sp,
                                          0).tensors()
        kw = {}
        if "sp_rowptr" in t:
            kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                      vals=t["sp_vals"])
        out["k1"][name], out["k1_gemv"][name] = {}, {}
        out["k1_bound"][name] = {}
        nnz = t["sp_vals"].numel() if kw else 0
        for M in AB_K1_ROWS:
            x = torch.randn(M, in_f, generator=gen,
                            device=dev).to(torch.bfloat16)
            decode = call_site and M in AB_K1_DECODE_ROWS
            variant = decode_kernel if decode else None
            out["k1"][name][M] = timer.ms(lambda: lut_matmul.lut_matmul(
                x, t["qweight"], t["lut"], 4, mode="bf16", variant=variant,
                **kw))
            if decode:
                out["k1_gemv"][name][M] = timer.ms(
                    lambda: lut_matmul.lut_matmul(
                        x, t["qweight"], t["lut"], 4, mode="bf16",
                        variant="gemv", **kw))
                nbytes = (t["qweight"].numel() * 4 + t["lut"].numel() * 4
                          + x.numel() * 2 + M * out_f * 4
                          + (nnz * 8 + (out_f + 1) * 4 if nnz else 0))
                out["k1_bound"][name][M] = cs.bound_ms(nbytes, [
                    (2 * M * in_f * out_f, "bf16"), (2 * M * nnz, "f32")])[0]
        del t

    out.update(k4_k11_ms(torch, timer, dequant_dense, lut_matmul_t))
    out.update(k12_ms(torch, timer, spmv))

    gen = torch.Generator(device=dev).manual_seed(12)
    B, H, hd, S = 1, 32, 128, 2048
    for n in cs.DECODE_LENS:
        qkv = torch.randn(B, 3 * H * hd, generator=gen,
                          device=dev).to(torch.bfloat16)
        q, k, v = (qkv[:, i * H * hd: (i + 1) * H * hd].view(B, H, hd)
                   for i in range(3))
        lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
        cos, sin = common.rope_cos_sin(lengths.long() - 1, hd, 10000.0,
                                       torch.bfloat16)
        kw = dict(rope_cos=cos.float().contiguous(),
                  rope_sin=sin.float().contiguous())
        cache = torch.randn(2, B, S, H * hd, generator=gen,
                            device=dev).to(torch.bfloat16)
        codes, scales = kv_quant.quantize_rows(
            torch.randn(2, B, S, H, hd, generator=gen, device=dev))
        codes = codes.reshape(2, B, S, H * hd)
        scales = scales[..., 0].transpose(2, 3).contiguous()
        out["k2"][n] = timer.ms(lambda: decode_attn.decode_attention(
            q, k, v, cache[0], cache[1], lengths, **kw))
        out["k5"][n] = timer.ms(lambda: decode_attn.decode_attention_q8(
            q, k, v, codes[0], codes[1], scales[0], scales[1], lengths,
            **kw))
    has_mode = "mode" in inspect.signature(
        flash_attn.flash_attention).parameters
    for sq in cs.K3_LENS:
        q = torch.randn(1, sq, H, hd, generator=gen,
                        device=dev).to(torch.bfloat16).transpose(1, 2)
        cache = {c: torch.randn(1, 4096, H * hd, generator=gen,
                                device=dev).to(torch.bfloat16)
                 for c in ("k", "v")}
        k, v = common.read_kv(cache, torch.bfloat16, H)
        kw = {"mode": "bf16"} if has_mode else {}
        out["k3"][sq] = timer.ms(lambda: flash_attn.flash_attention(
            q, k, v, 0, **kw))
        out["k3_device"][sq] = cs.flushed_device_ms(
            torch, timer, lambda: flash_attn.flash_attention(q, k, v, 0,
                                                             **kw),
            ("flash_attn",))
        # the same inputs on both sides (this file's draws): equal digests
        # mean the two trees' K3 give the same bits
        out["k3_sha"][sq] = hashlib.sha256(flash_attn.flash_attention(
            q, k, v, 0, **kw).cpu().numpy().tobytes()).hexdigest()[:16]
        if sq == cs.K3_LENS[-1]:
            qc, kc, vc = (t[:, :, :sq].contiguous() for t in (q, k, v))
            out["k3_causal_sdpa_ms"] = timer.ms(
                lambda: F.scaled_dot_product_attention(qc, kc, vc,
                                                       is_causal=True))

    _, config = registry.load_config(os.path.join(root, "models",
                                                  "llama-2-7b"))
    model = fuse.fuse_for_decode(synthetic.quantized_llama(config, 4,
                                                           seed=4))
    # eager steps on both sides; a side with graphs also reads them graphed
    has_graphs = "graphs" in inspect.signature(engine.Engine).parameters
    eager = {"graphs": False} if has_graphs else {}
    variants = (("", eager), ("_graphed", {})) if has_graphs else (("", {}),)
    bkw = dict(dtype=torch.bfloat16, cache_dtype=torch.bfloat16, mode="bf16")
    eng = engine.Engine(model, **bkw, **eager)
    ids = (np.arange(cs.BENCH_TOKENS, dtype=np.int64)[None] * 7919
           % config.vocab_size)
    with torch.no_grad():
        for sfx, gkw in variants:
            e = engine.Engine(model, **bkw, **gkw)
            out["decode" + sfx] = cs.profile_decode(torch, e, ids)
            out["decode_long" + sfx] = cs.profile_decode(
                torch, e, ids, start=cs.LONG_CONTEXT)
            del e
        tokens = data.synthetic_tokens(config.vocab_size, cs.EVAL_SEQLEN,
                                       seed=17)
        with cs.CardSampler() as card:
            out["eval_bf16"] = cs.profile_eval_stride(torch, model, tokens,
                                                      "bf16", torch.bfloat16)
        out["eval_bf16"]["card"] = card.stats
        # the same decode step through K11 + K12: a structured w4 model
        # with transposed words attached (chip_smoke.run_structured)
        tmodel = fuse.attach_decode_luts(fuse.fuse_for_decode(
            synthetic.quantized_llama(config, 4, seed=10, structured=True)),
            transposed=True)
        for sfx, gkw in variants:
            out["decode_transposed" + sfx] = cs.profile_decode(
                torch, engine.Engine(tmodel, **bkw, **gkw), ids)
        del tmodel
        torch.cuda.empty_cache()

        at = {"timed": [cs.PAGED_AT_ROWS] * cs.PAGED_SLOTS,
              "serving": list(PAGED_CONTEXTS)}
        out["paged"] = {c: paged_ms(torch, timer, paged_attn, lens)
                        for c, lens in at.items()}
        if hasattr(paged_attn, "CHUNK"):
            default = paged_attn.CHUNK
            out["paged_by_chunk"] = {}
            for chunk in PAGED_CHUNKS:
                paged_attn.CHUNK = chunk
                out["paged_by_chunk"][chunk] = {
                    c: paged_ms(torch, timer, paged_attn, lens)
                    for c, lens in at.items()}
            paged_attn.CHUNK = default

        def paged_engine(**kw):
            kw.setdefault("cache_dtype", torch.float32)
            return serving.PagedContinuousBatchEngine(
                model, slots=cs.PAGED_SLOTS, n_pages=cs.PAGED_PAGES,
                page_size=cs.PAGE_SIZE, max_seq=cs.PAGED_MAX_SEQ, **kw)

        prompts = cs.paged_requests(config)
        for sfx, gkw in variants:
            out["paged_step" + sfx] = cs.profile_paged_step(
                torch, paged_engine(**gkw), prompts)
            out["spec_window" + sfx] = cs.profile_spec_window(
                torch, paged_engine(speculative=cs.SPECULATIVE, **gkw),
                prompts)
            out["paged_step_bf16" + sfx] = cs.profile_paged_step(
                torch, paged_engine(**bkw, **gkw), prompts)
        fuse.attach_decode_luts(model, transposed=True)
        for sfx, gkw in variants:
            out["paged_step_bf16_transposed" + sfx] = cs.profile_paged_step(
                torch, paged_engine(**bkw, **gkw), prompts)
    print(json.dumps(out))
    return 0


def host_device(prof):
    """(host ms, device ms) of a decode, paged step or window profile."""
    host = prof.get("host_ms_per_step", prof.get(
        "step_ms", prof.get("host_ms_per_window")))
    return host, prof.get("device_ms_per_step",
                          prof.get("device_ms_per_window"))


def main(other):
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(f"card: {smi}")
    runs = []
    for label, root in (("other", other), ("this", cs.HERE),
                        ("this", cs.HERE), ("other", other)):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", os.path.abspath(root)],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-6000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        r["label"], r["seconds"] = label, time.perf_counter() - t0
        runs.append(r)
        dec, long_, ev = r["decode"], r["decode_long"], r["eval_bf16"]
        tdec = r["decode_transposed"]
        print(f"{label} ({r['root']}, {r['seconds']:.0f} s): K4 [timer ms, "
              f"device ms, launches] {r['k4']}, K11 {r['k11']}, sums "
              f"[timer, device] {r['sums']}; transposed decode step device "
              f"ms {tdec.get('device_ms_per_step')} (by kernel "
              f"{tdec.get('ms_per_step_by_kernel')}, device launches a step "
              f"{tdec.get('launches_per_step')}) [{smi}]")
        print(f"{label} ({r['root']}): K12 [timer ms, device ms] "
              f"{r['k12']}; a decode step's 128 launches {r['k12_step']} "
              f"[{smi}]")
        for k in ("paged_step_bf16", "paged_step_bf16_transposed"):
            p = r[k]
            print(f"{label} ({r['root']}): {k} device ms "
                  f"{p.get('device_ms_per_step')} (by kernel "
                  f"{p.get('ms_per_step_by_kernel')}, device launches a step "
                  f"{p.get('launches_per_step')}), host ms {p['step_ms']}, "
                  f"idle share {p.get('idle_share')} [{smi}]")
        for k in [k for k in r if k.endswith("_graphed")]:
            (gh, gd), (eh, ed) = host_device(r[k]), host_device(r[k[:-8]])
            print(f"{label} ({r['root']}): {k[:-8]} host ms / device ms: "
                  f"graphed {gh} / {gd} (idle share "
                  f"{r[k].get('idle_share')}, profile failed: "
                  f"{r[k].get('profile_failed')}), eager {eh} / {ed} "
                  f"[{smi}]")
        print(f"{label} ({r['root']}): K1 at the decode rows, the model's "
              f"kernel / the GEMV / the bound, ms: " + "; ".join(
                  f"{n} M={m}: {r['k1'][n][m]:.4f} / {g:.4f} / "
                  f"{r['k1_bound'][n][m]:.4f}"
                  for n, by in r["k1_gemv"].items() for m, g in by.items())
              + f" [{smi}]")
        print(f"{label} ({r['root']}, {r['seconds']:.0f} s): K1 ms {r['k1']} "
              f"K2 ms {r['k2']} K5 ms {r['k5']} K3 ms {r['k3']} (causal "
              f"sdpa at {cs.K3_LENS[-1]}: {r['k3_causal_sdpa_ms']:.4f}); "
              f"decode step device ms {dec.get('device_ms_per_step')} (K2 "
              f"{dec.get('k2_k5_ms_per_step')}), at {cs.LONG_CONTEXT} rows "
              f"{long_.get('device_ms_per_step')} (K2 "
              f"{long_.get('k2_k5_ms_per_step')}); bf16 eval stride device "
              f"ms {ev.get('device_ms')} {ev.get('parts_ms')} "
              f"(card {ev.get('card')}); K6-K9 ms {r['paged']} (by chunk "
              f"{r.get('paged_by_chunk')}); paged step device ms "
              f"{r['paged_step'].get('device_ms_per_step')} (K6 "
              f"{r['paged_step'].get('paged_attn_ms_per_step')}), "
              f"speculative window device ms "
              f"{r['spec_window'].get('device_ms_per_window')} (K8 "
              f"{r['spec_window'].get('paged_attn_ms_per_window')}) [{smi}]")
    same = len({json.dumps(r["k3_sha"], sort_keys=True) for r in runs}) == 1
    print(f"K3 device ms a launch (bf16 q/k/v, L2 flushed) by side: "
          + "; ".join(f"{r['label']} {r['k3_device']}" for r in runs)
          + f"; K3's output bits equal on every side: {same} [{smi}]")
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.exit(worker(sys.argv[2]))
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
