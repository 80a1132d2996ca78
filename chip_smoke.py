#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (squeezellm_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ with nvcc, holds each kernel
(K1-K12) against its plain PyTorch version at the main path's shapes, and
drives the port's paths on random full-width models made from a seed,
checking after each that it went through its kernels:

* Engine.generate and Engine.benchmark on LLaMA-2-7B, w4 and w3 with a
  0.45% sparse sidecar, top-X 10 and a quantized lm_head (K1, K2, K3), the
  w4 bf16 decode step profiled at a short and at a 2048-row context (K2's
  row split), and the bf16 dense model of the same config;
* eval.perplexity on the same two models over 4 strides of 2048 synthetic
  tokens, 2 strides a forward (K4 and K3: f32 FMAs in f32, the tensor cores
  in bf16), f32 and bf16;
* Engine(cache_dtype="int8") on the w4 model: a request and the decode
  benchmark beside the bf16-cache one (K5);
* OPT-6.7B w4: one eval group and one greedy request (K2 without rope);
* serving.PagedContinuousBatchEngine on a w4 model of SERVE_LAYERS layers
  (16 of 32), 8 slots over a pool
  of 160 pages of 128 rows: 16 requests with a shared 256-token prefix
  through run() by single steps, decode windows, prompt-lookup speculation
  and sampling (K6, K8, K3 with a start), sampled in bf16 and admitted in
  reverse order (a request's tokens do not depend on its cohort), then the
  bf16 and int8 pools (K7, K9), then with transposed words attached: eight
  f32 requests against the plain path and the bf16 step profiled (K11,
  K12);
* serving.ContinuousBatchEngine on a w4 model of SERVE_LAYERS layers, 8
  slots of a 512-row dense
  cache, the same 16 requests: f32 greedy by steps, windows, speculation
  and the plain path (K1, K2, K3; K4 where six 300-token prompts are
  admitted together), bf16 sampled admitted in reverse, the int8 cache
  (K5), one bf16 decode step at 8 slots held to 4L+1 K1 (GEMV) and L K2
  launches, the step's host and device time beside the paged engine's;
  then server.serve over the bf16 engine answering eight concurrent HTTP
  completions (greedy answers held to a fresh engine's run()), and the
  serve-bench command, dense and --paged;
* offline quantization on the card: a dense LLaMA-2-7B at full width
  (QUANT_LAYERS deep), Fisher gradients, quantize_model w4 structured and
  w3 free (its first W3_LAYERS layers: the host's k-means) with a 0.45%
  sidecar and a quantized lm_head, save_quantized,
  load_quantized, fuse, one request each against the plain path (K10, K1);
* the reference's packed checkpoints: reference-format state dicts of
  LLaMA-2-7B at full width (w3 at CONVERT_LAYERS[3] layers, w4 at
  CONVERT_LAYERS[4]; 3-bit codes spilling across words, a 0.45% CSR
  sidecar, top-X 10, fp16 embeddings, norms and lm_head) made on the card,
  torch.save'd and run through convert.convert_reference_checkpoint:
  K4's W of every converted linear bit-equal to the reference's own
  dequantization, then an f32 request against the plain path (K1, K2, K3);
* the staged workflow on a dense LLaMA-2-7B at full width (STAGED_LAYERS
  layers, written as an HF directory): chunk -> outlier-config -> nuq ->
  pack, nuq resumed, the packed arrays equal to quantize_model's, an f32
  request against the plain path (K1, K2, K3);
* a structured w4 LLaMA-2-7B at full depth: a request and the bf16 decode
  benchmark through K10, the benchmark again with the structured table
  withheld (K1), then with transposed words attached (K11 and K12);
* tensor parallelism (``run_tp``): two ranks, one process each
  (``parallel.multihost.launch``), sharing card 0 over gloo (steps eager)
  serve LLaMA-2-7B w4 at full width and TP_LAYERS layers through
  TPContinuousBatchEngine (f32 greedy against the TP plain path, bf16
  sampled) and TPPagedContinuousBatchEngine (f32 and int8 pools, steps and
  speculation: K6-K9); every rank's tokens equal, the f32 teacher-forced
  logits held to the single-device engine's, each path's launches held to
  its model calls, and each rank's bf16 decode step at 8 slots: its
  launches and collectives, host and device time and the collectives'
  share. K1 is also held and timed at the tp=2 local shapes.

Every per-token step of Engine and of the paged engine runs as a CUDA
graph captured once and replayed (``squeezellm_tpu_torch/graphs.py``); the
launch counts include the replays. Beside that, each path named below is
run again with ``graphs=False`` in the same process and held to the same
tokens: the w4 and w3 greedy requests, a sampled w4 bf16 request, the
int8-cache request, the OPT request, the paged f32 run, the paged bf16
sampled run admitted in reverse, and the dense-slot f32 steps,
speculation and bf16 sampled run. Speculation at full width (w4, f32):
``generate_speculative`` and ``generate_draft_speculative`` with
``truncate_for_draft(model, 4)``, device and host loops, each
token-identical to greedy ``generate`` (the bf16 share reported, also
with the verify windows on K1's tensor-core kernel), and a self-draft's
acceptance. Host and device time, eager and graphed, side by
side: the w4 bf16 decode step at both contexts, the paged step at 8 slots
(f32, bf16, bf16 with transposed words) and the paged speculative window.

The last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``; the line before it
has the card's name and power limit, and the one before that the kernels'
record as JSON. A failing phase makes it exit non-zero without that line.
Details go to build/chip_smoke.json.
"""

import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
# Peak rate by the type of a product's operands (H100 SXM data sheet,
# dense): bf16 x bf16 with f32 accumulation on the tensor cores; f32 (or an
# f32 operand) outside them.
PEAK_FLOP_S = {"bf16": 989e12, "f32": 67e12}
TOL_K1 = {"exact": 1e-5, "bf16": 1e-4}  # max |dy| / max |y|
TOL_ATTN = 1e-4  # max |dout| / max |out|
# K3's bf16 regime (tensor cores) against its plain version's f32 products
# of the same bf16 inputs, max |dout| / max |v|: p is rounded to bf16
# before p.v, at most 2**-9 relative a weight, and the weights of a row sum
# to 1, so the output moves by at most 2**-9 of max |v|; twice that
TOL_ATTN_BF16 = 2.0**-8
TOL_TF_EXACT = 1e-4  # teacher-forced logits, f32 model, kernels vs plain
# The bf16 model one layer at a time (layer_check), kernels vs plain, max
# |d| / max |out|: two bf16 steps at the top of the output's range. A
# layer's output is rounded to bf16 twice on its way (the o projection's
# residual sum, then the down projection's), and the kernels sum in
# another f32 order than the plain versions, so one element can land one
# bf16 step away at each rounding; one step is at most 2**-7 of max |out|.
TOL_LAYER_BF16 = 2.0**-6
K1_SHAPES = (("qkv", 12288, 4096, 32), ("o", 4096, 4096, 32),
             ("gateup", 22016, 4096, 32), ("down", 4096, 11008, 32),
             ("lm_head", 32000, 4096, 1))  # (name, out, in, per step)
PROMPT_LENS = (7, 16, 100)
K3_LENS = PROMPT_LENS + (2048,)  # and the eval stride
# decode, 8 slots, 16 rows, a verify window of 5 x 8 slots, a prompt
K1_ROWS = (1, 8, 16, 40, 100)
K10_ROWS = K1_ROWS
# the rows a decode step gives K1 (one token a slot: the GEMV in bf16
# mode, as the model asks, as it does for a verify window of up to 16
# rows); the others are prompts and the 40-row verify window of 8 slots
# (the tensor-core kernel in bf16 mode)
K1_DECODE_ROWS = (1, 8, 16)
# bf16 mode: both K1 kernels (GEMV, tensor cores) are timed at these rows
# to place their crossover
CROSS_ROWS = (8, 12, 16, 17, 24, 32, 40)
# K2 and K5: valid rows of a 2048-row cache; the decode profile at a long
# context starts here
DECODE_LENS = (1, 128, 1000, 2048)
LONG_CONTEXT = 2040
K11_ROWS = (1, 8)  # the transposed route takes at most 8 rows
K12_ROWS = (1, 8, 40, 100)
# device kernels by name in a profiler trace: K12's (its sum, and the copy
# of x it makes first at more than one row) and K6-K9's (one template)
K12_KERNELS = ("spmv",)
PAGED_KERNELS = ("paged_attn_kernel",)
# offline quantization: a dense LLaMA-2-7B at full width and depth (Fisher
# keeps the f32 weights and the grad^2 sums of every layer on the card, ~54
# GB), calibrated on FISHER_SAMPLES synthetic windows of FISHER_SEQLEN
# tokens. The w3 run, whose free codebooks go through the host's k-means
# solver (the default, as in the JAX package: ~5 s a layer on the card
# machine's 8 cores), quantizes the first W3_LAYERS layers of the same tree
# and the lm_head, so the whole run stays well inside its time limit
QUANT_LAYERS, FISHER_SAMPLES, FISHER_SEQLEN = 32, 4, 512
W3_LAYERS = 8
# the reference's packed checkpoints (convert): LLaMA-2-7B at full width,
# w3 and w4 at these depths (cut for the run's time limit, as W3_LAYERS),
# a REF_SPARSITY CSR sidecar and REF_TOPX top-X channels a linear
CONVERT_LAYERS = {3: 8, 4: 2}
REF_SPARSITY, REF_TOPX = 0.0045, 10
# the staged workflow (chunk -> outlier-config -> nuq -> pack): a dense
# LLaMA-2-7B at full width and STAGED_LAYERS layers (~0.8 GB of f32 chunks
# a layer), outliers at IQR range STAGED_RANGE
STAGED_LAYERS, STAGED_RANGE = 2, 1.8
NEW_TOKENS = 32
BENCH_TOKENS = 128
# K4: W against the plain version's. Exact mode: equal. bf16 mode: equal,
# or one bf16 step apart where the fold's add lands on a rounding tie the
# two sides could break differently (none expected: both add in f32 and
# round to nearest even); the count of differing elements is printed.
# y = x @ W + y0 at EVAL_SEQLEN rows against the plain K4 route within
# TOL_K1. Against K1's plain version (`lut_matmul_plain`) exact mode is
# held to TOL_K1 too; bf16 mode is held to TOL_K4_SEAM only: in this row
# band the sidecar meets the bf16-rounded x and is rounded into the bf16 W
# (as in the JAX package), while K1 reads x unrounded and keeps the
# sidecar in f32, so the two differ by a few bf16 steps of the sparse part.
TOL_K4_SEAM = 2e-3
K4_SHAPES = (("qkv", 12288, 4096, 32), ("o", 4096, 4096, 32),
             ("gateup", 22016, 4096, 32), ("down", 4096, 11008, 32),
             ("lm_head", 32000, 4096, 1), ("opt_up", 16384, 4096, 32),
             ("opt_down", 4096, 16384, 32))  # (name, out, in, per forward)
EVAL_SEQLEN = 2048
EVAL_STRIDES = 4
EVAL_GROUP = 2
TOL_PPL = 1e-4  # f32 perplexity, kernels vs plain, relative
INT8_PROMPT = 100
# The int8-cache model, kernels vs plain. The two paths' linears differ by
# ~1e-6 (another summation order), which moves a k or v element across an
# int8 rounding boundary about once in 1e4 elements; each flipped code is
# one step of max|row|/127 in one cache element, and the 32 random layers
# amplify the flips (as they do bf16's, see TOL_LAYER_BF16). So the model
# is held one layer at a time, every layer fed the plain path's input and
# cache: kernels vs plain within one int8 step, 2**-7 of max |out|. The
# request's full-depth logit distance and the count of leading tokens that
# equal the plain path's are reported, not held.
TOL_LAYER_INT8 = 2.0**-7
OPT_PROMPT = 16
# paged serving: 16 requests of three prompt lengths, eight of them a shared
# 256-token prefix (two full pages) and a 44-token suffix of their own
PAGED_SLOTS, PAGED_PAGES, PAGE_SIZE, PAGED_MAX_SEQ = 8, 160, 128, 2048
PAGED_PREFIX, PAGED_SUFFIX, PAGED_LENS = 256, 44, (100, 37)
SPECULATIVE = (4, 2)
# the sampled requests: temperature, top-k, top-p and the seed
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95, seed=5)
# full-width speculation (w4, f32): a prompt of SPEC_PROMPT tokens, a cache
# of SPEC_MAX_SEQ rows, the early-exit draft's layers
SPEC_PROMPT, SPEC_MAX_SEQ, DRAFT_LAYERS = 64, 256, 4
TRANSPOSED_NEW = 4  # new tokens a request with transposed words attached
# K6-K9 are timed at 8 slots x 1024 valid rows of a LLaMA-2-7B layer
PAGED_AT_ROWS = 1024
# dense-slot serving: the paged phase's 16 requests over PAGED_SLOTS slots
# of a DENSE_MAX_SEQ-row dense cache. The HTTP sub-phase's eight prompts
# have SERVE_LENS tokens: each admission stays below 1024 rows, so K1
# serves every prefill (from 1024 rows K4 and a library GEMM take over,
# whose rounding differs)
DENSE_MAX_SEQ = 512
SERVE_LENS = (16, 23, 37, 50, 64, 77, 90, 100)
# tensor parallel: TP ranks, one process each, sharing card 0 over gloo,
# serve LLaMA-2-7B w4 at full width and TP_LAYERS layers (the depth cut for
# the run's time limit), TP_NEW new tokens a request of the paged phase's
# 16; K1 is also held at the tp=2 local shapes (out, in; launches a rank's
# decode step at full depth)
TP, TP_LAYERS, TP_NEW, TP_SEED = 2, 8, 16, 13
# the paged and dense-slot serving phases: LLaMA-2-7B at full width and
# this depth, cut from 32 for the run's time limit (each of their runs
# costs the same per layer)
SERVE_LAYERS = 16
K1_TP_SHAPES = (("qkv/2", 6144, 4096, 32), ("o/2", 4096, 2048, 32),
                ("gateup/2", 11008, 4096, 32), ("down/2", 4096, 5504, 32),
                ("lm_head/2", 16000, 4096, 1))
K1_TP_ROWS = (1, 8)


def sh(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


class CardSampler:
    """Samples the card's SM clock, power draw and temperature with
    nvidia-smi every 100 ms while a block runs; ``stats`` then holds their
    medians and extremes (empty when nvidia-smi gave nothing). The compute-
    bound phases depend on the clock the card sustains, so their times are
    printed with it."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __enter__(self):
        self.stats = {}
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        if rows:
            clock, power, temp = (sorted(c) for c in zip(*rows))
            self.stats = {"samples": len(rows),
                          "sm_mhz_median": clock[len(clock) // 2],
                          "sm_mhz_min": clock[0], "power_w_max": power[-1],
                          "temp_c_max": temp[-1]}
        return False


class Timer:
    """Median time of one launch with the L2 flushed before each, as a
    decode step finds its weights (CUDA events around each launch)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device="cuda")  # 256 MB > 50 MB L2

    def ms(self, fn, iters=10, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def bound_ms(nbytes, ops):
    """The least time for the work: bytes over the HBM rate, or the
    operations, each ``(count, operand type)`` over its peak rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(n / PEAK_FLOP_S[kind] for n, kind in ops) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rel_err(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def abs_err(a, b):
    return float((a.float() - b.float()).abs().max())


def hold_equal(label, got, want):
    """Tokens (arrays, lists of arrays or dicts of lists) equal, or raise
    naming the first difference."""
    import numpy as np

    if isinstance(got, dict):
        bad = [r for r in want if got.get(r) != want[r]]
        if sorted(got) != sorted(want) or bad:
            raise AssertionError(f"{label}: requests {bad} differ: "
                                 f"{[(got.get(r), want[r]) for r in bad[:2]]}")
        return
    pairs = (zip(got, want) if isinstance(got, (list, tuple))
             else [(got, want)])
    for i, (a, b) in enumerate(pairs):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: case {i}: {a} != {b}")


def print_host_device(label, cases, record):
    """One line: each case's host ms, device ms and idle share (a profile
    of profile_decode, profile_paged_step or profile_spec_window)."""
    parts = []
    for name, prof in cases:
        host = prof.get("host_ms_per_step", prof.get(
            "step_ms", prof.get("host_ms_per_window")))
        dev = prof.get("device_ms_per_step",
                       prof.get("device_ms_per_window"))
        if prof.get("profile_failed"):
            record["profile_failed"].append(f"{label} {name}")
            parts.append(f"{name}: host {host:.3f} ms, device not measured "
                         f"({prof['profile_failed']})")
        else:
            parts.append(f"{name}: host {host:.3f} ms, device {dev:.3f} ms, "
                         f"idle share {prof['idle_share']:.3f}")
    print(f"{label}, host against device: " + "; ".join(parts))


def check_k1(torch, timer, record, shapes=K1_SHAPES, rows=K1_ROWS,
             key="k1_detail", step_key="k1_per_decode_step", label="K1"):
    """K1 against its plain version at ``shapes`` and ``rows`` (both
    modes, w4 and w3), timed beside the plain version and the library's
    matmul; the cases go to record[key], the per-decode-step sums at 1 and
    8 rows to record[step_key]."""
    record.setdefault(key, [])
    record[step_key] = []
    from squeezellm_tpu_torch import synthetic
    from squeezellm_tpu_torch.ops import lut_matmul, plain_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    worst, worst_rel = 0.0, {"exact": 0.0, "bf16": 0.0}
    for name, out_f, in_f, per_step in shapes:
        for bits in (4, 3):
            sp = 0.0 if name == "lm_head" else 0.0045
            t = synthetic.random_quant_linear(gen, dev, out_f, in_f, bits, sp,
                                        0).tensors()
            kw = {}
            if "sp_rowptr" in t:
                kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                          vals=t["sp_vals"])
            nnz = t["sp_vals"].numel() if kw else 0
            # the library yardstick: one matmul on the pre-dequantized
            # weight, in the mode's operand type
            w32 = plain_ops.dequantize(t["qweight"], t["lut"], bits, in_f)
            lib_w = {"exact": w32, "bf16": w32.to(torch.bfloat16)}
            for M in rows:
                for mode in ("exact", "bf16"):
                    dt = torch.bfloat16 if mode == "bf16" else torch.float32
                    x = torch.randn(M, in_f, generator=gen, device=dev).to(dt)
                    y0 = torch.randn(M, out_f, generator=gen,
                                     device=dev).to(dt)
                    args = (x, t["qweight"], t["lut"], bits)
                    # the kernel the model's call at these rows takes
                    kw["variant"] = "gemv" if M in K1_DECODE_ROWS else None
                    got = lut_matmul.lut_matmul(*args, y0=y0, mode=mode, **kw)
                    again = lut_matmul.lut_matmul(*args, y0=y0, mode=mode,
                                                  **kw)
                    plain_kw = {k: v for k, v in kw.items()
                                if k != "variant"}
                    want = lut_matmul.lut_matmul_plain(*args, y0=y0,
                                                       mode=mode, **plain_kw)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(
                            f"K1 {name} w{bits} M={M} {mode}: two launches "
                            f"differ")
                    err = rel_err(got, want)
                    worst = max(worst, abs_err(got, want))
                    worst_rel[mode] = max(worst_rel[mode], err)
                    if mode == "bf16":  # outputs that round to another bf16
                        flips = int((got.to(torch.bfloat16)
                                     != want.to(torch.bfloat16)).sum())
                        record["k1_bf16_flips"].append(
                            [name, bits, M, flips, got.numel()])
                    if err > TOL_K1[mode]:
                        raise AssertionError(
                            f"K1 {name} w{bits} M={M} {mode}: rel err {err}")
                    # time kernel, plain and library; the dense products
                    # are bf16 x bf16 in bf16 mode, f32 in exact mode, the
                    # sparse fold f32 in both
                    nbytes = (t["qweight"].numel() * 4 + t["lut"].numel() * 4
                              + x.numel() * x.element_size()
                              + y0.numel() * y0.element_size()
                              + got.numel() * 4
                              + (nnz * 8 + (out_f + 1) * 4 if nnz else 0))
                    b, by = bound_ms(nbytes, [
                        (2 * M * in_f * out_f,
                         "bf16" if mode == "bf16" else "f32"),
                        (2 * M * nnz, "f32")])
                    w = lib_w[mode]
                    row = dict(
                        shape=name, bits=bits, M=M, mode=mode, out=out_f,
                        inp=in_f, launches_per_step=per_step, rel_err=err,
                        ms=timer.ms(lambda: lut_matmul.lut_matmul(
                            *args, y0=y0, mode=mode, **kw)),
                        plain_ms=timer.ms(lambda: lut_matmul.lut_matmul_plain(
                            *args, y0=y0, mode=mode, **plain_kw), iters=5),
                        library_ms=timer.ms(lambda: torch.matmul(x, w)),
                        bound_ms=b, bound_by=by, bytes=nbytes,
                        variant=lut_matmul.plan(M, in_f, out_f, bits, mode,
                                                kw["variant"]).variant)
                    row["gb_s"] = nbytes / row["ms"] / 1e6
                    if M == 1 and nnz:  # the same launch, sidecar withheld
                        bare = lut_matmul.lut_matmul(*args, y0=y0, mode=mode,
                                                     variant="gemv")
                        want = lut_matmul.lut_matmul_plain(*args, y0=y0,
                                                           mode=mode)
                        if rel_err(bare, want) > TOL_K1[mode]:
                            raise AssertionError(f"K1 {name} w{bits} {mode} "
                                                 f"without its sidecar")
                        row["ms_no_sidecar"] = timer.ms(
                            lambda: lut_matmul.lut_matmul(*args, y0=y0,
                                                          mode=mode,
                                                          variant="gemv"))
                    record[key].append(row)
            del t, w32, lib_w
    print(f"  {label} ms (bound by b=bytes/o=operations, plain, library "
          f"matmul)")
    for r in record[key]:
        if r["mode"] == "exact":
            continue
        e = next(q for q in record[key] if q["mode"] == "exact"
                 and all(q[k] == r[k] for k in ("shape", "bits", "M")))
        print(f"  {label} {r['shape']:8s} w{r['bits']} M={r['M']:3d} "
              + "  ".join(
            f"{q['mode']} {q['ms']:.4f} ({q['bound_ms']:.4f}"
            f"{q['bound_by'][0]}, {q['plain_ms']:.3f}, {q['library_ms']:.4f}"
            f", {q['variant']})" for q in (r, e)) + (
            f"  no sidecar bf16 {r['ms_no_sidecar']:.4f} exact "
            f"{e['ms_no_sidecar']:.4f}" if "ms_no_sidecar" in r else ""))
    for M in (m for m in (1, 8) if m in rows):
        for bits in (4, 3):
            for mode in ("bf16", "exact"):
                sel = [r for r in record[key] if r["M"] == M
                       and r["bits"] == bits and r["mode"] == mode]
                step = {k: sum(r[k] * r["launches_per_step"] for r in sel)
                        for k in ("ms", "bound_ms", "library_ms")}
                record[step_key].append(dict(bits=bits, mode=mode, M=M,
                                             **step))
                print(f"  {label} per decode step, {M} row(s), w{bits} "
                      f"{mode}: "
                      f"{step['ms']:.3f} ms (bound {step['bound_ms']:.3f}, "
                      f"library {step['library_ms']:.3f})")
    record["k1_max_abs_err"] = max(worst, record.get("k1_max_abs_err", 0.0))
    flips = sum(f[3] for f in record["k1_bf16_flips"])
    total = sum(f[4] for f in record["k1_bf16_flips"])
    print(f"{label} ok: {len(record[key])} cases, each bit-equal across "
          f"two launches, max rel err {worst_rel} within {TOL_K1}, "
          f"max abs err {worst:.3g}; "
          f"bf16 mode: {flips} of {total} outputs round to another bf16 "
          f"value than the plain version's")


def check_k1_cross(torch, timer, record):
    """Both K1 kernels in bf16 mode (w4, the decode shapes' 0.45% sidecar)
    at CROSS_ROWS: each held to the plain version, and timed, to place
    their crossover (a decode step takes the GEMV at any slot count, every
    other call the tensor-core kernel)."""
    from squeezellm_tpu_torch import synthetic
    from squeezellm_tpu_torch.ops import lut_matmul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    for name, out_f, in_f, _ in K1_SHAPES:
        sp = 0.0 if name == "lm_head" else 0.0045
        t = synthetic.random_quant_linear(gen, dev, out_f, in_f, 4, sp,
                                          0).tensors()
        kw = {}
        if "sp_rowptr" in t:
            kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                      vals=t["sp_vals"])
        for M in CROSS_ROWS:
            x = torch.randn(M, in_f, generator=gen,
                            device=dev).to(torch.bfloat16)
            args = (x, t["qweight"], t["lut"], 4)
            want = lut_matmul.lut_matmul_plain(*args, mode="bf16", **kw)
            row = dict(shape=name, M=M)
            for v in lut_matmul.VARIANTS:
                def run(v=v):
                    return lut_matmul.lut_matmul(*args, mode="bf16",
                                                 variant=v, **kw)
                err = rel_err(run(), want)
                if err > TOL_K1["bf16"]:
                    raise AssertionError(f"K1 {v} {name} M={M}: rel err "
                                         f"{err}")
                row[f"{v}_ms"] = timer.ms(run)
            record["k1_cross"].append(row)
        del t
    print("  K1 crossover, w4 bf16 (ms: GEMV / tensor cores; a decode step "
          "takes the GEMV, every other call the tensor cores)")
    for name, *_ in K1_SHAPES:
        print(f"  K1 {name:8s} " + "  ".join(
            f"M={r['M']}: {r['gemv_ms']:.4f} / {r['mma_ms']:.4f}"
            for r in record["k1_cross"] if r["shape"] == name))
    print(f"K1 crossover ok: {len(record['k1_cross'])} row counts x 2 "
          f"kernels within {TOL_K1['bf16']} of max |y|")


def check_k2(torch, timer, record):
    import torch.nn.functional as F

    from squeezellm_tpu_torch.models import common
    from squeezellm_tpu_torch.ops import decode_attn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    B, H, Hkv, hd, S = 1, 32, 32, 128, 2048
    worst, worst_rel = 0.0, 0.0
    for n in DECODE_LENS:
        qkv = torch.randn(B, (H + 2 * Hkv) * hd, generator=gen,
                          device=dev).to(torch.bfloat16)
        q = qkv[:, : H * hd].view(B, H, hd)
        k = qkv[:, H * hd: (H + Hkv) * hd].view(B, Hkv, hd)
        v = qkv[:, (H + Hkv) * hd:].view(B, Hkv, hd)
        cache = torch.randn(2, B, S, Hkv * hd, generator=gen,
                            device=dev).to(torch.bfloat16)
        lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
        cos, sin = common.rope_cos_sin(lengths.long() - 1, hd, 10000.0,
                                       torch.bfloat16)
        kw = dict(rope_cos=cos.float().contiguous(),
                  rope_sin=sin.float().contiguous())
        kc, pc = cache.clone(), cache.clone()
        got = decode_attn.decode_attention(q, k, v, kc[0], kc[1], lengths,
                                           **kw)
        want = decode_attn.decode_attention_plain(q, k, v, pc[0], pc[1],
                                                  lengths, **kw)
        torch.cuda.synchronize()
        err = max(rel_err(got, want), rel_err(kc, pc))
        worst = max(worst, abs_err(got, want), abs_err(kc, pc))
        worst_rel = max(worst_rel, err)
        if err > TOL_ATTN:
            raise AssertionError(f"K2 n={n}: rel err {err}")
        nbytes = (3 * H * hd * 2 + 2 * hd * 4 + 4 + 2 * n * Hkv * hd * 2
                  + 2 * Hkv * hd * 2 + H * hd * 4)
        # roped q and p are f32, so both products run at the f32 rate
        b, by = bound_ms(nbytes, [(4 * H * n * hd, "f32")])
        kh = kc[0, 0, :n].view(n, Hkv, hd).transpose(0, 1)[None].contiguous()
        vh = kc[1, 0, :n].view(n, Hkv, hd).transpose(0, 1)[None].contiguous()
        q4 = q[:, :, None, :].contiguous()
        row = dict(n=n, S=S, rel_err=err, splits=decode_attn.splits(S),
                   blocks_with_rows=-(-n // decode_attn.CHUNK),
                   ms=timer.ms(lambda: decode_attn.decode_attention(
                       q, k, v, kc[0], kc[1], lengths, **kw)),
                   plain_ms=timer.ms(lambda: decode_attn.decode_attention_plain(
                       q, k, v, pc[0], pc[1], lengths, **kw), iters=5),
                   library_ms=timer.ms(
                       lambda: F.scaled_dot_product_attention(q4, kh, vh)),
                   bound_ms=b, bound_by=by, bytes=nbytes)
        record["k2_detail"].append(row)
        print(f"  K2 n={n:5d}: {row['ms']:.4f} ms (bound {b:.4f} by {by}, "
              f"plain {row['plain_ms']:.3f}, sdpa {row['library_ms']:.4f}; "
              f"{row['splits']} splits of {decode_attn.CHUNK} rows, "
              f"{row['blocks_with_rows']} with rows)")
    record["k2_max_abs_err"] = worst
    print(f"K2 ok: max rel err {worst_rel:.3g} within {TOL_ATTN}, max abs "
          f"err {worst:.3g}")


def check_k3(torch, timer, record):
    """K3 in both regimes on the same bf16 k/v (head-major views of a
    4096-row cache) at the prompt lengths and the eval stride: the bf16
    regime (mode "bf16", q bf16: the tensor-core kernel) within
    TOL_ATTN_BF16 of max |v|, the exact regime (q in f32: the f32-FMA
    kernel) within TOL_ATTN of max |out|, both against the plain version;
    causal SDPA on the same bf16 tensors as the yardstick."""
    import torch.nn.functional as F

    from squeezellm_tpu_torch.models import common
    from squeezellm_tpu_torch.ops import flash_attn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    H, Hkv, hd, S = 32, 32, 128, 4096
    worst = {"bf16": 0.0, "exact": 0.0}
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    # a speculative verify window (W = 5) at a device offset, as the
    # graphed window launches it, against the int offset and the plain
    # version
    W, at = SPECULATIVE[0] + 1, 1000
    qw = torch.randn(1, W, H, hd, generator=gen,
                     device=dev).to(torch.bfloat16).transpose(1, 2)
    cw = {n: torch.randn(1, S, Hkv * hd, generator=gen,
                         device=dev).to(torch.bfloat16) for n in ("k", "v")}
    kw_, vw_ = common.read_kv(cw, torch.bfloat16, Hkv)
    off = torch.tensor([at], dtype=torch.int32, device=dev)
    for regime, qq in (("bf16", qw), ("exact", qw.float())):
        got = flash_attn.flash_attention(qq, kw_, vw_, off, mode=regime)
        same = torch.equal(got, flash_attn.flash_attention(
            qq, kw_, vw_, at, mode=regime))
        want = flash_attn.flash_attention_plain(qq, kw_, vw_, off)
        err = (abs_err(got, want) / float(vw_[:, :, :at + W].float().abs()
                                          .max()) if regime == "bf16"
               else rel_err(got, want))
        limit = TOL_ATTN_BF16 if regime == "bf16" else TOL_ATTN
        if not (same and err <= limit):
            raise AssertionError(f"K3 {regime} window at a device offset: "
                                 f"equal to the int offset {same}, err "
                                 f"{err} (limit {limit})")
        record.setdefault("k3_window", {})[regime] = dict(
            W=W, offset=at, err=err,
            ms=timer.ms(lambda: flash_attn.flash_attention(
                qq, kw_, vw_, off, mode=regime)))
    print(f"  K3 verify window W={W} at device offset {at}: equal to the int "
          f"offset's launch, within its tolerance of the plain version; "
          f"{record['k3_window']}")
    for sq in K3_LENS:
        q = torch.randn(1, sq, H, hd, generator=gen,
                        device=dev).to(torch.bfloat16).transpose(1, 2)
        cache = {n: torch.randn(1, S, Hkv * hd, generator=gen,
                                device=dev).to(torch.bfloat16)
                 for n in ("k", "v")}
        k, v = common.read_kv(cache, torch.bfloat16, Hkv)
        qf = q.float()
        want = flash_attn.flash_attention_plain(q, k, v, 0)
        vmax = float(v[:, :, :sq].float().abs().max())
        qc = q.contiguous()
        kc = k[:, :, :sq].contiguous()
        vc = v[:, :, :sq].contiguous()
        library = timer.ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True))
        pairs = sq * (sq + 1) // 2
        for regime, qq, mode in (("bf16", q, "bf16"), ("exact", qf, "exact")):
            before = flash_attn.flash_attention.regime_launches[regime]
            got = flash_attn.flash_attention(qq, k, v, 0, mode=mode)
            torch.cuda.synchronize()
            if flash_attn.flash_attention.regime_launches[regime] != before + 1:
                raise AssertionError(f"K3 Sq={sq}: not the {regime} kernel")
            # the offset read from a tensor on the card: the same launch
            if not torch.equal(got, flash_attn.flash_attention(
                    qq, k, v, zero, mode=mode)):
                raise AssertionError(f"K3 {regime} Sq={sq}: a device offset "
                                     "gives other bits than the int")
            err = abs_err(got, want)
            worst[regime] = max(worst[regime], err)
            if regime == "bf16":
                held, limit = err / vmax, TOL_ATTN_BF16
            else:
                held, limit = rel_err(got, want), TOL_ATTN
            if not (torch.isfinite(got).all() and held <= limit):
                raise AssertionError(f"K3 {regime} Sq={sq}: err {held} > "
                                     f"{limit}")
            nbytes = (H * sq * hd * qq.element_size() + 2 * Hkv * sq * hd * 2
                      + H * sq * hd * 4)
            # the tensor-core kernel runs both products bf16 x bf16; the
            # exact regime's f32 q makes both f32
            rate = "bf16" if regime == "bf16" else "f32"
            b, by = bound_ms(nbytes, [(2 * H * hd * pairs, rate),
                                      (2 * H * hd * pairs, rate)])
            row = dict(Sq=sq, S=S, regime=regime, err=held, limit=limit,
                       ms=timer.ms(lambda: flash_attn.flash_attention(
                           qq, k, v, 0, mode=mode)),
                       plain_ms=timer.ms(
                           lambda: flash_attn.flash_attention_plain(
                               qq, k, v, 0), iters=5),
                       library_ms=library, bound_ms=b, bound_by=by,
                       bytes=nbytes)
            record["k3_detail"].append(row)
            print(f"  K3 {regime:5s} Sq={sq:4d}: {row['ms']:.4f} ms (bound "
                  f"{b:.4f} by {by}, plain {row['plain_ms']:.3f}, causal "
                  f"sdpa {library:.4f}); err {held:.3g} (limit {limit:.3g})")
    record["k3_max_abs_err"] = max(worst.values())
    record["k3_max_abs_err_by_regime"] = worst
    print(f"K3 ok: bf16 regime within {TOL_ATTN_BF16} of max |v|, exact "
          f"regime within {TOL_ATTN} of max |out|; max abs err {worst}")


def check_k4(torch, timer, record):
    from squeezellm_tpu_torch import synthetic
    from squeezellm_tpu_torch.ops import dequant_dense as dd
    from squeezellm_tpu_torch.ops import lut_matmul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    M = EVAL_SEQLEN
    worst_w, worst_y = 0.0, 0.0
    worst_rel = {"exact": 0.0, "bf16": 0.0}
    seam = {"exact": 0.0, "bf16": 0.0}
    differ, total = 0, 0
    for name, out_f, in_f, per_fwd in K4_SHAPES:
        for bits in (4, 3):
            sp = 0.0 if name == "lm_head" else 0.0045
            t = synthetic.random_quant_linear(gen, dev, out_f, in_f, bits, sp,
                                              0).tensors()
            kw = {}
            if "sp_rowptr" in t:
                kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                          vals=t["sp_vals"])
            nnz = t["sp_vals"].numel() if kw else 0
            args = (t["qweight"], t["lut"], bits, in_f)
            for mode in ("exact", "bf16"):
                dt = torch.bfloat16 if mode == "bf16" else torch.float32
                w = dd.dequant_dense(*args, mode=mode, **kw)
                w_plain = dd.dequant_dense_plain(*args, mode=mode, **kw)
                torch.cuda.synchronize()
                if w.shape != (in_f, out_f) or w.dtype != dt:
                    raise AssertionError(f"K4 {name}: W {w.shape} {w.dtype}")
                n_diff = int((w != w_plain).sum())
                w_err = abs_err(w, w_plain)
                differ += n_diff
                total += w.numel()
                if n_diff and (mode == "exact" or w_err > float(
                        w_plain.float().abs().max()) * 2.0**-7):
                    raise AssertionError(
                        f"K4 {name} w{bits} {mode}: {n_diff} of {w.numel()} "
                        f"elements of W differ, max |d| {w_err}")
                x = torch.randn(M, in_f, generator=gen, device=dev).to(dt)
                y0 = torch.randn(M, out_f, generator=gen, device=dev).to(dt)
                y = dd.dense_matmul(x, w) + y0.float()
                y_plain = dd.dense_matmul(x, w_plain, plain=True) + y0.float()
                # K1's plain version, 256 rows at a time (its sparse fold
                # takes rows x out x widest CSR row floats of scratch)
                y_k1 = torch.cat([lut_matmul.lut_matmul_plain(
                    x[r: r + 256], t["qweight"], t["lut"], bits,
                    y0=y0[r: r + 256], mode=mode, **kw)
                    for r in range(0, M, 256)])
                torch.cuda.synchronize()
                err = rel_err(y, y_plain)
                k1_err = rel_err(y, y_k1)
                worst_w = max(worst_w, w_err)
                worst_y = max(worst_y, abs_err(y, y_plain))
                worst_rel[mode] = max(worst_rel[mode], err)
                seam[mode] = max(seam[mode], k1_err)
                lim = TOL_K1[mode] if mode == "exact" else TOL_K4_SEAM
                if err > TOL_K1[mode] or k1_err > lim:
                    raise AssertionError(
                        f"K4 {name} w{bits} {mode}: y rel err {err} vs the "
                        f"plain K4 route, {k1_err} vs lut_matmul_plain")
                del y, y_plain, y_k1, x, y0
                nbytes = (t["qweight"].numel() * 4 + t["lut"].numel() * 4
                          + w.numel() * w.element_size()
                          + (nnz * 8 + (out_f + 1) * 4 if kw else 0))
                b, by = bound_ms(nbytes, [(nnz, "f32")])
                del w, w_plain
                row = dict(
                    shape=name, bits=bits, mode=mode, out=out_f, inp=in_f,
                    launches_per_forward=per_fwd, w_differs=n_diff,
                    rel_err=err, rel_err_vs_k1_plain=k1_err,
                    ms=timer.ms(lambda: dd.dequant_dense(*args, mode=mode,
                                                         **kw)),
                    # the fold runs in the dequant launch: its cost is the
                    # difference to the same launch without the sidecar
                    ms_no_sidecar=timer.ms(lambda: dd.dequant_dense(
                        *args, mode=mode)),
                    plain_ms=timer.ms(lambda: dd.dequant_dense_plain(
                        *args, mode=mode, **kw), iters=3, warmup=1),
                    library_ms=None, bound_ms=b, bound_by=by, bytes=nbytes)
                row["gb_s"] = nbytes / row["ms"] / 1e6
                record["k4_detail"].append(row)
            del t
            torch.cuda.empty_cache()
    print("  K4 ms (bound, plain) [GB/s] {the same launch without the "
          "sidecar}; no library call computes it")
    for r in record["k4_detail"]:
        print(f"  K4 {r['shape']:8s} w{r['bits']} {r['mode']:5s} "
              f"{r['ms']:.4f} ({r['bound_ms']:.4f}{r['bound_by'][0]}, "
              f"{r['plain_ms']:.2f}) [{r['gb_s']:.0f}] "
              f"{{{r['ms_no_sidecar']:.4f}}}")
    for bits in (4, 3):
        for mode in ("bf16", "exact"):
            rows = [r for r in record["k4_detail"] if r["bits"] == bits
                    and r["mode"] == mode and not r["shape"].startswith("opt")]
            fwd = {k: sum(r[k] * r["launches_per_forward"] for r in rows)
                   for k in ("ms", "bound_ms")}
            record["k4_per_forward"].append(dict(bits=bits, mode=mode, **fwd))
            print(f"  K4 per LLaMA-2-7B forward w{bits} {mode}: "
                  f"{fwd['ms']:.2f} ms (bound {fwd['bound_ms']:.2f})")
    # the kernel's own output is W; y also carries the library GEMM
    record["k4_max_abs_err"] = worst_w
    record["k4_y_max_abs_err"] = worst_y
    print(f"K4 ok: 28 cases, W differs from the plain version's in {differ} "
          f"of {total} elements (max |d| {worst_w:.3g}); y at {M} rows vs "
          f"the plain K4 route max rel err {worst_rel} within {TOL_K1} (max "
          f"abs {worst_y:.3g}); vs lut_matmul_plain {seam} "
          f"(exact held to {TOL_K1['exact']}, bf16 to {TOL_K4_SEAM}: the "
          f"sidecar is rounded to bf16 in this row band)")


def check_k5(torch, timer, record):
    import torch.nn.functional as F

    from squeezellm_tpu_torch.models import common
    from squeezellm_tpu_torch.ops import decode_attn, kv_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    B, H, hd, S = 1, 32, 128, 2048
    # (kv heads, rope, window, input dtype); the first is LLaMA-2-7B's bf16
    # decode step and the one that is timed
    variants = ((32, True, None, torch.bfloat16),
                (8, True, None, torch.bfloat16),
                (32, False, None, torch.float32),
                (8, True, 256, torch.float32))
    worst, worst_rel = 0.0, 0.0
    for n in DECODE_LENS:
        for vi, (Hkv, rope, window, dt) in enumerate(variants):
            qkv = torch.randn(B, (H + 2 * Hkv) * hd, generator=gen,
                              device=dev).to(dt)
            q = qkv[:, : H * hd].view(B, H, hd)
            k = qkv[:, H * hd: (H + Hkv) * hd].view(B, Hkv, hd)
            v = qkv[:, (H + Hkv) * hd:].view(B, Hkv, hd)
            hist = torch.randn(2, B, S, Hkv, hd, generator=gen, device=dev)
            codes, scales = kv_quant.quantize_rows(hist)
            codes = codes.reshape(2, B, S, Hkv * hd)
            scales = scales[..., 0].transpose(2, 3).contiguous()  # 2,B,Hkv,S
            lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
            kw = dict(sliding_window=window)
            if rope:
                cos, sin = common.rope_cos_sin(lengths.long() - 1, hd,
                                               10000.0, dt)
                kw.update(rope_cos=cos.float().contiguous(),
                          rope_sin=sin.float().contiguous())
            kc, ks = codes.clone(), scales.clone()
            pc, ps = codes.clone(), scales.clone()
            got = decode_attn.decode_attention_q8(
                q, k, v, kc[0], kc[1], ks[0], ks[1], lengths, **kw)
            want = decode_attn.decode_attention_q8_plain(
                q, k, v, pc[0], pc[1], ps[0], ps[1], lengths, **kw)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            worst = max(worst, abs_err(got, want))
            worst_rel = max(worst_rel, err)
            if (err > TOL_ATTN or not torch.equal(kc, pc)
                    or not torch.equal(ks, ps)
                    or torch.equal(kc[:, :, n - 1], codes[:, :, n - 1])):
                raise AssertionError(
                    f"K5 n={n} Hkv={Hkv} rope={rope} window={window}: rel "
                    f"err {err}, codes equal {torch.equal(kc, pc)}, scales "
                    f"equal {torch.equal(ks, ps)}, row {n - 1} rewritten "
                    f"{not torch.equal(kc[:, :, n - 1], codes[:, :, n - 1])}")
            if vi:
                continue
            nbytes = (3 * H * hd * 2 + 2 * hd * 4 + 4 + 2 * n * Hkv * (hd + 4)
                      + 2 * Hkv * (hd + 4) + H * hd * 4)
            b, by = bound_ms(nbytes, [(4 * H * n * hd, "f32")])
            cache = {"k": kc[0], "v": kc[1], "ks": ks[0], "vs": ks[1]}
            kh, vh = (a[:, :, :n].contiguous()
                      for a in common.read_kv(cache, torch.bfloat16, Hkv))
            q4 = q[:, :, None, :].contiguous()
            row = dict(
                n=n, S=S, rel_err=err, splits=decode_attn.splits(S),
                blocks_with_rows=-(-n // decode_attn.CHUNK),
                ms=timer.ms(lambda: decode_attn.decode_attention_q8(
                    q, k, v, kc[0], kc[1], ks[0], ks[1], lengths, **kw)),
                plain_ms=timer.ms(
                    lambda: decode_attn.decode_attention_q8_plain(
                        q, k, v, pc[0], pc[1], ps[0], ps[1], lengths, **kw),
                    iters=5),
                library_ms=timer.ms(
                    lambda: F.scaled_dot_product_attention(q4, kh, vh)),
                bound_ms=b, bound_by=by, bytes=nbytes)
            record["k5_detail"].append(row)
            print(f"  K5 n={n:5d}: {row['ms']:.4f} ms (bound {b:.4f} by "
                  f"{by}, plain {row['plain_ms']:.3f}, sdpa on the "
                  f"dequantized cache {row['library_ms']:.4f}; "
                  f"{row['splits']} splits, {row['blocks_with_rows']} with "
                  f"rows)")
    record["k5_max_abs_err"] = worst
    print(f"K5 ok: 16 cases (MHA and GQA 8 of 32, rope and none, window "
          f"256), codes and scales equal to the plain version's, max rel err "
          f"{worst_rel:.3g} within {TOL_ATTN}, max abs err {worst:.3g}")


def _structured(torch, t):
    """A structured random linear's table as K10 takes it, on the card."""
    from squeezellm_tpu_torch.quantize import kmeans

    a, d = kmeans.structured_decomposition(t["lut"])
    return (torch.from_numpy(a).cuda(), torch.from_numpy(d).cuda())


def _lut_case(timer, record, key, name, bits, M, mode, per_step, got, want,
              tol, timed, nbytes, ops, library):
    """Hold one K10/K11 case to its plain version, time it, keep the row."""
    err = rel_err(got, want)
    if err > tol:
        raise AssertionError(f"{key} {name} M={M} {mode}: rel err {err}")
    b, by = bound_ms(nbytes, ops)
    kernel, plain = timed
    row = dict(shape=name, bits=bits, M=M, mode=mode,
               launches_per_step=per_step, rel_err=err,
               abs_err=abs_err(got, want), ms=timer.ms(kernel),
               plain_ms=timer.ms(plain, iters=5),
               library_ms=timer.ms(library), bound_ms=b,
               bound_by=by, bytes=nbytes)
    row["gb_s"] = nbytes / row["ms"] / 1e6
    record[f"{key}_detail"].append(row)
    record[f"{key}_max_abs_err"] = max(record.get(f"{key}_max_abs_err", 0.0),
                                       row["abs_err"])
    return row


def _print_lut_rows(record, key, label):
    print(f"  {label} ms (bound by b=bytes/o=operations, plain, library "
          f"matmul)")
    for r in record[f"{key}_detail"]:
        if r["mode"] == "exact":
            continue
        e = next(q for q in record[f"{key}_detail"] if q["mode"] == "exact"
                 and all(q[k] == r[k] for k in ("shape", "M")))
        print(f"  {label} {r['shape']:8s} M={r['M']:3d} " + "  ".join(
            f"{q['mode']} {q['ms']:.4f} ({q['bound_ms']:.4f}"
            f"{q['bound_by'][0]}, {q['plain_ms']:.3f}, {q['library_ms']:.4f})"
            for q in (r, e)))
    for mode in ("bf16", "exact"):
        rows = [r for r in record[f"{key}_detail"] if r["M"] == 1
                and r["mode"] == mode]
        step = {k: sum(r[k] * r["launches_per_step"] for r in rows)
                for k in ("ms", "bound_ms", "library_ms")}
        record[f"{key}_per_decode_step"].append(dict(mode=mode, **step))
        print(f"  {label} per decode step {mode}: {step['ms']:.3f} ms (bound "
              f"{step['bound_ms']:.3f}, library {step['library_ms']:.3f})")


def check_k10(torch, timer, record):
    """K10 (structured LUT matmul) against its plain version at the decode
    and prefill shapes of a structured w4 LLaMA-2-7B."""
    from squeezellm_tpu_torch import synthetic
    from squeezellm_tpu_torch.ops import lut_matmul, plain_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    for name, out_f, in_f, per_step in K1_SHAPES:
        sp = 0.0 if name == "lm_head" else 0.0045
        t = synthetic.random_quant_linear(gen, dev, out_f, in_f, 4, sp, 0,
                                          structured=True).tensors()
        a, d = _structured(torch, t)
        kw = {}
        if "sp_rowptr" in t:
            kw = dict(rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                      vals=t["sp_vals"])
        nnz = t["sp_vals"].numel() if kw else 0
        w32 = plain_ops.dequantize(t["qweight"],
                                   lut_matmul.struct_lut(a, d), 4, in_f)
        lib_w = {"exact": w32, "bf16": w32.to(torch.bfloat16)}
        for M in K10_ROWS:
            for mode in ("exact", "bf16"):
                dt = torch.bfloat16 if mode == "bf16" else torch.float32
                x = torch.randn(M, in_f, generator=gen, device=dev).to(dt)
                y0 = torch.randn(M, out_f, generator=gen, device=dev).to(dt)
                args = (x, t["qweight"], a, d)
                variant = "gemv" if M in K1_DECODE_ROWS else None

                def kernel():
                    return lut_matmul.lut_matmul_struct(
                        *args, y0=y0, mode=mode, variant=variant, **kw)

                def plain():
                    return lut_matmul.lut_matmul_struct_plain(
                        *args, y0=y0, mode=mode, **kw)

                got, again, want = kernel(), kernel(), plain()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K10 {name} M={M} {mode}: two "
                                         f"launches differ")
                nbytes = (t["qweight"].numel() * 4 + out_f * 9 * 4
                          + x.numel() * x.element_size()
                          + y0.numel() * y0.element_size() + got.numel() * 4
                          + (nnz * 8 + (out_f + 1) * 4 if kw else 0))
                ops = [(2 * M * in_f * out_f,
                        "bf16" if mode == "bf16" else "f32"),
                       (2 * M * nnz, "f32")]
                w = lib_w[mode]
                row = _lut_case(timer, record, "k10", name, 4, M, mode,
                                per_step, got, want, TOL_K1[mode],
                                (kernel, plain), nbytes, ops,
                                lambda: torch.matmul(x, w))
                row["variant"] = lut_matmul.plan(M, in_f, out_f, 4, mode,
                                                 variant).variant
        del t, w32, lib_w
    _print_lut_rows(record, "k10", "K10")
    for mode in ("bf16", "exact"):
        rows = [r for r in record["k10_detail"] if r["M"] == 8
                and r["mode"] == mode]
        print(f"  K10 per decode step, 8 rows, {mode}: "
              f"{sum(r['ms'] * r['launches_per_step'] for r in rows):.3f} ms")
    print(f"K10 ok: {len(record['k10_detail'])} cases (5 shapes, rows "
          f"{K10_ROWS}, exact and bf16), each bit-equal across two launches, "
          f"max abs err "
          f"{record['k10_max_abs_err']:.3g}, within {TOL_K1} of max |y|")


def check_k11(torch, timer, record):
    """K11 (transposed 4-bit GEMV) against its plain version at the decode
    shapes of LLaMA-2-7B, 1 and 8 rows."""
    from squeezellm_tpu_torch import synthetic
    from squeezellm_tpu_torch.ops import lut_matmul_t, plain_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    for name, out_f, in_f, per_step in K1_SHAPES:
        t = synthetic.random_quant_linear(gen, dev, out_f, in_f, 4, 0.0,
                                          0).tensors()
        qwt = t["qweight"].t().contiguous()
        w32 = plain_ops.dequantize(t["qweight"], t["lut"], 4, in_f)
        lib_w = {"exact": w32, "bf16": w32.to(torch.bfloat16)}
        del t["qweight"]
        for M in K11_ROWS:
            for mode in ("exact", "bf16"):
                dt = torch.bfloat16 if mode == "bf16" else torch.float32
                x = torch.randn(M, in_f, generator=gen, device=dev).to(dt)

                def kernel():
                    return lut_matmul_t.lut_matmul_t(x, qwt, t["lut"],
                                                     mode=mode)

                def plain():
                    return lut_matmul_t.lut_matmul_t_plain(x, qwt, t["lut"],
                                                           mode=mode)

                got, want = kernel(), plain()
                torch.cuda.synchronize()
                nbytes = (qwt.numel() * 4 + t["lut"].numel() * 4
                          + x.numel() * x.element_size() + got.numel() * 4)
                ops = [(2 * M * in_f * out_f,
                        "bf16" if mode == "bf16" else "f32")]
                w = lib_w[mode]
                _lut_case(timer, record, "k11", name, 4, M, mode, per_step,
                          got, want, TOL_K1[mode], (kernel, plain), nbytes,
                          ops, lambda: torch.matmul(x, w))
        del t, qwt, w32, lib_w
    _print_lut_rows(record, "k11", "K11")
    rows = [r for r in record["k11_detail"] if r["M"] == 8
            and r["mode"] == "bf16"]
    record["k11_8_rows_vs_library"] = {
        r["shape"]: [r["ms"], r["library_ms"]] for r in rows}
    slower = [r["shape"] for r in rows if r["ms"] > r["library_ms"]]
    print("  K11 at 8 rows, bf16, against torch.matmul on the dequantized "
          "bf16 weight (ms): " + ", ".join(
              f"{r['shape']} {r['ms']:.4f} / {r['library_ms']:.4f}"
              for r in rows)
          + (f"; slower at {slower}" if slower else "; no slower at any"))
    print(f"K11 ok: {len(record['k11_detail'])} cases (5 shapes, rows "
          f"{K11_ROWS}, exact and bf16), max abs err "
          f"{record['k11_max_abs_err']:.3g}, within {TOL_K1} of max |y|")


def check_k12(torch, timer, record):
    """K12 (CSR sparse sum) against its plain version on the 0.45% sidecars
    of LLaMA-2-7B's fused linears, x in f32 (exact regime) and bf16: the
    sum alone at K12_ROWS, timed beside torch.sparse.mm on a CSR tensor
    (handed a pre-transposed x), and at K11_ROWS also as the transposed
    route calls it, folded in place into K11's f32 output with the bf16
    or f32 residual for o and down. Each time by the timer and by the
    profiler's device time a launch."""
    from squeezellm_tpu_torch import synthetic
    from squeezellm_tpu_torch.ops import spmv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    for name, out_f, in_f, per_step in K1_SHAPES[:4]:
        t = synthetic.random_quant_linear(gen, dev, out_f, in_f, 4, 0.0045,
                                          0).tensors()
        csr = (t["sp_rowptr"], t["sp_cols"], t["sp_vals"])
        nnz = csr[2].numel()
        lib = torch.sparse_csr_tensor(*csr, size=(out_f, in_f))
        for M in K12_ROWS:
            for mode in ("exact", "bf16"):
                dt = torch.bfloat16 if mode == "bf16" else torch.float32
                x = torch.randn(M, in_f, generator=gen, device=dev).to(dt)
                xt = x.float().t().contiguous()

                def kernel():
                    return spmv.spmv(x, *csr, out_f)

                def plain():
                    return spmv.spmv_plain(x, *csr, out_f)

                def library():
                    return torch.sparse.mm(lib, xt)

                got, want = kernel(), plain()
                again = kernel()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"k12 {name} M={M} {mode}: two "
                                         f"launches differ")
                nbytes = ((out_f + 1) * 4 + nnz * 8
                          + x.numel() * x.element_size() + got.numel() * 4)
                ops = [(2 * M * nnz, "f32")]
                row = _lut_case(timer, record, "k12", name, 4, M, mode,
                                per_step, got, want, TOL_K1["exact"],
                                (kernel, plain), nbytes, ops, library)
                row["device_ms"] = flushed_device_ms(torch, timer, kernel,
                                                     K12_KERNELS)
                row["library_device_ms"] = flushed_device_ms(torch, timer,
                                                             library)
                if M in K11_ROWS:
                    row["fold"] = _k12_fold(torch, timer, gen, spmv, x, csr,
                                            name, nbytes, ops)
        del t, csr, lib
    print("  K12 ms by the timer / device time (bound by b=bytes/"
          "o=operations, plain, library torch.sparse.mm on a CSR tensor by "
          "the timer / device time); the fold into K11's output")
    for r in record["k12_detail"]:
        fold = r.get("fold")
        print(f"  K12 {r['shape']:8s} M={r['M']:3d} x {r['mode']:5s} "
              f"{r['ms']:.4f} / {_ms(r['device_ms'])} ({r['bound_ms']:.4f}"
              f"{r['bound_by'][0]}, {r['plain_ms']:.3f}, "
              f"{r['library_ms']:.4f} / {_ms(r['library_device_ms'])})"
              + (f"; fold {fold['ms']:.4f} / {_ms(fold['device_ms'])} "
                 f"({fold['bound_ms']:.4f})" if fold else ""))
    for M in K11_ROWS:
        for mode in ("bf16", "exact"):
            rows = [r for r in record["k12_detail"] if r["M"] == M
                    and r["mode"] == mode]
            step = {k: _per_step(rows, lambda r, k=k: r[k])
                    for k in ("ms", "device_ms", "bound_ms", "library_ms",
                              "library_device_ms")}
            step.update({f"fold_{k}": _per_step(rows,
                                                lambda r, k=k: r["fold"][k])
                         for k in ("ms", "device_ms", "bound_ms")})
            record["k12_per_decode_step"].append(dict(M=M, mode=mode,
                                                      **step))
            print(f"  K12 per decode step ({M} rows, x {mode}; 128 "
                  f"launches), timer / device ms: folded "
                  f"{step['fold_ms']:.3f} / {_ms(step['fold_device_ms'])} "
                  f"(bound {step['fold_bound_ms']:.4f}), the sum alone "
                  f"{step['ms']:.3f} / {_ms(step['device_ms'])} (bound "
                  f"{step['bound_ms']:.4f}), library {step['library_ms']:.3f}"
                  f" / {_ms(step['library_device_ms'])}")
    rows = [r for r in record["k12_detail"] if r["M"] == 8]
    slower = [(r["shape"], r["mode"]) for r in rows
              if r["ms"] > r["library_ms"]
              or (r["device_ms"] or 0) > (r["library_device_ms"] or 0)]
    record["k12_8_rows_slower_than_library"] = slower
    print("  K12 at 8 rows against torch.sparse.mm by the timer and by "
          "device time: " + (f"slower at {slower}" if slower
                             else "no slower at any shape or x dtype"))
    print(f"K12 ok: {len(record['k12_detail'])} cases (4 sidecars, rows "
          f"{K12_ROWS}, x f32 and bf16; folded at {K11_ROWS}), max abs err "
          f"{record['k12_max_abs_err']:.3g}, within {TOL_K1['exact']} of "
          f"max |y|; two launches equal")


def _k12_fold(torch, timer, gen, spmv, x, csr, name, nbytes, ops):
    """K12 as the transposed route calls it: y (K11's f32 output) += y0 (x's
    dtype, o and down only) + the sum, in place; held to the plain version,
    timed."""
    M, out_f = x.shape[0], csr[0].numel() - 1
    y = torch.randn(M, out_f, generator=gen, device=x.device)
    y0 = (torch.randn(M, out_f, generator=gen, device=x.device).to(x.dtype)
          if name in ("o", "down") else None)
    got = spmv.spmv(x, *csr, out_f, y=y.clone(), y0=y0)
    want = spmv.spmv_plain(x, *csr, out_f, y=y.clone(), y0=y0)
    err = rel_err(got, want)
    if err > TOL_K1["exact"]:
        raise AssertionError(f"k12 fold {name} M={M}: rel err {err}")
    acc = y.clone()

    def fold():
        return spmv.spmv(x, *csr, out_f, y=acc, y0=y0)

    nbytes += y.numel() * 4 + (0 if y0 is None
                               else y0.numel() * y0.element_size())
    return dict(rel_err=err, with_y0=y0 is not None, ms=timer.ms(fold),
                device_ms=flushed_device_ms(torch, timer, fold, K12_KERNELS),
                bound_ms=bound_ms(nbytes, ops)[0])


def _ms(v):
    return "not measured" if v is None else f"{v:.4f}"


def _per_step(rows, get):
    """A decode step's sum over the shapes' launches; None when a reading
    is missing."""
    vals = [get(r) for r in rows]
    if any(v is None for v in vals):
        return None
    return sum(v * r["launches_per_step"] for v, r in zip(vals, rows))


def counters():
    """The twelve wrappers, K1 to K12."""
    from squeezellm_tpu_torch import graphs

    return graphs.counted_wrappers()


def reset_counts():
    from squeezellm_tpu_torch import graphs

    graphs.REPLAYED[:] = [0] * len(graphs.REPLAYED)
    for fn in counters():
        fn.launches = 0
    counters()[1].ropeless_launches = 0
    for fn in (counters()[0], counters()[9]):  # K1, K10 by device kernel
        fn.variant_launches = dict.fromkeys(fn.variant_launches, 0)
    k3 = counters()[2]  # K3 by regime
    k3.regime_launches = dict.fromkeys(k3.regime_launches, 0)
    counters()[11].copy_launches = 0  # K12's copies of x


def expect_counts(record, path, want):
    """Read the counts a path's run left, hold them to `want` (K1.., the
    kernels not named are held to 0) and keep them for the kernels' line."""
    got = read_counts()
    want = list(want) + [0] * (len(got) - len(want))
    if got != want:
        raise AssertionError(f"{path}: launches K1..K12 {got} != {want}")
    from squeezellm_tpu_torch import graphs

    record["paths"].append({"path": path, "launches": got,
                            "replayed": list(graphs.REPLAYED),
                            "variants": variants()})
    return got


def variants():
    """The launches by device kernel (K1, K10), by regime (K3) and K12's
    copies of x since the counts were reset."""
    return {"K1": dict(counters()[0].variant_launches),
            "K10": dict(counters()[9].variant_launches),
            "K3": dict(counters()[2].regime_launches),
            "K12 copies of x": counters()[11].copy_launches}


def read_counts():
    return [fn.launches for fn in counters()]


def device_ms_by_kernel(torch, fn, counts=None):
    """(device ms of one call of `fn` by kernel name, None), from a
    torch.profiler trace; (None, why) when the profiler failed or the
    trace holds no device time: the numbers are then not measured. A dict
    `counts` receives each kernel's launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:
        traceback.print_exc()
        return None, f"{type(e).__name__}: {e}"
    by_name = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
        if counts is not None:
            counts[e.key] = counts.get(e.key, 0) + e.count
    if sum(by_name.values()) <= 0:
        return None, "the trace holds no device time"
    return by_name, None


def profile_decode(torch, eng, ids, steps=8, start=2):
    """Host and device time per decode step, and the device time's split
    by kernel, at positions start.. of a cache of start + steps rows (the
    rows before it zeros: a long context costs its bytes whatever they
    hold). The steps are the engine's benchmark step program
    (``Engine.bench_program``), replayed as a CUDA graph or run eagerly as
    the engine runs it; an engine without one (an older checkout's) steps
    its model eagerly. Host ms: `steps` steps back to back and one sync;
    device ms from a trace of the same steps; ``profile_failed`` says why
    there is none."""
    import numpy as np

    rows = max(BENCH_TOKENS, start + steps)
    graphed = False
    with torch.no_grad():
        if hasattr(eng, "bench_program"):
            st, step = eng.bench_program(np.resize(ids, (1, start + steps)),
                                         max_seq=rows)
            st.pos.fill_(start - 2)
            step()  # the first call (a graph's warm-up and capture)
            step()
            graphed = step.graph is not None

            def reset():
                st.pos.fill_(start)

            def run():
                for _ in range(steps):
                    step()
        else:
            cache = eng.new_cache(1, rows)
            tok = torch.tensor(ids[:, :1], device="cuda")
            kw = dict(dtype=eng.dtype, mode=eng.mode)
            for i in range(start - 2, start):
                eng.model.decode_step(tok, i, cache, **kw)

            def reset():
                pass

            def run():
                for i in range(start, start + steps):
                    eng.model.decode_step(tok, i, cache, **kw)

        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / steps * 1e3
        reset()
        counts = {}
        by_name, why = device_ms_by_kernel(torch, run, counts)
    if by_name is None:
        return {"profile_failed": why, "context": start, "graphs": graphed,
                "host_ms_per_step": host}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn = sum(v for k, v in by_name.items() if "decode_attn_kernel" in k)
    device = sum(by_name.values()) / steps
    return {"profile_failed": None, "context": start, "graphs": graphed,
            "host_ms_per_step": host, "device_ms_per_step": device,
            "idle_share": 1 - device / host,
            "k2_k5_ms_per_step": attn / steps,
            "top_ms_per_step": [[k[:60], v / steps] for k, v in top],
            **step_shares(by_name, counts, steps)}


# a decode step's linears' kernels by name, for their shares of a trace
STEP_KERNELS = {"K1 GEMV": ("gemv_kernel",), "K11": ("k11_kernel",),
                "K12": K12_KERNELS}


def step_shares(by_name, counts, steps):
    """Device ms a step of each of STEP_KERNELS, and the device launches a
    step of every kernel in the trace."""
    ms = {k: sum(v for name, v in by_name.items()
                 if any(p in name for p in pats)) / steps
          for k, pats in STEP_KERNELS.items()}
    return {"ms_per_step_by_kernel": ms,
            "launches_per_step": sum(counts.values()) / steps}


# K4's device kernels by name: the dequant pass (whose launch folds the
# sidecar too) and the separate fold launch of an older form of the kernel
# (chip_ab.py profiles an older checkout with this function)
K4_KERNELS = ("k4_dequant_kernel", "dequant_dense_kernel")
K4_FOLD_KERNELS = ("sparse_fold_kernel",)


def profile_eval_stride(torch, model, tokens, mode, dtype):
    """Device time of one eval stride (one forward of EVAL_SEQLEN tokens
    and its NLL) and the shares of K4 (its dequant pass and, where it is a
    launch of its own, its fold), the dense matmuls after it (and the top-X
    products: every library GEMM), K3 and the rest. Raises when the trace
    holds no K4 kernel by these names: every stride launches K4, so a
    renamed kernel would otherwise be counted as "rest"."""
    from squeezellm_tpu_torch import eval as eval_mod

    tok = torch.as_tensor(tokens[:, :EVAL_SEQLEN].astype("int64"),
                          device="cuda")

    def run():
        with torch.no_grad():
            logits = model.forward(tok, dtype=dtype, mode=mode)
            eval_mod.stride_nll(logits, tok)

    by_name, why = device_ms_by_kernel(torch, run)
    if by_name is None:
        return {"profile_failed": why}
    parts = {"K4": 0.0, "K4 fold": 0.0, "dense matmul": 0.0, "K3": 0.0,
             "rest": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if any(k in low for k in K4_KERNELS):
            parts["K4"] += ms
        elif any(k in low for k in K4_FOLD_KERNELS):
            parts["K4 fold"] += ms
        elif "flash_attn" in low:  # either regime's kernel
            parts["K3"] += ms
        elif any(t in low for t in ("gemm", "cutlass", "cublas", "nvjet",
                                    "xmma")):
            parts["dense matmul"] += ms
        else:
            parts["rest"] += ms
    if parts["K4"] <= 0:
        raise AssertionError(f"eval stride: no K4 kernel {K4_KERNELS} in "
                             f"the trace: {sorted(by_name)}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"profile_failed": None, "device_ms": sum(by_name.values()),
            "parts_ms": parts, "top_ms": [[k[:70], v] for k, v in top]}


def layer_check(torch, model, ids, dtype, mode, cache_dtype, n_prefill=16,
                n_decode=8):
    """A regime (activation dtype, K1 mode, cache dtype) one layer at a
    time. Every layer is fed the plain path's input and a copy of the plain
    path's cache, and its output through the kernels is held against its
    plain output (max |d| / max |out|), over a prefill of ``n_prefill``
    tokens (K1, K3) and ``n_decode`` decode steps after it (K1 at one row,
    K2 or K5). Beside it, the plain layer of this regime against the plain
    f32 layer (exact mode, f32 cache holding what this cache holds) on the
    same input: the rounding of the regime itself."""
    import dataclasses

    from squeezellm_tpu_torch.models import common

    c, dev = model.config, model.device
    ids_t = torch.as_tensor(ids, device=dev)
    cache = common.init_kv_cache(1, BENCH_TOKENS, c.n_layers, c.n_kv_heads,
                                 c.head_dim, cache_dtype, dev)

    def as_f32(lc):
        k, v = common.read_kv(lc, torch.float32, c.n_kv_heads)
        return {"k": k.transpose(1, 2).reshape(1, BENCH_TOKENS, -1),
                "v": v.transpose(1, 2).reshape(1, BENCH_TOKENS, -1)}

    calls = [("prefill", ids_t[:, :n_prefill],
              dict(positions=torch.arange(n_prefill, device=dev)))]
    calls += [("decode", ids_t[:, p: p + 1],
               dict(decode_pos=torch.full((1,), p, device=dev)))
              for p in range(n_prefill, n_prefill + n_decode)]
    res = {"kernels_vs_plain": {"prefill": [], "decode": []},
           "regime_vs_f32": {"prefill": [], "decode": []}, "differ": 0,
           "outputs": 0}
    with torch.no_grad():
        for phase, tok, pos in calls:
            plain = model._step(dtype, mode, True, **pos)
            kern = dataclasses.replace(plain, plain=False)
            f32 = model._step(torch.float32, "exact", True, **pos)
            x = model.embed[tok].to(dtype)
            for layer, lc in zip(model.layers, cache):
                got = layer(x, kern, {n: t.clone() for n, t in lc.items()})
                ref32 = layer(x.float(), f32, as_f32(lc))
                want = layer(x, plain, lc)
                if not torch.isfinite(got).all():
                    raise AssertionError(f"layer_check {phase}: not finite")
                res["kernels_vs_plain"][phase].append(rel_err(got, want))
                res["regime_vs_f32"][phase].append(rel_err(want, ref32))
                res["differ"] += int((got != want).sum())
                res["outputs"] += want.numel()
                x = want
    return res


def print_layer_check(label, lc, limit, regime):
    for phase in ("prefill", "decode"):
        kv, bv = (sorted(lc[k][phase]) for k in ("kernels_vs_plain",
                                                 "regime_vs_f32"))
        print(f"{label} per layer, {phase}: kernels vs plain max "
              f"{kv[-1]:.3g} median {kv[len(kv) // 2]:.3g} (limit "
              f"{limit:.3g}); plain {regime} vs plain f32 max "
              f"{bv[-1]:.3g} median {bv[len(bv) // 2]:.3g}")


def run_model(torch, config, bits, record):
    import numpy as np

    from squeezellm_tpu_torch import engine, synthetic
    from squeezellm_tpu_torch.models import fuse

    t0 = time.perf_counter()
    model = fuse.fuse_for_decode(synthetic.quantized_llama(config, bits,
                                                           seed=bits))
    exact = engine.Engine(model)  # f32 activations and cache
    torch.cuda.synchronize()
    print(f"w{bits}: model made and fused on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(bits)
    prompts = [rng.integers(0, config.vocab_size, (1, n)) for n in PROMPT_LENS]
    res = {"bits": bits}

    # (i) the main path: three greedy requests through the kernels
    reset_counts()
    t0 = time.perf_counter()
    got = [exact.generate(p, NEW_TOKENS) for p in prompts]
    res["requests_s"] = time.perf_counter() - t0
    want_k1 = len(PROMPT_LENS) * NEW_TOKENS * (4 * config.n_layers + 1)
    res["launches"] = expect_counts(record, f"w{bits} requests", [
        want_k1, len(PROMPT_LENS) * (NEW_TOKENS - 1) * config.n_layers,
        len(PROMPT_LENS) * config.n_layers, 0, 0])
    eager = engine.Engine(model, graphs=False)
    t0 = time.perf_counter()
    got_eager = [eager.generate(p, NEW_TOKENS) for p in prompts]
    res["requests_eager_s"] = time.perf_counter() - t0
    del eager
    hold_equal(f"w{bits} requests, graphed vs eager", got, got_eager)
    plain = engine.Engine(model, plain=True)
    ref = [plain.generate(p, NEW_TOKENS) for p in prompts]
    for g, r, n in zip(got, ref, PROMPT_LENS):
        if g.shape != (1, n + NEW_TOKENS) or not np.array_equal(g, r):
            raise AssertionError(f"w{bits} prompt {n}: kernel tokens {g} != "
                                 f"plain tokens {r}")
    res["tokens"] = [g[0, n:].tolist() for g, n in zip(got, PROMPT_LENS)]
    ids = (np.arange(BENCH_TOKENS, dtype=np.int64)[None] * 7919) % config.vocab_size
    tf = exact.teacher_forced_logits(ids[:, :16], max_seq=BENCH_TOKENS)
    tf_ref = plain.teacher_forced_logits(ids[:, :16], max_seq=BENCH_TOKENS)
    res["tf_exact_rel_err"] = rel_err(tf, tf_ref)
    if not (torch.isfinite(tf).all() and res["tf_exact_rel_err"] <= TOL_TF_EXACT):
        raise AssertionError(f"w{bits} f32 logits: {res['tf_exact_rel_err']}")
    print(f"w{bits} (i) 3 requests (prompts {PROMPT_LENS}, {NEW_TOKENS} new "
          f"tokens) in {res['requests_s']:.2f} s graphed, "
          f"{res['requests_eager_s']:.2f} s eager, tokens identical to each "
          f"other and to the plain path; launches K1..K12 "
          f"{res['launches']} (of them by graph replays "
          f"{record['paths'][-1]['replayed']}); f32 teacher-forced logits "
          f"rel err {res['tf_exact_rel_err']:.3g}")

    # (ii) the bf16 flagship benchmark: the timed call without the check,
    # the perplexity check in a call of its own
    bkw = dict(dtype=torch.bfloat16, cache_dtype=torch.bfloat16, mode="bf16")
    bf = engine.Engine(model, **bkw)
    bf_eager = engine.Engine(model, graphs=False, **bkw)
    stats = bf.benchmark(ids, max_seq=BENCH_TOKENS)
    stats["eager"] = bf_eager.benchmark(ids, max_seq=BENCH_TOKENS)
    stats["check_ppl"] = bf.benchmark(ids, max_seq=BENCH_TOKENS,
                                      check=True)["check_ppl"]
    if bits == 4:  # a sampled bf16 request, graphed and eager
        sampled = [e.generate(prompts[-1], NEW_TOKENS, **SAMPLED)
                   for e in (bf, bf_eager)]
        hold_equal("w4 bf16 sampled request, graphed vs eager", *sampled)
        res["sampled_tokens"] = sampled[0][0, PROMPT_LENS[-1]:].tolist()
        print(f"w4 bf16 sampled request ({SAMPLED}): graphed and eager "
              f"tokens identical: {res['sampled_tokens'][:8]}...")
    bf_plain = engine.Engine(model, dtype=torch.bfloat16,
                             cache_dtype=torch.bfloat16, mode="bf16",
                             plain=True)
    # held one layer at a time; the full-depth distance is reported only:
    # 32 random layers amplify one-step bf16 flips (PERF.md)
    lc = layer_check(torch, model, ids, torch.bfloat16, "bf16",
                     torch.bfloat16)
    stats["layer_check"] = lc
    worst = max(max(v) for v in lc["kernels_vs_plain"].values())
    tf = bf.teacher_forced_logits(ids[:, :16], max_seq=BENCH_TOKENS)
    tf_bref = bf_plain.teacher_forced_logits(ids[:, :16], max_seq=BENCH_TOKENS)
    stats["tf_bf16_rel_err"] = rel_err(tf, tf_bref)
    stats["tf_bf16_plain_vs_f32"] = rel_err(tf_bref, tf_ref)
    stats["tf_bf16_argmax_agree"] = float(
        (tf.argmax(-1) == tf_bref.argmax(-1)).float().mean())
    if not (math.isfinite(stats["check_ppl"]) and torch.isfinite(tf).all()
            and worst <= TOL_LAYER_BF16):
        raise AssertionError(f"w{bits} bf16: {stats}")

    stats["profile"] = profile_decode(torch, bf, ids)
    if bits == 4:  # the same step at a 2048-row context: K2's row split
        stats["profile_eager"] = profile_decode(torch, bf_eager, ids)
        stats["profile_long"] = profile_decode(torch, bf, ids,
                                               start=LONG_CONTEXT)
        stats["profile_long_eager"] = profile_decode(torch, bf_eager, ids,
                                                     start=LONG_CONTEXT)
        print_long_profile(f"w{bits}", stats, record)
        print_host_device(f"w{bits} bf16 decode step", [
            (f"positions 2-9 {k}", stats[f"profile{sfx}"])
            for k, sfx in (("eager", "_eager"), ("graphed", ""))] + [
            (f"positions {LONG_CONTEXT}-{LONG_CONTEXT + 7} {k}",
             stats[f"profile_long{sfx}"])
            for k, sfx in (("eager", "_eager"), ("graphed", ""))], record)
    bf_eager.release()

    # (iii) launches in one decode step
    cache = bf.new_cache(1, BENCH_TOKENS)
    bf.model.prefill(torch.tensor(prompts[0], device="cuda"), cache,
                     dtype=torch.bfloat16, mode="bf16")
    reset_counts()
    bf.model.decode_step(torch.tensor([[1]], device="cuda"), PROMPT_LENS[0],
                         cache, dtype=torch.bfloat16, mode="bf16")
    stats["launches_per_decode_step"] = read_counts()
    if stats["launches_per_decode_step"] != [4 * config.n_layers + 1,
                                             config.n_layers] + [0] * 10:
        raise AssertionError(f"per-step launches {read_counts()}")
    res["bench"] = stats
    print(f"w{bits} (ii) bf16 decode: {stats['tokens_per_s']:.2f} tok/s "
          f"graphed, {stats['eager']['tokens_per_s']:.2f} eager, "
          f"{stats['median_latency_s'] * 1e3:.3f} ms/token "
          f"({stats['eager']['median_latency_s'] * 1e3:.3f} eager), "
          f"{stats['achieved_gb_s']:.1f} GB/s over {stats['param_bytes']} "
          f"param bytes, peak {stats['peak_memory_mib']:.0f} MiB, check ppl "
          f"{stats['check_ppl']:.1f}")
    print_layer_check(f"w{bits} bf16", lc, TOL_LAYER_BF16, "bf16")
    print(f"w{bits} bf16 per layer: {lc['differ']} of {lc['outputs']} "
          f"outputs differ; full depth, teacher-forced logits (reported, "
          f"not held): kernels vs plain {stats['tf_bf16_rel_err']:.3g}, "
          f"argmax agree {stats['tf_bf16_argmax_agree']:.3f}, plain bf16 vs "
          f"plain f32 {stats['tf_bf16_plain_vs_f32']:.3g}")
    print(f"w{bits} (iii) launches per decode step K1..K12: "
          f"{stats['launches_per_decode_step']}")
    print_profile(f"w{bits}", stats, record)
    record["models"].append(res)
    # nothing of the phases above stays allocated while the next ones read
    # their peak memory
    del exact, plain, bf, bf_eager, bf_plain, tf, tf_ref, tf_bref, cache
    res["eval"] = run_eval(torch, model, f"w{bits}", record)
    if bits == 4:
        res["int8"] = run_int8(torch, model, ids, stats, record)
        res["speculation"] = run_speculation(torch, model, record)
    return res


def run_eval(torch, model, label, record, modes=("exact", "bf16"),
             strides=EVAL_STRIDES):
    """eval.perplexity over `strides` strides of EVAL_SEQLEN synthetic
    tokens, EVAL_GROUP a forward, through the kernels and through their
    plain versions. The f32 perplexities are held together; the bf16 ones
    are printed only (the random model is chaotic in bf16)."""
    from squeezellm_tpu_torch import data
    from squeezellm_tpu_torch import eval as eval_mod

    cfg = model.config
    tokens = data.synthetic_tokens(cfg.vocab_size, strides * EVAL_SEQLEN,
                                   seed=17)
    forwards = -(-strides // EVAL_GROUP)
    linears = sum(1 for m in model.layers[0].modules()
                  if hasattr(m, "spec") and m.spec.is_quant)
    res = {"strides": strides, "group": EVAL_GROUP, "seqlen": EVAL_SEQLEN}
    for mode in modes:
        dt = torch.float32 if mode == "exact" else torch.bfloat16
        kw = dict(seqlen=EVAL_SEQLEN, group=EVAL_GROUP, dtype=dt, mode=mode)
        reset_counts()
        with CardSampler() as card:
            t0 = time.perf_counter()
            ppl = eval_mod.perplexity(model, tokens, **kw)
            secs = time.perf_counter() - t0
            # every linear at 4096 rows goes through K4 and none through K1
            launches = expect_counts(record, f"{label} eval {mode}", [
                0, 0, cfg.n_layers * forwards,
                (linears * cfg.n_layers + 1) * forwards, 0])
            prof = profile_eval_stride(torch, model, tokens, mode, dt)
        ppl_plain = eval_mod.perplexity(model, tokens, plain=True, **kw)
        rel = abs(ppl - ppl_plain) / ppl_plain
        if not (math.isfinite(ppl) and math.isfinite(ppl_plain)):
            raise AssertionError(f"{label} eval {mode}: ppl {ppl}, plain "
                                 f"{ppl_plain}")
        if mode == "exact" and rel > TOL_PPL:
            raise AssertionError(f"{label} eval f32: ppl {ppl} vs plain "
                                 f"{ppl_plain}, rel {rel} > {TOL_PPL}")
        res[mode] = dict(ppl=ppl, ppl_plain=ppl_plain, rel=rel,
                         s_per_stride=secs / strides, launches=launches,
                         profile=prof, card=card.stats)
        held = f"within {TOL_PPL}" if mode == "exact" else "reported only"
        print(f"{label} eval {mode}: ppl {ppl:.6g} through the kernels, "
              f"{ppl_plain:.6g} plain, rel {rel:.3g} ({held}); "
              f"{secs / strides:.3f} s a stride (host clock, {strides} "
              f"strides, {EVAL_GROUP} a forward; card meanwhile "
              f"{card.stats}); launches K1..K12 {launches}")
        if prof["profile_failed"]:
            record["profile_failed"].append(f"{label} eval {mode}")
            print(f"{label} eval {mode} PROFILE FAILED, device time not "
                  f"measured: {prof['profile_failed']}")
        else:
            print(f"{label} eval {mode} stride: device {prof['device_ms']:.1f}"
                  " ms: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      prof["parts_ms"].items())
                  + "; top: " + "; ".join(f"{k} {v:.1f}"
                                          for k, v in prof["top_ms"][:4]))
    return res


def run_int8(torch, model, ids, bf16_stats, record):
    """Engine(cache_dtype="int8"): one f32 request against the plain path,
    then the bf16 decode benchmark beside the bf16-cache one."""
    import numpy as np

    from squeezellm_tpu_torch import engine

    cfg = model.config
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                               (1, INT8_PROMPT))
    eng = engine.Engine(model, cache_dtype="int8")
    reset_counts()
    got = eng.generate(prompt, NEW_TOKENS)
    launches = expect_counts(record, "w4 int8 request", [
        NEW_TOKENS * (4 * cfg.n_layers + 1), 0, cfg.n_layers, 0,
        (NEW_TOKENS - 1) * cfg.n_layers])
    eager = engine.Engine(model, cache_dtype="int8", graphs=False)
    hold_equal("w4 int8 request, graphed vs eager", got,
               eager.generate(prompt, NEW_TOKENS))
    del eager
    plain_eng = engine.Engine(model, cache_dtype="int8", plain=True)
    ref = plain_eng.generate(prompt, NEW_TOKENS)

    def forced_logits(e):
        """The logits that choose each new token, the request's own steps
        (prefill, then decode) fed the plain path's tokens."""
        seq = torch.as_tensor(ref, device="cuda")
        cache = e.new_cache(1)
        kw = dict(dtype=e.dtype, mode=e.mode, plain=e.plain)
        rows = [e.model.prefill(seq[:, :INT8_PROMPT], cache, **kw)[0, -1]]
        for pos in range(INT8_PROMPT, INT8_PROMPT + NEW_TOKENS - 1):
            rows.append(e.model.decode_step(seq[:, pos: pos + 1], pos, cache,
                                            **kw)[0, -1])
        return torch.stack(rows)

    with torch.no_grad():
        lk, lp = forced_logits(eng), forced_logits(plain_eng)
    rel = rel_err(lk, lp)
    flips = int((lk.argmax(-1) != lp.argmax(-1)).sum())
    same = int((got[0, INT8_PROMPT:] == ref[0, INT8_PROMPT:]).cumprod().sum())
    lc = layer_check(torch, model, ref, torch.float32, "exact", "int8",
                     n_prefill=INT8_PROMPT)
    worst = max(max(v) for v in lc["kernels_vs_plain"].values())
    finite = bool(torch.isfinite(lk).all())
    del lk, lp
    if (got.shape != (1, INT8_PROMPT + NEW_TOKENS) or worst > TOL_LAYER_INT8
            or not finite):
        raise AssertionError(
            f"int8 request: per layer kernels vs plain {worst} (limit "
            f"{TOL_LAYER_INT8}); full depth logits rel err {rel}, {same} "
            f"leading tokens equal; kernel tokens {got[0, INT8_PROMPT:]} "
            f"plain tokens {ref[0, INT8_PROMPT:]}")
    bf = engine.Engine(model, dtype=torch.bfloat16, cache_dtype="int8",
                       mode="bf16")
    stats = bf.benchmark(ids, max_seq=BENCH_TOKENS)
    stats["check_ppl"] = bf.benchmark(ids, max_seq=BENCH_TOKENS,
                                      check=True)["check_ppl"]
    stats["profile"] = profile_decode(torch, bf, ids)
    cache = bf.new_cache(1, BENCH_TOKENS)
    reset_counts()
    bf.model.decode_step(torch.tensor([[1]], device="cuda"), 0, cache,
                         dtype=torch.bfloat16, mode="bf16")
    stats["launches_per_decode_step"] = read_counts()
    if stats["launches_per_decode_step"] != [4 * cfg.n_layers + 1, 0, 0, 0,
                                             cfg.n_layers] + [0] * 7:
        raise AssertionError(f"int8 per-step launches {read_counts()}")
    if not math.isfinite(stats["check_ppl"]):
        raise AssertionError(f"int8 bf16 benchmark: {stats}")
    print(f"w4 int8 cache: f32 request (prompt {INT8_PROMPT}, {NEW_TOKENS} "
          f"new tokens; graphed and eager identical); at full depth "
          f"(reported, not held) the logits that "
          f"choose its tokens lie {rel:.3g} of max |logit| from the plain "
          f"path's, {flips} argmax flips, {same} of {NEW_TOKENS} leading "
          f"tokens identical; launches K1..K12 {launches}; per decode step "
          f"{stats['launches_per_decode_step']}")
    print_layer_check("w4 f32, int8 cache", lc, TOL_LAYER_INT8, "int8 cache")
    for name, st in (("int8 cache", stats), ("bf16 cache", bf16_stats)):
        prof = st["profile"]
        busy = ("not measured" if prof["profile_failed"]
                else f"{prof['device_ms_per_step']:.3f} ms")
        print(f"w4 bf16 decode, {name}: {st['tokens_per_s']:.2f} tok/s, "
              f"{st['median_latency_s'] * 1e3:.3f} ms/token, device time a "
              f"step {busy}, peak {st['peak_memory_mib']:.0f} MiB, check ppl "
              f"{st['check_ppl']:.1f}")
    if stats["profile"]["profile_failed"]:
        record["profile_failed"].append("w4 int8")
    return {"launches": launches, "bench": stats, "logits_rel_err": rel,
            "leading_tokens_equal": same, "argmax_flips": flips,
            "layer_check": lc}


def run_speculation(torch, model, record):
    """Speculation at full width on the w4 model: in f32 exact mode
    prompt lookup and a draft of the first DRAFT_LAYERS layers
    (``truncate_for_draft``), each in its device loop (one graph a window)
    and its host loop, held token-identical to greedy ``generate`` with
    their launches held to their windows; the target as its own draft
    (acceptance reported); in bf16 mode the share of tokens that agree
    with greedy, reported, not held: a verify window's linears take the
    decode step's GEMV (``Step.lin``), but its attention is K3 (rope in
    bf16, P rounded to bf16) where a decode step's is K2, as the JAX
    package splits them. The share is also taken with the windows on K1's
    tensor-core kernel (``window_gemv=False``), the routing before windows
    took the GEMV, and one bf16 prompt-lookup window (5 rows) is timed
    with either routing."""
    import numpy as np

    from squeezellm_tpu_torch import engine

    L = model.config.n_layers
    k1_call, d1_call = 4 * L + 1, 4 * DRAFT_LAYERS + 1
    K, ngram = SPECULATIVE
    prompt = np.random.default_rng(12).integers(
        0, model.config.vocab_size, (1, SPEC_PROMPT))
    kw = dict(max_seq=SPEC_MAX_SEQ)
    res = {}
    t0 = time.perf_counter()
    for mode in ("exact", "bf16"):
        dt = torch.float32 if mode == "exact" else torch.bfloat16
        ekw = dict(dtype=dt, cache_dtype=dt, mode=mode)
        eng = engine.Engine(model, **ekw)
        draft = engine.Engine(engine.truncate_for_draft(model, DRAFT_LAYERS),
                              **ekw)
        greedy = eng.generate(prompt, NEW_TOKENS, **kw)
        runs = {}
        for loop in ("device", "host"):
            hl = loop == "host"
            reset_counts()
            runs[f"lookup {loop}"] = (eng.generate_speculative(
                prompt, NEW_TOKENS, draft_len=K, ngram=ngram, host_loop=hl,
                **kw), dict(eng.spec_stats))
            w = eng.spec_stats["windows"]
            if mode == "exact":
                expect_counts(record, f"w4 f32 prompt-lookup speculation, "
                              f"{loop} loop", [k1_call * (1 + w), 0,
                                               L * (1 + w)])
            reset_counts()
            runs[f"draft {loop}"] = (eng.generate_draft_speculative(
                prompt, NEW_TOKENS, draft, draft_len=K, host_loop=hl, **kw),
                dict(eng.spec_stats))
            w = eng.spec_stats["windows"]
            if mode == "exact":
                expect_counts(record, f"w4 f32 draft speculation "
                              f"({DRAFT_LAYERS} layers), {loop} loop", [
                                  k1_call * (1 + w) + d1_call * (1 + K * w),
                                  DRAFT_LAYERS * K * w,
                                  L * (1 + w) + DRAFT_LAYERS])
        if mode == "exact":
            runs["self draft device"] = (eng.generate_draft_speculative(
                prompt, NEW_TOKENS, eng, draft_len=K, **kw),
                dict(eng.spec_stats))
        if mode == "bf16":
            # a fresh engine: a captured window replays the kernels it
            # was captured with
            tc = engine.Engine(model, **ekw, window_gemv=False)
            for name, fn, args in (
                    ("lookup", tc.generate_speculative, ()),
                    ("draft", tc.generate_draft_speculative, (draft,))):
                kw2 = {} if args else dict(ngram=ngram)
                runs[f"{name} device, windows on the tensor cores"] = (
                    fn(prompt, NEW_TOKENS, *args, draft_len=K, **kw2, **kw),
                    dict(tc.spec_stats))
            res["bf16_lookup_window"] = {}
            for label, e in (("GEMV", eng), ("tensor cores", tc)):
                # after a call every token is emitted: each replay of the
                # window verifies its 5 rows at one position
                e.generate_speculative(prompt, NEW_TOKENS, draft_len=K,
                                       ngram=ngram, **kw)
                res["bf16_lookup_window"][label] = window_ms(
                    torch, e._state[2]["window"], f"Engine bf16 prompt-"
                    f"lookup window, {label}", k1_call, label == "GEMV")
            print_window_ms(f"w4 bf16 Engine prompt-lookup window ({K + 1} "
                            f"rows)", res["bf16_lookup_window"])
            del tc
        agree = {k: float(np.mean(v[0][0, SPEC_PROMPT:]
                                  == greedy[0, SPEC_PROMPT:]))
                 for k, v in runs.items()}
        res[mode] = {"agree": agree,
                     "spec_stats": {k: v[1] for k, v in runs.items()}}
        if mode == "exact":
            hold_equal("w4 f32 speculation vs greedy",
                       [v[0] for v in runs.values()],
                       [greedy] * len(runs))
        print(f"w4 {mode} speculation (prompt {SPEC_PROMPT}, {NEW_TOKENS} "
              f"new, draft_len {K}, ngram {ngram}, draft of {DRAFT_LAYERS} "
              f"layers): " + ("token-identical to greedy in every run"
                              if mode == "exact" else
                              "share of tokens equal to greedy (reported) "
                              + str({k: round(v, 3)
                                     for k, v in agree.items()}))
              + "; spec_stats " + str(res[mode]["spec_stats"]))
        del eng, draft
    st = res["exact"]["spec_stats"]["self draft device"]
    print(f"w4 f32 self-draft (the whole target): accepted "
          f"{st['accepted']} of {st['drafted']} drafts in {st['windows']} "
          f"windows [{time.perf_counter() - t0:.1f} s]")
    record["speculation"] = res
    return res


def window_ms(torch, window, label, k1_call, gemv, n=8):
    """Host and device ms of one call of `window` (one verify window: an
    Engine's step program, or a serving engine's ``step_spec_window``)
    over `n` calls after a warm-up call, each of the `n` on the host clock
    together, then traced. Holds its K1 launches to `k1_call` a window,
    all through the GEMV when `gemv`, else none."""
    window()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        window()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / n * 1e3
    k1 = counters()[0]
    on_gemv = k1.variant_launches.get("gemv", 0)
    if k1.launches != k1_call * n or on_gemv != (k1.launches if gemv else 0):
        raise AssertionError(f"{label}: {k1.launches} K1 launches in {n} "
                             f"windows, {on_gemv} of them the GEMV")

    def run():
        for _ in range(n):
            window()

    by_name, why = device_ms_by_kernel(torch, run)
    return {"host_ms": host, "profile_failed": why,
            "device_ms": None if by_name is None
            else sum(by_name.values()) / n,
            "k1_ms": None if by_name is None else sum(
                v for k, v in by_name.items()
                if re.search(r"\b(gemv|mma)_kernel\b", k)) / n}


def print_window_ms(label, reads, smi=""):
    print(f"{label}, linears through K1's GEMV against its tensor-core "
          f"kernel: " + "; ".join(
              f"{k} {r['host_ms']:.3f} ms on the host clock, device "
              + ("not measured" if r["device_ms"] is None else
                 f"{r['device_ms']:.3f} (K1 {r['k1_ms']:.3f})")
              for k, r in reads.items()) + (f" [{smi}]" if smi else ""))


def flushed_device_ms(torch, timer, fn, kernels=None, n=10):
    """Device ms a call of `fn` from a profiler trace of `n` calls, the L2
    flushed before each as Timer does: of the kernels whose names hold one
    of `kernels`, or with None of every kernel but the flush's own (a
    library call that zeroes with the flush's kernel has that part left
    out too); None when the trace holds none. Beside Timer's reading, which
    holds the wrapper's host time whenever the host takes longer to enqueue
    the launch than the card takes to flush."""
    def run():
        for _ in range(n):
            timer.flush.zero_()
            fn()

    run()
    by_name, _ = device_ms_by_kernel(torch, run)
    if not by_name:
        return None
    if kernels is None:
        flush, _ = device_ms_by_kernel(torch, timer.flush.zero_)
        ms = sum(v for k, v in by_name.items() if k not in (flush or {}))
    else:
        ms = sum(v for k, v in by_name.items()
                 if any(p in k for p in kernels))
    return ms / n or None


def paged_case(torch, gen, *, Hkv, ps, maxp, index, W, q8, dtype,
               share=True):
    """One K6-K9 case at 32 query heads of 128: pools of random history
    (bf16 or f32 as `dtype`, or int8 codes with scales), a shuffled page
    table whose first page is shared by every slot that writes beyond it
    (`share`), inactive slots with a zeroed table, and the window's q/k/v as
    head-major views of one fused token-major projection with their rope
    rows. `index` holds lengths (W None: decode) or starts."""
    from squeezellm_tpu_torch.models import common
    from squeezellm_tpu_torch.ops import kv_quant

    dev = torch.device("cuda")
    H, hd, B = 32, 128, len(index)
    P = B * maxp + 3
    pt = torch.randperm(P, generator=gen, device=dev)[: B * maxp].to(
        torch.int32).view(B, maxp).clone()
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    first = idx.long() - (1 if W is None else 0)
    if share:
        sharers = (first >= ps).nonzero()[:, 0]
        pt[sharers, 0] = pt[sharers[0], 0]
    pt[first < 0] = 0
    w = W or 1
    qkv = torch.randn(B, w, (H + 2 * Hkv) * hd, generator=gen,
                      device=dev).to(dtype)
    q = qkv[..., : H * hd].view(B, w, H, hd).transpose(1, 2)
    k = qkv[..., H * hd: (H + Hkv) * hd].view(B, w, Hkv, hd).transpose(1, 2)
    v = qkv[..., (H + Hkv) * hd:].view(B, w, Hkv, hd).transpose(1, 2)
    pools = []
    for _ in range(2):
        hist = torch.randn(P, ps, Hkv, hd, generator=gen, device=dev)
        if q8:
            codes, sc = kv_quant.quantize_rows(hist)
            pools.append((codes.view(P, ps, -1),
                          kv_quant.pool_pack_scales(sc).contiguous()))
        else:
            pools.append((hist.view(P, ps, -1).to(dtype),))
        del hist
    pools = [p[0] for p in pools] + [p[1] for p in pools if len(p) > 1]
    at = first.clamp(min=0)[:, None] + torch.arange(w, device=dev)
    cos, sin = common.rope_cos_sin(at if W else at[:, 0], hd, 10000.0, dtype)
    kw = dict(rope_cos=cos.float().contiguous(),
              rope_sin=sin.float().contiguous())
    if W is None:
        q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    return q, k, v, pools, pt, idx, kw


def check_paged(torch, timer, record, number):
    """K6 (decode) / K7 (decode, int8) / K8 (verify window) / K9 (verify,
    int8) against the plain version: outputs within TOL_ATTN of max |out|,
    the pools after the write equal (int8: codes and scales), at the
    LLaMA-2-7B and Mistral-7B layer shapes, 128- and 16-row pages."""
    import torch.nn.functional as F

    from squeezellm_tpu_torch.ops import paged_attn

    q8, verify = number in (7, 9), number in (8, 9)
    name = (("paged_verify_attention" if verify else "paged_decode_attention")
            + ("_q8" if q8 else ""))
    fn, plain = getattr(paged_attn, name), getattr(paged_attn,
                                                   name + "_plain")
    gen = torch.Generator(device="cuda").manual_seed(20 + number)
    H, hd = 32, 128
    # (kv heads, window, page size, rows a slot can hold, dtype, W, index);
    # two inactive slots each; Mistral's lengths lie on both sides of its
    # window; verify windows start at a page's last rows and cross it; f32
    # activations over 128-row pages are what the served f32 runs give
    # the split cases: positions on both sides of the row split's chunk
    # boundaries (a window from C - 2 crosses a chunk and, with 128-row
    # pages, a page), 16-row pages, a sliding window whose low edge falls
    # inside a chunk; the first is also run slot by slot (the cohort check)
    C = paged_attn.CHUNK
    if verify:
        split = [(32, None, 128, 2048, torch.bfloat16, 5,
                  [C - 2, C - 5, C, 2 * C - 8, 1000, 1021, -1, -1]),
                 (32, 300, 16, 2048, torch.float32, 5,
                  [C - 2, C + 3, 1000, 2043, 297, 700, -1, -1])]
        cases = [(32, None, 128, 2048, torch.bfloat16, 5,
                  [0, 126, 127, 1000, 2043, 120, -1, -1]),
                 (32, None, 16, 2048, torch.float32, 2,
                  [0, 15, 127, 1000, 2046, 31, -1, -1]),
                 (32, None, 128, 2048, torch.float32, 5,
                  [0, 126, 127, 1000, 2043, 252, -1, -1]),
                 (32, None, 128, 2048, torch.bfloat16, 8,
                  [0, 121, 127, 1000, 2040, 250, -1, -1]),
                 (8, 4096, 128, 5120, torch.bfloat16, 5,
                  [0, 126, 4090, 4096, 4995, 4094, -1, -1]),
                 (8, 4096, 16, 5120, torch.float32, 8,
                  [0, 9, 4090, 4096, 4992, 4089, -1, -1]),
                 (8, 4096, 128, 5120, torch.bfloat16, 2,
                  [0, 127, 4095, 4096, 4998, 4094, -1, -1])]
    else:
        split = [(32, None, 128, 2048, torch.bfloat16, None,
                  [C - 1, C, C + 1, 2 * C - 1, 2 * C, 1000, 0, 0]),
                 (32, 300, 16, 2048, torch.float32, None,
                  [C - 1, C + 1, 1000, 2048, 301, 777, 0, 0])]
        llama_len = [1, 127, 128, 129, 1000, 2048, 0, 0]
        mistral_len = [1, 129, 4095, 4096, 4097, 5000, 0, 0]
        cases = [(32, None, 128, 2048, torch.bfloat16, None, llama_len),
                 (32, None, 16, 2048, torch.float32, None, llama_len),
                 (32, None, 128, 2048, torch.float32, None, llama_len),
                 (8, 4096, 128, 5120, torch.bfloat16, None, mistral_len),
                 (8, 4096, 16, 5120, torch.float32, None, mistral_len)]
    worst, worst_rel = 0.0, 0.0
    for c, (Hkv, window, ps, rows, dtype, W, index) in enumerate(split
                                                                 + cases):
        q, k, v, pools, pt, idx, kw = paged_case(
            torch, gen, Hkv=Hkv, ps=ps, maxp=rows // ps, index=index, W=W,
            q8=q8, dtype=dtype)
        kw["sliding_window"] = window
        got_p = [t.clone() for t in pools]
        want_p = [t.clone() for t in pools]
        got = fn(q, k, v, *got_p, pt, idx, **kw)
        want = plain(q, k, v, *want_p, pt, idx, **kw)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        worst, worst_rel = max(worst, abs_err(got, want)), max(worst_rel, err)
        same = [torch.equal(a, b) for a, b in zip(got_p, want_p)]
        idle = bool(got[-2:].any())
        if (err > TOL_ATTN or not all(same) or idle
                or torch.equal(got_p[0], pools[0])):
            raise AssertionError(
                f"K{number} Hkv={Hkv} window={window} ps={ps} W={W} index "
                f"{index}: rel err {err}, pools equal {same}, inactive "
                f"slots' output nonzero {idle}, written "
                f"{not torch.equal(got_p[0], pools[0])}")
        if c == 0:
            # each slot alone on its own copy of the pools: bit-equal to
            # its row of the cohort's call, and the pools the slots wrote
            # one at a time equal the cohort's
            one_p = [t.clone() for t in pools]
            for i in range(len(index)):
                alone = fn(q[i: i + 1], k[i: i + 1], v[i: i + 1], *one_p,
                           pt[i: i + 1].contiguous(), idx[i: i + 1],
                           sliding_window=window,
                           rope_cos=kw["rope_cos"][i: i + 1],
                           rope_sin=kw["rope_sin"][i: i + 1])
                if not torch.equal(alone[0], got[i]):
                    raise AssertionError(f"K{number}: slot {i} alone differs "
                                         f"from its row in the cohort")
            if not all(torch.equal(a, b) for a, b in zip(one_p, got_p)):
                raise AssertionError(f"K{number}: the pools written slot by "
                                     f"slot differ from the cohort's")
            del one_p
        del got_p, want_p, pools

    # timed: 8 slots x PAGED_AT_ROWS valid rows of a LLaMA-2-7B layer, bf16
    # activations, 128-row pages (W = 5 for a verify window), no page shared
    # between slots, so that every valid row is read from memory once
    B, n, Hkv, W = PAGED_SLOTS, PAGED_AT_ROWS, 32, (5 if verify else None)
    w = W or 1
    index = [n - w if verify else n] * B
    q, k, v, pools, pt, idx, kw = paged_case(
        torch, gen, Hkv=Hkv, ps=PAGE_SIZE, maxp=PAGED_MAX_SEQ // PAGE_SIZE,
        index=index, W=W, q8=q8, dtype=torch.bfloat16, share=False)
    plain_p = [t.clone() for t in pools]
    pages = -(-n // PAGE_SIZE)
    if pt[:, :pages].unique().numel() != B * pages:
        raise AssertionError(f"K{number}: the timed case shares pages")
    # each input read once, each output written once: q, the new k/v rows
    # (read, and written to the pool), rope rows, the table entries of the
    # pages that hold valid rows, the index, the n - w rows of k and v that
    # every slot held before, out
    row_bytes = Hkv * (hd + 4) if q8 else Hkv * hd * 2
    nbytes = B * (H * w * hd * 2 + 2 * Hkv * w * hd * 2 + 2 * w * hd * 4
                  + pages * 4 + 4 + 2 * (n - w) * row_bytes
                  + 2 * w * row_bytes + H * w * hd * 4)
    # roped q and p are f32: both products run at the f32 rate; each of the
    # w query rows attends its causal prefix
    pairs = sum(n - w + 1 + i for i in range(w))
    b, by = bound_ms(nbytes, [(4 * B * H * hd * pairs, "f32")])
    # the library yardstick: SDPA over the pages gathered beforehand into a
    # dense bf16 cache (the gather is not timed)
    kd, vd = paged_attn._gather(pools[:2], pools[2:] if q8 else None, pt, Hkv)
    kd = kd[:, :, :n].to(torch.bfloat16).contiguous()
    vd = vd[:, :, :n].to(torch.bfloat16).contiguous()
    q4 = (q if verify else q[:, :, None]).contiguous()
    mask = (torch.ones(w, n, dtype=torch.bool, device="cuda")
            .tril(diagonal=n - w) if verify else None)
    row = dict(slots=B, rows=n, W=w, page_size=PAGE_SIZE, shared_pages=0,
               chunk=C, splits=paged_attn.splits(PAGED_MAX_SEQ),
               ms=timer.ms(lambda: fn(q, k, v, *pools, pt, idx, **kw)),
               device_ms=flushed_device_ms(
                   torch, timer, lambda: fn(q, k, v, *pools, pt, idx, **kw),
                   PAGED_KERNELS),
               plain_ms=timer.ms(lambda: plain(q, k, v, *plain_p, pt, idx,
                                               **kw), iters=5),
               library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                   q4, kd, vd, attn_mask=mask)),
               bound_ms=b, bound_by=by, bytes=nbytes)
    row["gb_s"] = nbytes / row["ms"] / 1e6
    record[f"k{number}_detail"].append(row)
    record[f"k{number}_max_abs_err"] = worst
    dev = row["device_ms"]
    print(f"  K{number} {B} slots x {n} rows{f', W={w}' if verify else ''}: "
          f"{row['ms']:.4f} ms (device time "
          f"{'not measured' if dev is None else f'{dev:.4f}'}; "
          f"bound {b:.4f} by {by}, plain "
          f"{row['plain_ms']:.3f}, sdpa on the gathered dense cache "
          f"{row['library_ms']:.4f}) [{row['gb_s']:.0f} GB/s; "
          f"{row['splits']} splits of {C} positions]")
    print(f"K{number} ok: {len(split) + len(cases)} cases (LLaMA-2-7B and "
          f"Mistral-7B layers, windows 300 and 4096, pages of 128 and 16 "
          f"rows, positions at the {C}-row chunks' boundaries, shared and "
          f"shuffled pages, two inactive slots), pools equal to the plain "
          f"version's, each slot alone bit-equal to its row in the cohort, "
          f"max rel err {worst_rel:.3g} within {TOL_ATTN}, max abs err "
          f"{worst:.3g}")


def paged_requests(config):
    """The 16 requests: eight share a 256-token prefix (two full pages),
    four of 100 and four of 37 tokens. Two prefix requests stand in the
    first eight, so that the other six meet registered pages."""
    import numpy as np

    rng = np.random.default_rng(31)

    def toks(n):
        return rng.integers(0, config.vocab_size, n).tolist()

    prefix = toks(PAGED_PREFIX)
    shared = [prefix + toks(PAGED_SUFFIX) for _ in range(8)]
    mid = [toks(PAGED_LENS[0]) for _ in range(4)]
    short = [toks(PAGED_LENS[1]) for _ in range(4)]
    return (shared[:2] + mid[:3] + short[:3]
            + shared[2:] + mid[3:] + short[3:])


def serve_in_order(eng, prompts, order, sampling):
    """Serve `prompts` admitted in `order`, each under its index as request
    id, by single steps; tokens by request id."""
    pending, out = list(order), {}
    while pending or eng.free_slots() < eng.n_slots:
        while pending and eng.free_slots():
            j = pending.pop(0)
            eng.add_request(prompts[j], NEW_TOKENS, sampling=sampling, _rid=j)
        for rid, r in eng.step().items():
            if r["done"]:
                out[rid] = r["tokens"]
    return out


def run_with_known_drafts(torch, eng, prompts, tokens):
    """`eng.run` over `prompts` with the prompt lookup replaced by drafts
    that are each request's known continuation `tokens` (by request id;
    zeros beyond its end): a teacher-forced speculation, in which a right
    engine accepts every draft. The random model continues no pattern, so
    its own lookups are never accepted."""
    from squeezellm_tpu_torch import serving

    K = eng.speculative[0]
    dev = eng.device
    known = torch.zeros(len(prompts), max(map(len, prompts)) + NEW_TOKENS + K,
                        dtype=torch.long, device=dev)
    for r, p in enumerate(prompts):
        row = list(p) + list(tokens[r])
        known[r, : len(row)] = torch.tensor(row, device=dev)

    def drafts(ctx, pos, draft_len, ngram):
        # each slot's request id from the engine's device buffer (0 for an
        # inactive slot), so a captured window reads it at every replay
        rid = eng._bufs.rids
        at = (pos.clamp(min=0)[:, None] + 1
              + torch.arange(draft_len, device=dev))
        return known[rid[:, None], at.clamp(max=known.shape[1] - 1)]

    lookup = serving._prompt_lookup_draft
    serving._prompt_lookup_draft = drafts
    try:
        return eng.run(prompts, max_new_tokens=NEW_TOKENS)
    finally:
        serving._prompt_lookup_draft = lookup


def paged_layer_check(torch, model, dtype, mode, cache_dtype):
    """A paged regime one layer at a time, as layer_check holds the dense
    ones: two 5-token verify windows and 8 decode steps over a small pool
    (8 slots, two of them inactive), every layer fed the plain path's input
    and a copy of the plain path's pool; kernels vs plain, max |d| / max
    |out|."""
    import dataclasses

    from squeezellm_tpu_torch.models import common

    c, dev = model.config, model.device
    B, W = PAGED_SLOTS, SPECULATIVE[0] + 1
    gen = torch.Generator(device=dev).manual_seed(41)
    pools = common.init_paged_pool(c.n_layers, B + 1, PAGE_SIZE, c.n_kv_heads,
                                   c.head_dim, cache_dtype, dev)
    pt = torch.arange(1, B + 1, dtype=torch.int32, device=dev)[:, None]
    pt[-2:] = 0
    caches = [dict(p, pt=pt.contiguous()) for p in pools]
    pos = torch.zeros(B, dtype=torch.long, device=dev)
    pos[-2:] = -1
    res = {"window": [], "decode": []}
    with torch.no_grad():
        for i in range(2 + 8):
            w = W if i < 2 else 1
            tok = torch.randint(0, c.vocab_size, (B, w), generator=gen,
                                device=dev)
            if i < 2:
                at = pos[:, None] + torch.arange(w, device=dev)
                plain = model._step(dtype, mode, True, window_pos=at,
                                    cache=caches)
            else:
                plain = model._step(dtype, mode, True, decode_pos=pos,
                                    cache=caches)
            kern = dataclasses.replace(plain, plain=False)
            x = model.embed[tok].to(dtype)
            for layer, lc in zip(model.layers, caches):
                copy = {n: (t if n == "pt" else t.clone())
                        for n, t in lc.items()}
                got = layer(x, kern, copy)
                want = layer(x, plain, lc)
                if not torch.isfinite(got).all():
                    raise AssertionError("paged_layer_check: not finite")
                res["window" if i < 2 else "decode"].append(
                    rel_err(got[:-2], want[:-2]))
                x = want
            pos = torch.where(pos < 0, pos, pos + w)
    return res


def profile_paged_step(torch, eng, prompts, steps=8):
    """Wall and device time of one decode step of a serving engine (paged
    or dense) at 8 active slots: admit
    eight requests, warm up, then time `steps` single steps (each ends in
    its own sync) and one window of `steps` steps (one sync), in the order
    steps, window, window, steps, on the host clock; then trace `steps`
    single steps."""
    eng.add_requests(prompts[:PAGED_SLOTS], 6 * steps)
    for _ in range(3):
        eng.step()

    def single():
        for _ in range(steps):
            eng.step()

    def timed_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    def window():
        eng.step_window(steps)

    reads = [timed_ms(fn) for fn in (single, window, window, single)]
    step_ms = (reads[0] + reads[3]) / 2
    window_ms = (reads[1] + reads[2]) / 2
    counts = {}
    by_name, why = device_ms_by_kernel(torch, single, counts)
    cancel_all(eng)
    res = {"step_ms": step_ms, "window_step_ms": window_ms,
           "host_reads_ms": reads, "profile_failed": why,
           "graphs": bool(getattr(eng, "_capture", False))}
    if by_name is not None:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        device = sum(by_name.values()) / steps
        res.update(device_ms_per_step=device,
                   idle_share=1 - device / step_ms,
                   window_idle_share=1 - device / window_ms,
                   paged_attn_ms_per_step=paged_attn_ms(by_name) / steps,
                   decode_attn_ms_per_step=sum(
                       v for k, v in by_name.items()
                       if "decode_attn_kernel" in k) / steps,
                   top_ms_per_step=[[k[:60], v / steps] for k, v in top],
                   **step_shares(by_name, counts, steps))
    return res


def paged_transposed(torch, model, prompts, engine, record, bkw):
    """The paged engine with transposed words attached to its w4 model
    (in place): every call of at most 8 rows, so every decode step at 8
    slots, takes K11 for its linears and K12 for their sidecars, the
    prompts K1 or K4. Greedy f32 tokens of eight requests held to the
    plain path's, then the bf16 step at 8 slots profiled."""
    from squeezellm_tpu_torch.models import fuse

    t0 = time.perf_counter()
    L = model.config.n_layers
    fuse.attach_decode_luts(model, transposed=True)
    few = prompts[:PAGED_SLOTS]
    reset_counts()
    eng = engine()
    got = eng.run(few, max_new_tokens=TRANSPOSED_NEW)
    st = eng.stats
    counts = read_counts()
    want = [0] * 12
    want[0], want[3] = counts[0], counts[3]  # a prompt's rows pick K1 or K4
    want[2] = L * st["prefills"]
    want[5] = L * st["decode_steps"]
    want[10] = (4 * L + 1) * st["decode_steps"] + st["prefills"]  # lm_head
    want[11] = 4 * L * st["decode_steps"]
    if counts[0] + counts[3] != 4 * L * st["prefills"]:
        raise AssertionError(f"paged transposed: K1 {counts[0]} + K4 "
                             f"{counts[3]} launches for {st['prefills']} "
                             f"prefills")
    launches = expect_counts(record, "paged transposed f32", want)
    ref = engine(plain=True).run(few, max_new_tokens=TRANSPOSED_NEW)
    if got != ref:
        bad = [r for r in ref if got[r] != ref[r]]
        raise AssertionError(f"paged transposed f32: requests {bad} differ "
                             f"from the plain path: "
                             f"{[(got[r], ref[r]) for r in bad[:2]]}")
    print(f"paged transposed f32 greedy: {len(few)} requests of "
          f"{TRANSPOSED_NEW} new tokens identical to the plain path; "
          f"{st['prefills']} prefills, {st['decode_steps']} decode steps; "
          f"launches K1..K12 {launches}, K12's copies of x "
          f"{record['paths'][-1]['variants']['K12 copies of x']}")
    prof = profile_paged_step(torch, engine(**bkw), prompts)
    prof_eager = profile_paged_step(torch, engine(graphs=False, **bkw),
                                    prompts)
    secs = time.perf_counter() - t0
    print(f"[paged with transposed words: {secs:.1f} s of the paged phase]")
    return {"tokens": got, "launches": launches, "seconds": secs,
            "profile": prof, "profile_eager": prof_eager}


def paged_attn_ms(by_name):
    """Device ms of K6-K9 (one kernel template) in a trace's sums."""
    return sum(v for k, v in by_name.items()
               if any(p in k for p in PAGED_KERNELS))


def cancel_all(eng):
    for s in list(eng._slots):
        if s.active:
            eng.cancel(s.request_id)


def profile_spec_window(torch, eng, prompts, windows=4):
    """Host and device time of one speculative window at 8 active slots
    (an engine made with speculative=SPECULATIVE): admit eight requests,
    run two windows, time `windows` windows on the host clock (each ends
    in its sync), then trace as many."""
    eng.add_requests(prompts[:PAGED_SLOTS], 2 * NEW_TOKENS)
    for _ in range(2):
        eng.step_spec_window()

    def run():
        for _ in range(windows):
            eng.step_spec_window()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()  # each window ends in its own sync
    host = (time.perf_counter() - t0) / windows * 1e3
    by_name, why = device_ms_by_kernel(torch, run)
    cancel_all(eng)
    graphed = bool(getattr(eng, "_capture", False))
    if by_name is None:
        return {"profile_failed": why, "graphs": graphed,
                "host_ms_per_window": host}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    device = sum(by_name.values()) / windows
    return {"profile_failed": None, "graphs": graphed,
            "host_ms_per_window": host, "idle_share": 1 - device / host,
            "device_ms_per_window": device,
            "paged_attn_ms_per_window": paged_attn_ms(by_name) / windows,
            "top_ms_per_window": [[k[:60], v / windows] for k, v in top]}


def run_paged(torch, config, record, smi):
    """PagedContinuousBatchEngine on LLaMA-2-7B w4 at full width and
    SERVE_LAYERS layers (``config``): 8 slots over 160 pages of 128
    rows."""
    from squeezellm_tpu_torch import serving, synthetic
    from squeezellm_tpu_torch.models import fuse
    from squeezellm_tpu_torch.sampling import SamplingParams

    L = config.n_layers
    k1_call = 4 * L + 1
    model = fuse.fuse_for_decode(synthetic.quantized_llama(config, 4, seed=4))
    prompts = paged_requests(config)
    n_new = len(prompts) * NEW_TOKENS
    unshared = sum(-(-(len(p) + NEW_TOKENS + SPECULATIVE[0] + 1) // PAGE_SIZE)
                   for p in prompts)
    res = {"runs": {}, "unshared_pages": unshared}

    def engine(**kw):
        kw.setdefault("cache_dtype", torch.float32)
        return serving.PagedContinuousBatchEngine(
            model, slots=PAGED_SLOTS, n_pages=PAGED_PAGES,
            page_size=PAGE_SIZE, max_seq=PAGED_MAX_SEQ, **kw)

    def timed(label, eng, serve, paged_kernels=(5, 7)):
        """One run of the 16 requests: tokens by request id. Holds the
        launch counts to the engine's own count of model calls, the pages
        to the pool's books."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(eng)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = eng.stats
        want = [0] * 12
        if not eng.plain:
            want[0] = k1_call * (st["prefills"] + st["decode_steps"]
                                 + st["spec_windows"])
            want[2] = L * st["prefills"]
            want[paged_kernels[0]] = L * st["decode_steps"]
            want[paged_kernels[1]] = L * st["spec_windows"]
        launches = expect_counts(record, f"paged {label}", want)
        pool = eng.pool
        cached = set(pool._registry.values())
        if (sorted(out) != list(range(len(prompts)))
                or any(len(t) != NEW_TOKENS for t in out.values())
                or pool.pages_in_use() != 0
                or len(set(pool._free) | cached) != PAGED_PAGES
                or pool.allocated >= unshared):
            raise AssertionError(
                f"paged {label}: requests {sorted(out)}, pages in use "
                f"{pool.pages_in_use()}, free {len(pool._free)}, cached "
                f"{len(cached)}, allocated {pool.allocated} (unshared "
                f"{unshared})")
        res["runs"][label] = dict(
            seconds=secs, tok_s=n_new / secs, launches=launches, stats=st,
            pages_allocated=pool.allocated)
        acc = (f", accept rate {st['accepted'] / max(st['drafted'], 1):.3f} "
               f"({st['accepted']} of {st['drafted']} drafts, "
               f"{st['spec_windows']} windows)" if st["spec_windows"] else "")
        print(f"paged {label}: {n_new} tokens in {secs:.2f} s, "
              f"{n_new / secs:.1f} generated tok/s{acc}; {st['prefills']} "
              f"prefills, {st['decode_steps']} decode steps; pages "
              f"allocated {pool.allocated} (unshared {unshared}), all free "
              f"or cached again; launches K1..K12 {launches} [{smi}]")
        return out

    def run(eng, **kw):
        return eng.run(prompts, max_new_tokens=NEW_TOKENS, **kw)

    # (i) f32, greedy: single steps, windows of 8, speculation, the plain path
    torch.cuda.reset_peak_memory_stats()
    step = timed("f32 step", engine(), run)
    res["peak_mib_f32_pool"] = torch.cuda.max_memory_allocated() / 2**20
    hold_equal("paged f32 step, graphed vs eager",
               timed("f32 step, eager", engine(graphs=False), run), step)
    window = timed("f32 step_window(8)", engine(),
                   lambda e: run(e, window=8))
    spec = timed(f"f32 speculative={SPECULATIVE}",
                 engine(speculative=SPECULATIVE), run)
    plain = timed("f32 step, plain", engine(plain=True), run)
    for label, got in (("step_window(8)", window), ("speculative", spec),
                       ("plain", plain)):
        if got != step:
            bad = [r for r in step if got[r] != step[r]]
            raise AssertionError(
                f"paged f32 greedy: {label} differs from step in requests "
                f"{bad}: {[(got[r], step[r]) for r in bad[:2]]}")
    res["tokens"] = step
    print(f"paged f32 greedy: step, step_window(8), speculative and the "
          f"plain path give the same {NEW_TOKENS} tokens for each of the "
          f"{len(prompts)} requests")

    # (i') speculation that accepts: the drafts are the step run's own
    # tokens, so every window must accept all it was offered, advance by
    # that many rows, and decode on from the rows its K8 launches wrote
    K = SPECULATIVE[0]
    eng = engine(speculative=SPECULATIVE)
    forced = timed(f"f32 speculative={SPECULATIVE}, drafts from the step "
                   f"run", eng,
                   lambda e: run_with_known_drafts(torch, e, prompts, step))
    full, rest = divmod(NEW_TOKENS, K + 1)
    want_drafted = len(prompts) * K * (full + bool(rest))
    want_accepted = len(prompts) * (full * K + rest)
    st = eng.stats
    if (forced != step or st["drafted"] != want_drafted
            or st["accepted"] < want_accepted):
        bad = [r for r in step if forced[r] != step[r]]
        raise AssertionError(
            f"paged f32 speculation with known drafts: requests {bad} "
            f"differ from step; drafted {st['drafted']} (want "
            f"{want_drafted}), accepted {st['accepted']} (want at least "
            f"{want_accepted})")
    print(f"paged f32 speculation with the step run's tokens as drafts: "
          f"{st['accepted']} of {st['drafted']} accepted (every draft that "
          f"a request still needed), {full + bool(rest)} windows a request, "
          f"the same tokens as step")
    del eng  # its f32 pool must not stand in the later regimes' peaks

    # (ii) f32, sampled: repeated, and admitted in another order
    sp = SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
    order = list(range(len(prompts)))
    a = timed("f32 sampled", engine(seed=5), lambda e: run(e, sampling=sp))
    b = timed("f32 sampled, repeated", engine(seed=5),
              lambda e: run(e, sampling=sp, window=8))
    c = timed("f32 sampled, admitted in reverse", engine(seed=5),
              lambda e: serve_in_order(e, prompts, order[::-1], sp))
    if not (a == b == c) or a == step:
        raise AssertionError(
            f"paged sampled: repeated equal {a == b}, reverse admission "
            f"equal {a == c}, equal to greedy {a == step}")
    print("paged f32 sampled (temperature 0.8, top-k 40, top-p 0.95): the "
          "same tokens when repeated in windows of 8 and when admitted in "
          "reverse order, other than greedy's")
    # (ii') the bf16 regime, sampled: a request's tokens do not depend on
    # the cohort it is prefilled and decoded in (K1's tensor-core split is
    # fixed per shape, the call site picks K1's kernel, K3's rows are
    # computed alone), though admitted singly and in reverse order the
    # prompts meet other cohorts and other prefix hits
    bkw = dict(dtype=torch.bfloat16, mode="bf16", cache_dtype=torch.bfloat16)
    ab = timed("bf16 sampled", engine(seed=5, **bkw),
               lambda e: run(e, sampling=sp))
    cb = timed("bf16 sampled, admitted in reverse", engine(seed=5, **bkw),
               lambda e: serve_in_order(e, prompts, order[::-1], sp))
    if ab != cb:
        bad = [r for r in ab if ab[r] != cb[r]]
        raise AssertionError(f"paged bf16 sampled: reverse admission differs "
                             f"in requests {bad}: "
                             f"{[(ab[r], cb[r]) for r in bad[:2]]}")
    hold_equal("paged bf16 sampled, admitted in reverse, graphed vs eager",
               timed("bf16 sampled, admitted in reverse, eager",
                     engine(seed=5, graphs=False, **bkw),
                     lambda e: serve_in_order(e, prompts, order[::-1], sp)),
               cb)
    res["bf16_sampled_tokens"] = ab
    print("paged bf16 sampled: the same tokens for each of the "
          f"{len(prompts)} requests when admitted in reverse order, one at a "
          "time, graphed and eager")
    for sfx, g in (("", True), ("_eager", False)):
        res["profile_f32" + sfx] = profile_paged_step(
            torch, engine(graphs=g), prompts)
        res["profile_spec_f32" + sfx] = profile_spec_window(
            torch, engine(speculative=SPECULATIVE, graphs=g), prompts)

    # (iii) the bf16 regime and the int8 pool: per layer against the plain
    # path; full-depth token agreement reported only
    regimes = (("bf16", torch.bfloat16, "bf16", torch.bfloat16,
                TOL_LAYER_BF16, (5, 7)),
               ("int8 pool", torch.float32, "exact", "int8", TOL_LAYER_INT8,
                (6, 8)))
    for label, dtype, mode, cache_dtype, limit, kernels in regimes:
        kw = dict(dtype=dtype, mode=mode, cache_dtype=cache_dtype)
        torch.cuda.reset_peak_memory_stats()
        got = timed(f"{label} step_window(8)", engine(**kw),
                    lambda e: run(e, window=8), kernels)
        res[f"peak_mib_{label}"] = torch.cuda.max_memory_allocated() / 2**20
        got_spec = timed(f"{label} speculative={SPECULATIVE}",
                         engine(speculative=SPECULATIVE, **kw), run, kernels)
        ref = timed(f"{label} step_window(8), plain",
                    engine(plain=True, **kw), lambda e: run(e, window=8),
                    kernels)
        lc = paged_layer_check(torch, model, dtype, mode, cache_dtype)
        worst = {k: max(v) for k, v in lc.items()}
        agree = [sum(int(x == y) for x, y in zip(got[r], ref[r]))
                 for r in sorted(ref)]
        lead = [next((i for i, (x, y) in enumerate(zip(got[r], ref[r]))
                      if x != y), NEW_TOKENS) for r in sorted(ref)]
        spec_same = sum(got_spec[r] == got[r] for r in got)
        res[label] = dict(layer_check=lc, tokens_equal_plain=agree,
                          leading_tokens_equal_plain=lead,
                          speculative_requests_equal=spec_same)
        if max(worst.values()) > limit:
            raise AssertionError(f"paged {label}: per layer kernels vs "
                                 f"plain {worst} above {limit}")
        print(f"paged {label} per layer (verify window, decode): kernels vs "
              f"plain max {worst['window']:.3g}, {worst['decode']:.3g} "
              f"(limit {limit:.3g}); full depth (reported, not held): "
              f"{sum(agree)} of {n_new} tokens equal the plain path's, "
              f"leading tokens equal per request min {min(lead)} median "
              f"{sorted(lead)[len(lead) // 2]}; speculative equals windows "
              f"in {spec_same} of {len(got)} requests")
        if label == "bf16":
            res["profile_bf16"] = profile_paged_step(torch, engine(**kw),
                                                     prompts)
            res["profile_bf16_eager"] = profile_paged_step(
                torch, engine(graphs=False, **kw), prompts)
    res["transposed"] = paged_transposed(torch, model, prompts, engine,
                                         record, bkw)
    res["profile_bf16_transposed"] = res["transposed"].pop("profile")
    res["profile_bf16_transposed_eager"] = res["transposed"].pop(
        "profile_eager")
    print_host_device("paged step at 8 slots", [
        (f"{label} {kind}", res[f"profile_{label}{sfx}"])
        for label in ("f32", "bf16", "bf16_transposed")
        for kind, sfx in (("eager", "_eager"), ("graphed", ""))], record)
    print_host_device(f"paged f32 speculative window (W = "
                      f"{SPECULATIVE[0] + 1}) at 8 slots", [
        (kind, res[f"profile_spec_f32{sfx}"])
        for kind, sfx in (("eager", "_eager"), ("graphed", ""))], record)
    for label in ("f32", "bf16", "bf16_transposed"):
        prof = res[f"profile_{label}"]
        if prof["profile_failed"]:
            record["profile_failed"].append(f"paged {label}")
            print(f"paged {label} step at 8 slots: {prof['step_ms']:.2f} ms "
                  f"on the host clock ({prof['window_step_ms']:.2f} in a "
                  f"window of 8); PROFILE FAILED, device time not "
                  f"measured: {prof['profile_failed']} [{smi}]")
        else:
            print(f"paged {label} step at 8 slots: {prof['step_ms']:.2f} ms "
                  f"on the host clock ({prof['window_step_ms']:.2f} in a "
                  f"window of 8; reads step, window, window, step "
                  f"{[round(r, 2) for r in prof['host_reads_ms']]}), "
                  f"device busy "
                  f"{prof['device_ms_per_step']:.3f} ms (idle share "
                  f"{prof['idle_share']:.3f}; K6 "
                  f"{prof['paged_attn_ms_per_step']:.3f}; " + ", ".join(
                      f"{k} {v:.3f}" for k, v in
                      prof["ms_per_step_by_kernel"].items())
                  + f"; {prof['launches_per_step']:.0f} device launches a "
                  f"step); top: " + "; ".join(
                      f"{k} {v:.3f}" for k, v in prof["top_ms_per_step"])
                  + f" [{smi}]")
    spec = res["profile_spec_f32"]
    if spec["profile_failed"]:
        record["profile_failed"].append("paged speculative window")
        print(f"paged f32 speculative window: PROFILE FAILED, device time "
              f"not measured: {spec['profile_failed']} [{smi}]")
    else:
        print(f"paged f32 speculative window (W = {SPECULATIVE[0] + 1}) at 8 "
              f"slots: device busy {spec['device_ms_per_window']:.3f} ms, "
              f"K8 {spec['paged_attn_ms_per_window']:.3f}; top: " + "; ".join(
                  f"{k} {v:.3f}" for k, v in spec["top_ms_per_window"])
              + f" [{smi}]")
    print(f"paged peak MiB: f32 pool {res['peak_mib_f32_pool']:.0f}, bf16 "
          f"pool {res['peak_mib_bf16']:.0f}, int8 pool "
          f"{res['peak_mib_int8 pool']:.0f} [{smi}]")
    record["paged"] = res


def run_dense_slots(torch, config, record, smi):
    """ContinuousBatchEngine on LLaMA-2-7B w4 at full width and
    SERVE_LAYERS layers (``config``): 8
    slots of a 512-row dense cache, the paged phase's 16 requests with 32
    new tokens each (300-token prompts admitted six at a time reach 1024
    rows: K4 and a library GEMM serve that prefill)."""
    import numpy as np

    from squeezellm_tpu_torch import serving, synthetic
    from squeezellm_tpu_torch.models import common, fuse
    from squeezellm_tpu_torch.sampling import SamplingParams

    L = config.n_layers
    k1_call = 4 * L + 1
    t0 = time.perf_counter()
    model = fuse.fuse_for_decode(synthetic.quantized_llama(config, 4, seed=4))
    prompts = paged_requests(config)
    n_new = len(prompts) * NEW_TOKENS
    res = {"runs": {}}

    def engine(**kw):
        kw.setdefault("cache_dtype", torch.float32)
        return serving.ContinuousBatchEngine(
            model, slots=PAGED_SLOTS, max_seq=DENSE_MAX_SEQ, **kw)

    def timed(label, eng, serve):
        """One run of the 16 requests: tokens by request id. Holds the
        launch counts to the engine's own count of model calls (a prefill
        of 1024 rows and more: K4 for the layers' linears)."""
        rows = []
        prefill = eng._prefill

        def counted(tokens, dense, start):
            rows.append(tokens.numel())
            prefill(tokens, dense, start)

        eng._prefill = counted
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(eng)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = eng.stats
        want = [0] * 12
        if not eng.plain:
            big = sum(n >= 1024 for n in rows)
            want[0] = (k1_call * (len(rows) + st["decode_steps"]
                                  + st["spec_windows"]) - 4 * L * big)
            want[2] = L * len(rows)
            want[3] = 4 * L * big
            want[4 if common.is_int8(eng.cache_dtype) else 1] = (
                L * st["decode_steps"])
        launches = expect_counts(record, f"dense {label}", want)
        if (sorted(out) != list(range(len(prompts)))
                or any(len(t) != NEW_TOKENS for t in out.values())
                or eng.free_slots() != PAGED_SLOTS
                or (eng._pos != -1).any()):
            raise AssertionError(f"dense {label}: requests {sorted(out)}, "
                                 f"free slots {eng.free_slots()}")
        res["runs"][label] = dict(seconds=secs, tok_s=n_new / secs,
                                  launches=launches, stats=dict(st),
                                  prefill_rows=rows)
        acc = (f", accept rate {st['accepted'] / max(st['drafted'], 1):.3f}"
               f" ({st['accepted']} of {st['drafted']} drafts, "
               f"{st['spec_windows']} windows)" if st["spec_windows"] else "")
        print(f"dense {label}: {n_new} tokens in {secs:.2f} s, "
              f"{n_new / secs:.1f} generated tok/s{acc}; {len(rows)} "
              f"prefills of {rows} rows, {st['decode_steps']} decode steps; "
              f"launches K1..K12 {launches} [{smi}]")
        return out

    def run(eng, **kw):
        return eng.run(prompts, max_new_tokens=NEW_TOKENS, **kw)

    # (i) f32 greedy: single steps graphed and eager, windows of 8,
    # speculation graphed and eager, the plain path
    step = timed("f32 step", engine(), lambda e: run(e, window=1))
    hold_equal("dense f32 step, graphed vs eager",
               timed("f32 step, eager", engine(graphs=False),
                     lambda e: run(e, window=1)), step)
    runs = {"step_window(8)": timed("f32 step_window(8)", engine(),
                                    lambda e: run(e, window=8))}
    for sfx, g in (("", True), (", eager", False)):
        runs[f"speculative{sfx}"] = timed(
            f"f32 speculative={SPECULATIVE}{sfx}",
            engine(speculative=SPECULATIVE, graphs=g), run)
    runs["plain"] = timed("f32 step, plain", engine(plain=True),
                          lambda e: run(e, window=1))
    for label, got in runs.items():
        hold_equal(f"dense f32 greedy, {label} vs step", got, step)
    res["tokens"] = step
    print(f"dense f32 greedy: step (graphed and eager), step_window(8), "
          f"speculative (graphed and eager) and the plain path give the "
          f"same {NEW_TOKENS} tokens for each of the {len(prompts)} requests")
    if "paged" in record and record["paged"].get("tokens") is not None:
        same = sum(record["paged"]["tokens"][r] == step[r] for r in step)
        print(f"dense f32 greedy equals the paged engine's in {same} of "
              f"{len(step)} requests (reported)")

    # (ii) bf16 sampled, admitted one at a time in reverse order: graphed
    # and eager give the same tokens
    sp = SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
    bkw = dict(dtype=torch.bfloat16, mode="bf16", cache_dtype=torch.bfloat16)
    order = list(range(len(prompts)))[::-1]
    sampled = timed("bf16 sampled, admitted in reverse",
                    engine(seed=5, **bkw),
                    lambda e: serve_in_order(e, prompts, order, sp))
    hold_equal("dense bf16 sampled, admitted in reverse, graphed vs eager",
               timed("bf16 sampled, admitted in reverse, eager",
                     engine(seed=5, graphs=False, **bkw),
                     lambda e: serve_in_order(e, prompts, order, sp)),
               sampled)
    print("dense bf16 sampled (temperature 0.8, top-k 40, top-p 0.95), "
          "admitted in reverse one at a time: graphed equals eager")

    # (iii) the int8 cache (K5); its tokens against f32's reported
    q8 = timed("int8 cache step_window(8)", engine(cache_dtype="int8"),
               lambda e: run(e, window=8))
    res["int8_tokens_equal_f32"] = sum(
        int(a == b) for r in step for a, b in zip(q8[r], step[r]))
    print(f"dense int8 cache: {res['int8_tokens_equal_f32']} of {n_new} "
          f"tokens equal the f32 cache's (reported)")

    # (iv) one bf16 decode step at 8 active slots: 129 K1 launches, all the
    # GEMV, and 32 K2
    eng = engine(**bkw)
    eng.add_requests(prompts[:PAGED_SLOTS], 8)
    eng.step()  # the capture
    reset_counts()
    eng.step()
    torch.cuda.synchronize()
    gemv = counters()[0].variant_launches.get("gemv", 0)
    res["decode_step_launches"] = expect_counts(
        record, "dense bf16 decode step at 8 slots", [k1_call, L])
    if gemv != k1_call:
        raise AssertionError(f"dense decode step: {gemv} of {k1_call} K1 "
                             f"launches ran the GEMV")
    cancel_all(eng)
    print(f"dense bf16 decode step at {PAGED_SLOTS} slots: launches K1..K12 "
          f"{res['decode_step_launches']}, all {gemv} K1 launches the GEMV")
    del eng

    # (v) host and device time a step at 8 active slots, beside the paged
    # engine's from its phase
    for label, kw in (("f32", {}), ("bf16", bkw)):
        for sfx, g in (("_eager", False), ("", True)):
            res[f"profile_{label}{sfx}"] = profile_paged_step(
                torch, engine(graphs=g, **kw), prompts)
    cases = [(f"dense {label} {kind}", res[f"profile_{label}{sfx}"])
             for label in ("f32", "bf16")
             for kind, sfx in (("eager", "_eager"), ("graphed", ""))]
    paged = record.get("paged", {})
    cases += [(f"paged {label} graphed", paged[f"profile_{label}"])
              for label in ("f32", "bf16") if f"profile_{label}" in paged]
    print_host_device("serving step at 8 slots", cases, record)
    for label in ("f32", "bf16"):
        prof = res[f"profile_{label}"]
        if prof["profile_failed"]:
            continue
        print(f"dense {label} step at 8 slots: {prof['step_ms']:.2f} ms on "
              f"the host clock ({prof['window_step_ms']:.2f} in a window of "
              f"8), device busy {prof['device_ms_per_step']:.3f} ms (idle "
              f"share {prof['idle_share']:.3f}; K2 "
              f"{prof['decode_attn_ms_per_step']:.3f}; " + ", ".join(
                  f"{k} {v:.3f}" for k, v in
                  prof["ms_per_step_by_kernel"].items())
              + f"); top: " + "; ".join(
                  f"{k} {v:.3f}" for k, v in prof["top_ms_per_step"])
              + f" [{smi}]")
    # one speculative window of an engine of 2 slots (10 rows), its
    # linears through K1's GEMV (the default) and its tensor-core kernel
    res["spec_window_2_slots"] = {}
    for label, g in (("GEMV", True), ("tensor cores", False)):
        eng = serving.ContinuousBatchEngine(
            model, slots=2, max_seq=DENSE_MAX_SEQ, speculative=SPECULATIVE,
            window_gemv=g, **bkw)
        eng.add_requests(prompts[:2], 3 * NEW_TOKENS)
        eng.step_spec_window()  # the capture
        res["spec_window_2_slots"][label] = window_ms(
            torch, eng.step_spec_window, f"dense bf16 speculative window at "
            f"2 slots, {label}", k1_call, g)
        cancel_all(eng)
        del eng
    print_window_ms(f"dense bf16 speculative window at 2 slots "
                    f"({2 * (SPECULATIVE[0] + 1)} rows)",
                    res["spec_window_2_slots"], smi)
    # admission into a free slot (a prefill into a staging cache of the
    # prompt's rows, then the rows into the slot): host and device ms
    eng = engine(**bkw)
    rng = np.random.default_rng(43)
    res["admission"] = {}
    for n in (16, 300):
        prompt = rng.integers(0, config.vocab_size, n).tolist()

        def admit():
            eng.add_request(prompt, 4)
            torch.cuda.synchronize()
            cancel_all(eng)

        admit()  # the first admission of this length
        t1 = time.perf_counter()
        admit()
        host = (time.perf_counter() - t1) * 1e3
        by_name, why = device_ms_by_kernel(torch, admit)
        dev = None if by_name is None else sum(by_name.values())
        res["admission"][n] = {"host_ms": host, "device_ms": dev,
                               "profile_failed": why}
    del eng
    print("dense bf16 admission of one prompt into a free slot: " + "; ".join(
        f"{n} tokens {a['host_ms']:.2f} ms on the host clock, device "
        + ("not measured" if a["device_ms"] is None
           else f"{a['device_ms']:.2f} ms")
        for n, a in res["admission"].items()) + f" [{smi}]")
    served = {lab: res["runs"][lab]["tok_s"] for lab in
              ("f32 step", "f32 step_window(8)",
               f"f32 speculative={SPECULATIVE}")}
    paged_runs = paged.get("runs", {})
    print("served tok/s, dense against paged (16 requests, 32 new tokens, 8 "
          "slots): " + "; ".join(
              f"{lab} {v:.1f} against "
              + (f"{paged_runs[lab]['tok_s']:.1f}" if lab in paged_runs
                 else "not measured") for lab, v in served.items())
          + f" [{smi}]")

    # (vi) the HTTP front end over the bf16 engine, then (vii) serve-bench
    res["serve"] = serve_over_http(torch, model, bkw, record, smi)
    del model
    torch.cuda.empty_cache()
    res["serve_bench"] = serve_bench_in_process(torch, smi)
    print(f"[dense-slot serving, model made and served: "
          f"{time.perf_counter() - t0:.1f} s]")
    record["dense_slots"] = res


def serve_over_http(torch, model, bkw, record, smi):
    """server.serve over the bf16 dense engine (8 slots): eight concurrent
    completions from threads through urllib (one streamed, one sampled
    with every eighth token id a stop token, six greedy), each greedy answer
    held token-identical to the same prompt through run() on a fresh
    engine; /health answers; the launches held to the engine's calls (the
    warm-up's one-token prompt included, a decode step's); a failed loop
    fails the phase."""
    import threading
    import urllib.request

    import numpy as np

    from squeezellm_tpu_torch import server, serving

    L = model.config.n_layers
    k1_call = 4 * L + 1
    vocab = model.config.vocab_size
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, vocab, n).tolist() for n in SERVE_LENS]
    stop = list(range(0, vocab, 8))  # ~1 in 8 draws stops the request
    bodies = [dict(prompt_tokens=p, max_tokens=NEW_TOKENS) for p in prompts]
    bodies[0]["stream"] = True
    bodies[1].update(temperature=0.8, top_k=40, top_p=0.95, stop=stop)
    eng = serving.ContinuousBatchEngine(model, slots=PAGED_SLOTS,
                                        max_seq=DENSE_MAX_SEQ, **bkw)
    reset_counts()
    t0 = time.perf_counter()
    srv = server.serve(eng, port=0, window=8)
    warm = time.perf_counter() - t0
    url = f"http://127.0.0.1:{srv.server_port}"
    out, errors = {}, []

    def post(i):
        try:
            req = urllib.request.Request(
                url + "/v1/completions", data=json.dumps(bodies[i]).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                if bodies[i].get("stream"):
                    toks = []
                    for line in r.read().decode().splitlines():
                        if line.startswith("data: {"):
                            toks += json.loads(line[6:])["tokens"]
                    out[i] = {"tokens": toks, "finish_reason": "length"}
                else:
                    out[i] = json.load(r)
        except Exception as e:  # the phase fails below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        t1 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        secs = time.perf_counter() - t1
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.load(r)
    finally:
        srv.serving_loop.shutdown()
        srv.shutdown()
    if srv.serving_loop.failed or errors or len(out) != len(bodies):
        raise AssertionError(f"serve: loop failed {srv.serving_loop.failed}"
                             f", errors {errors}, answers {sorted(out)}")
    st = eng.stats
    launches = expect_counts(record, "dense bf16 over HTTP", [
        k1_call * (st["prefills"] + st["decode_steps"]),
        L * (st["decode_steps"] + 1), L * (st["prefills"] - 1)])
    greedy = [i for i in range(len(bodies)) if i != 1]
    fresh = serving.ContinuousBatchEngine(model, slots=PAGED_SLOTS,
                                          max_seq=DENSE_MAX_SEQ, **bkw)
    want = fresh.run([prompts[i] for i in greedy], max_new_tokens=NEW_TOKENS)
    hold_equal("serve: greedy answers vs run() on a fresh engine",
               {i: out[i]["tokens"] for i in greedy},
               {i: [int(t) for t in want[j]] for j, i in enumerate(greedy)})
    s = out[1]["tokens"]
    stopped = out[1]["finish_reason"] == "stop"
    if (any(t in stop for t in s[:-1]) or (s[-1] in stop) != stopped
            or (not stopped and len(s) != NEW_TOKENS)):
        raise AssertionError(f"serve: sampled request with stop tokens "
                             f"gave {out[1]}")
    if health != {"status": "ok", "free_slots": PAGED_SLOTS,
                  "served": len(bodies)}:
        raise AssertionError(f"serve: /health {health}")
    n = sum(len(o["tokens"]) for o in out.values())
    print(f"serve (bf16 dense engine, {PAGED_SLOTS} slots): warm-up "
          f"{warm:.1f} s; {len(bodies)} concurrent completions (prompts "
          f"{SERVE_LENS[0]}-{SERVE_LENS[-1]} tokens; one streamed, one "
          f"sampled: {len(s)} tokens, finish {out[1]['finish_reason']}) in "
          f"{secs:.2f} s, "
          f"{n / secs:.1f} tok/s; the {len(greedy)} greedy answers equal "
          f"run() on a fresh engine; /health {health}; launches K1..K12 "
          f"{launches} [{smi}]")
    return {"warmup_s": warm, "seconds": secs, "tokens": n,
            "launches": launches, "health": health,
            "sampled_tokens": len(s)}


def serve_bench_in_process(torch, smi):
    """The serve-bench command in this process, on a random LLaMA-2-7B w4
    in bf16 mode (its defaults: 8 slots, 32 requests of 4-31 prompt tokens,
    32 new tokens, windows of 8), dense and --paged: its JSON lines."""
    import contextlib
    import io

    from squeezellm_tpu_torch import cli

    out = {}
    cfg = os.path.join(HERE, "models", "llama-2-7b", "config.json")
    for name, flags in (("dense", []), ("paged", ["--paged"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["serve-bench", "--synthetic", cfg, "--wbits", "4",
                      "--mode", "bf16", *flags])
        line = buf.getvalue().strip().splitlines()[-1]
        out[name] = json.loads(line)
        print(f"serve-bench {' '.join(flags) or '(dense)'} "
              f"[{time.perf_counter() - t0:.1f} s, model made]: {line} "
              f"[{smi}]")
        torch.cuda.empty_cache()
    return out


def run_opt(torch, record):
    """OPT-6.7B w4 at full width and depth: one eval group against the
    plain path, and one f32 greedy request."""
    import numpy as np

    from squeezellm_tpu_torch import engine, synthetic
    from squeezellm_tpu_torch.models import fuse, registry

    model_type, cfg = registry.load_config(os.path.join(HERE, "models",
                                                        "opt-6.7b"))
    if model_type != "opt":
        raise AssertionError(model_type)
    t0 = time.perf_counter()
    model = fuse.fuse_for_decode(synthetic.quantized_opt(cfg, 4, seed=6))
    torch.cuda.synchronize()
    print(f"opt-6.7b w4: model made and fused on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    res = {"eval": run_eval(torch, model, "opt-6.7b w4", record,
                            modes=("exact",), strides=EVAL_GROUP)}
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                               (1, OPT_PROMPT))
    reset_counts()
    got = engine.Engine(model).generate(prompt, NEW_TOKENS)
    ropeless = counters()[1].ropeless_launches
    res["launches"] = expect_counts(record, "opt-6.7b w4 request", [
        NEW_TOKENS * (4 * cfg.n_layers + 1), (NEW_TOKENS - 1) * cfg.n_layers,
        cfg.n_layers, 0, 0])
    if ropeless != res["launches"][1]:
        raise AssertionError(f"OPT: {ropeless} of {res['launches'][1]} K2 "
                             "launches ran without rope rows")
    hold_equal("OPT request, graphed vs eager", got, engine.Engine(
        model, graphs=False).generate(prompt, NEW_TOKENS))
    ref = engine.Engine(model, plain=True).generate(prompt, NEW_TOKENS)
    if got.shape != (1, OPT_PROMPT + NEW_TOKENS) or not np.array_equal(got,
                                                                      ref):
        raise AssertionError(f"OPT request: kernel tokens {got} != plain "
                             f"tokens {ref}")
    res["tokens"] = got[0, OPT_PROMPT:].tolist()
    print(f"opt-6.7b w4 request (prompt {OPT_PROMPT}, {NEW_TOKENS} new "
          f"tokens, f32) identical to the plain path and graphed to eager; "
          f"launches K1..K12 "
          f"{res['launches']}, all {ropeless} K2 launches without rope")
    record["opt"] = res


def run_dense(torch, config, record):
    import numpy as np

    from squeezellm_tpu_torch import engine, synthetic

    model = synthetic.dense_llama(config)
    eng = engine.Engine(model, dtype=torch.bfloat16,
                        cache_dtype=torch.bfloat16, mode="bf16")
    ids = (np.arange(BENCH_TOKENS, dtype=np.int64)[None] * 7919) % config.vocab_size
    stats = eng.benchmark(ids, max_seq=BENCH_TOKENS)
    stats["profile"] = profile_decode(torch, eng, ids)
    record["dense_bf16"] = stats
    print(f"bf16 dense: {stats['tokens_per_s']:.2f} tok/s, "
          f"{stats['median_latency_s'] * 1e3:.3f} ms/token, "
          f"{stats['achieved_gb_s']:.1f} GB/s, peak "
          f"{stats['peak_memory_mib']:.0f} MiB")
    print_profile("bf16 dense", stats, record)


def dense_tree(torch, config, seed):
    """A random dense LLaMA tree at the config's widths and depth, made on
    the card from a seed one tensor at a time and kept on the host in bf16
    (an HF checkpoint's precision): the input of Fisher and quantize."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = config.hidden_size

    def w(o, i, scale):
        return (torch.randn(o, i, generator=gen, device="cuda")
                * scale).to(torch.bfloat16).cpu()

    layers = []
    for _ in range(config.n_layers):
        layer = {name: {"w": w(o, i, 0.5 / math.sqrt(i))}
                 for name, (o, i) in config.linear_shapes().items()}
        layer["input_norm"] = torch.ones(h, dtype=torch.bfloat16)
        layer["post_norm"] = torch.ones(h, dtype=torch.bfloat16)
        layers.append(layer)
    return {"embed": w(config.vocab_size, h, 0.02), "layers": layers,
            "final_norm": torch.ones(h, dtype=torch.bfloat16),
            "lm_head": {"w": w(config.vocab_size, h, 0.02)}}


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def run_quantize(torch, config, record):
    """Offline quantization on the card, from a random dense LLaMA-2-7B at
    full width and QUANT_LAYERS layers: Fisher on synthetic calibration
    tokens, then quantize_model twice (w4 with a 0.45% sensitivity sidecar
    and structured codebooks; w3 free with the same sidecar, on the first
    W3_LAYERS layers), both with a quantized lm_head; save_quantized,
    load_quantized, fuse; one f32 request against the plain path (K10 for
    w4, K1 for w3)."""
    import dataclasses
    import shutil

    import numpy as np

    from squeezellm_tpu_torch import checkpoint, data, engine
    from squeezellm_tpu_torch.models import fuse
    from squeezellm_tpu_torch.quantize import gradients, pipeline

    cfg = dataclasses.replace(config, n_layers=QUANT_LAYERS)
    L = cfg.n_layers
    res = {"layers": L, "calib": [FISHER_SAMPLES, FISHER_SEQLEN],
           "seconds": {}}
    secs = res["seconds"]
    t0 = time.perf_counter()
    tree = dense_tree(torch, cfg, seed=21)
    secs["make dense tree"] = time.perf_counter() - t0
    calib, _ = data.get_loaders("synthetic", nsamples=FISHER_SAMPLES,
                                seed=0, seqlen=FISHER_SEQLEN,
                                vocab_size=cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads = gradients.compute_fisher("llama", cfg, tree, calib)
    torch.cuda.synchronize()
    secs["fisher"] = time.perf_counter() - t0
    res["fisher_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    finite = all(bool(torch.isfinite(g).all()) and float(g.max()) > 0
                 for layer in grads for g in layer.values())
    if not finite:
        raise AssertionError("Fisher: grad^2 not finite or all zero")
    print(f"quantize: dense LLaMA-2-7B widths, {L} layers, made in "
          f"{secs['make dense tree']:.1f} s; Fisher over {FISHER_SAMPLES} x "
          f"{FISHER_SEQLEN} synthetic tokens in {secs['fisher']:.1f} s (peak "
          f"{res['fisher_peak_mib']:.0f} MiB)")
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, cfg.vocab_size, (1, PROMPT_LENS[-1]))
    runs = ((4, True, L), (3, False, W3_LAYERS))
    for bits, structured, n in runs:
        label = f"w{bits}" + (" structured" if structured else "")
        cfg_n = dataclasses.replace(cfg, n_layers=n)
        tree_n = dict(tree, layers=tree["layers"][:n])
        stats = {}
        t0 = time.perf_counter()
        specs, params = pipeline.quantize_model(
            "llama", cfg_n, tree_n, bits, gradients_per_layer=grads[:n],
            sensitivity=0.45, quantize_lm_head=True, structured=structured,
            stats=stats)
        total = time.perf_counter() - t0
        path = os.path.join(HERE, "build", f"quantized_w{bits}")
        shutil.rmtree(path, ignore_errors=True)
        t0 = time.perf_counter()
        checkpoint.save_quantized(path, "llama", cfg_n, specs, params)
        res[label] = dict(
            layers=n, total_s=total, stages_s=stats,
            per_layer_s=total / (n + 1),
            save_s=time.perf_counter() - t0,
            checkpoint_bytes=_dir_bytes(path),
            widest_sidecar_row=max(
                int(np.bincount(p["sp_rows"][p["sp_vals"] != 0],
                                minlength=1).max())
                for layer in params["layers"] for p in layer.values()
                if isinstance(p, dict) and "sp_rows" in p))
        del specs, params
    # the dense tree and the grad^2 sums (27 GB on the card) are done with
    del grads, tree, tree_n
    torch.cuda.empty_cache()
    for bits, structured, n in runs:
        label = f"w{bits}" + (" structured" if structured else "")
        path = os.path.join(HERE, "build", f"quantized_w{bits}")
        t0 = time.perf_counter()
        _, model = checkpoint.load_quantized(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        shutil.rmtree(path)
        fuse.fuse_for_decode(model)
        lins = fuse.quant_linears(model)
        with_struct = sum("struct_a" in m.tensors() for m in lins)
        if with_struct != (len(lins) if structured else 0):
            raise AssertionError(f"{label}: {with_struct} of {len(lins)} "
                                 "linears got the structured table")
        tf = tf_logits(torch, model)
        reset_counts()
        got = engine.Engine(model).generate(prompt, NEW_TOKENS)
        k = 9 if structured else 0  # K10 or K1
        want = [0] * 12
        want[k] = NEW_TOKENS * (4 * n + 1)
        want[1], want[2] = (NEW_TOKENS - 1) * n, n
        launches = expect_counts(record, f"quantized {label} request", want)
        ref = engine.Engine(model, plain=True).generate(prompt, NEW_TOKENS)
        if not np.array_equal(got, ref):
            raise AssertionError(f"{label} request: kernel tokens {got} != "
                                 f"plain tokens {ref}")
        r = res[label]
        r.update(load_s=load_s, launches=launches,
                 structured_linears=with_struct, tokens=got[0].tolist(),
                 tf_exact_rel_err=tf)
        print(f"quantize {label}: {r['total_s']:.1f} s for {n} layers and "
              f"the lm_head ({r['per_layer_s']:.2f} s each); stages "
              + ", ".join(f"{n} {v:.1f}" for n, v in r["stages_s"].items())
              + f"; save {r['save_s']:.1f} s "
              f"({r['checkpoint_bytes'] / 2**20:.0f} MiB; widest sidecar row "
              f"{r['widest_sidecar_row']}), load {load_s:.1f} s; "
              f"{with_struct} of {len(lins)} linears structured; f32 request "
              f"({PROMPT_LENS[-1]}-token prompt, {NEW_TOKENS} new) "
              f"token-identical to the plain path, launches K1..K12 "
              f"{launches}; f32 teacher-forced logits rel err {tf:.3g}")
        del model
    record["quantize"] = res


def config_dir(path, n_layers):
    """A model directory holding models/llama-2-7b/config.json cut to
    n_layers: what convert and the staged commands read a config from."""
    with open(os.path.join(HERE, "models", "llama-2-7b", "config.json")) as f:
        hf = json.load(f)
    hf["num_hidden_layers"] = n_layers
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return path


def reference_state_dict(torch, config, bits, seed):
    """The buffers of the reference's QuantLinearLUT for a LLaMA at the
    config's widths and depth, made on the card from a seed and kept on the
    host: words in the reference layout (formats.pack_codes_ref), sorted
    f32 LUTs, a REF_SPARSITY CSR sidecar and REF_TOPX top-X channels per
    linear, fp16 embeddings, norms and lm_head (as published checkpoints
    hold them)."""
    from squeezellm_tpu_torch import formats
    from squeezellm_tpu_torch.models.llama import HF_NAMES

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = config.hidden_size

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    sd = {}
    for li in range(config.n_layers):
        for name, (out_f, in_f) in config.linear_shapes().items():
            p = f"model.layers.{li}.{HF_NAMES[name]}."
            scale = 0.5 / math.sqrt(in_f)
            codes = torch.randint(0, 2**bits, (in_f, out_f), generator=gen,
                                  device="cuda", dtype=torch.uint8)
            sd[p + "qweight"] = formats.pack_codes_ref(codes, bits).cpu()
            sd[p + "lookup_table"] = torch.sort(
                randn(out_f, 2**bits, scale=2 * scale), dim=1).values.cpu()
            mask = torch.rand(out_f, in_f, generator=gen,
                              device="cuda") < REF_SPARSITY
            crow = torch.zeros(out_f + 1, dtype=torch.int32, device="cuda")
            crow[1:] = torch.cumsum(mask.sum(1), 0)
            sd[p + "rows"] = crow.cpu()
            sd[p + "cols"] = torch.nonzero(mask)[:, 1].to(torch.int32).cpu()
            sd[p + "vals"] = randn(int(crow[-1]), scale=8 * scale).cpu()
            sd[p + "full_rows"] = randn(in_f, REF_TOPX, scale=scale).cpu()
            sd[p + "full_row_indices"] = torch.randperm(
                out_f, generator=gen, device="cuda")[:REF_TOPX].to(
                    torch.int32).cpu()
            sd[f"sparse_threshold.{li}.{name}"] = torch.tensor(
                int(crow[-1]))
        lp = f"model.layers.{li}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{lp}{n}.weight"] = (1 + randn(h, scale=0.05)).half().cpu()
    sd["model.embed_tokens.weight"] = randn(config.vocab_size, h,
                                            scale=0.02).half().cpu()
    sd["model.norm.weight"] = (1 + randn(h, scale=0.05)).half().cpu()
    sd["lm_head.weight"] = randn(config.vocab_size, h,
                                 scale=0.02).half().cpu()
    return sd


def reference_weight(torch, sd, p, bits, in_f):
    """The plain dequantization of one linear of the reference state dict,
    on the card: W (in, out) f32, the LUT at the codes unpack_codes_ref
    reads, plus the CSR values (top-X apart)."""
    from squeezellm_tpu_torch import formats

    codes = formats.unpack_codes_ref(sd[p + "qweight"].cuda(), bits, in_f)
    lut = sd[p + "lookup_table"].cuda().float()
    w = torch.take_along_dim(lut.t(), codes.long(), dim=0)
    crow = sd[p + "rows"].cuda().long()
    rows = torch.repeat_interleave(
        torch.arange(crow.numel() - 1, device="cuda"), crow[1:] - crow[:-1])
    cols = sd[p + "cols"].cuda().long()
    w[cols, rows] = w[cols, rows] + sd[p + "vals"].cuda()
    return w


def run_convert(torch, config, record):
    """The reference's packed checkpoints through convert: for w3
    (CONVERT_LAYERS[3] layers) and w4 (CONVERT_LAYERS[4]) a reference-format
    state dict of LLaMA-2-7B at full width, torch.save'd,
    convert_reference_checkpoint on the card, load_quantized. Held: K4's W
    of every converted linear bit-equal in f32 to the reference state
    dict's plain dequantization, top-X equal; then fused, f32
    teacher-forced logits within TOL_TF_EXACT and an f32 request
    token-identical to the plain path (K1, K2, K3)."""
    import dataclasses
    import shutil

    import numpy as np

    from squeezellm_tpu_torch import checkpoint, convert, engine
    from squeezellm_tpu_torch.models import fuse
    from squeezellm_tpu_torch.models.llama import HF_NAMES
    from squeezellm_tpu_torch.ops import dequant_dense as dd

    res = {}
    rng = np.random.default_rng(23)
    prompt = rng.integers(0, config.vocab_size, (1, PROMPT_LENS[-1]))
    root = os.path.join(HERE, "build", "convert")
    for bits, n in sorted(CONVERT_LAYERS.items()):
        shutil.rmtree(root, ignore_errors=True)
        cfg = dataclasses.replace(config, n_layers=n)
        model_dir = config_dir(os.path.join(root, "model"), n)
        pt = os.path.join(root, f"sq-llama-2-7b-w{bits}.pt")
        out = os.path.join(root, "converted")
        r = {"layers": n, "seconds": {}}
        secs = r["seconds"]
        t0 = time.perf_counter()
        sd = reference_state_dict(torch, cfg, bits, seed=40 + bits)
        secs["make"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.save(sd, pt)
        secs["torch.save"] = time.perf_counter() - t0
        r["pt_bytes"] = os.path.getsize(pt)
        stats = {}
        convert.convert_reference_checkpoint(pt, model_dir, bits, out,
                                             stats=stats)
        secs.update({"torch.load": stats["load"],
                     "unpack/repack on the card": stats["convert"],
                     "save": stats["save"]})
        r["checkpoint_bytes"] = _dir_bytes(out)
        t0 = time.perf_counter()
        _, model = checkpoint.load_quantized(out)
        torch.cuda.synchronize()
        secs["load_quantized"] = time.perf_counter() - t0
        # K4 on every converted linear against the reference's own words
        reset_counts()
        worst, shapes = 0.0, 0
        for li, layer in enumerate(model.layers):
            for name, lin in {**layer.attn.proj, **layer.mlp.proj}.items():
                t = lin.tensors()
                out_f, in_f = cfg.linear_shapes()[name]
                p = f"model.layers.{li}.{HF_NAMES[name]}."
                w = dd.dequant_dense(t["qweight"], t["lut"], bits, in_f,
                                     rowptr=t["sp_rowptr"], cols=t["sp_cols"],
                                     vals=t["sp_vals"], mode="exact")
                want = reference_weight(torch, sd, p, bits, in_f)
                if w.dtype != torch.float32 or not torch.equal(w, want):
                    raise AssertionError(
                        f"convert w{bits} layer {li} {name}: K4's W differs "
                        f"from the reference's dequantization in "
                        f"{int((w != want).sum())} of {w.numel()} elements")
                if not (torch.equal(t["topx_weights"].cpu(),
                                    sd[p + "full_rows"].float())
                        and torch.equal(t["topx_indices"].cpu(),
                                        sd[p + "full_row_indices"])):
                    raise AssertionError(f"convert w{bits} layer {li} "
                                         f"{name}: top-X differs")
                worst = max(worst, abs_err(w, want))
                shapes += 1
        r["k4_launches"] = expect_counts(
            record, f"convert w{bits}: K4 on each converted linear",
            [0, 0, 0, shapes])
        r["k4_max_abs_err"] = worst
        del sd
        fuse.fuse_for_decode(model)
        r["tf_exact_rel_err"] = tf_logits(torch, model)
        reset_counts()
        got = engine.Engine(model).generate(prompt, NEW_TOKENS)
        r["launches"] = expect_counts(
            record, f"convert w{bits} request",
            [NEW_TOKENS * 4 * n, (NEW_TOKENS - 1) * n, n])
        ref = engine.Engine(model, plain=True).generate(prompt, NEW_TOKENS)
        hold_equal(f"convert w{bits} request, kernels vs plain", got, ref)
        r["tokens"] = got[0].tolist()
        del model
        shutil.rmtree(root)
        res[f"w{bits}"] = r
        print(f"convert w{bits} (LLaMA-2-7B widths, {n} layers, reference "
              f"layout, {REF_SPARSITY:.2%} CSR, top-X {REF_TOPX}): "
              + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
              + f"; .pt {r['pt_bytes'] / 2**20:.0f} MiB, checkpoint "
              f"{r['checkpoint_bytes'] / 2**20:.0f} MiB; K4's W bit-equal "
              f"to the reference's dequantization at {shapes} linears; f32 "
              f"request ({PROMPT_LENS[-1]}-token prompt, {NEW_TOKENS} new) "
              f"token-identical to the plain path, launches K1..K12 "
              f"{r['launches']}; f32 teacher-forced logits rel err "
              f"{r['tf_exact_rel_err']:.3g}")
    record["convert"] = res


def run_staged(torch, config, record):
    """The staged workflow on a dense LLaMA-2-7B at full width and
    STAGED_LAYERS layers, written as an HF directory (pytorch_model.bin):
    chunk -> outlier-config (IQR range STAGED_RANGE) -> nuq (w4, auto) ->
    pack through the port's functions on the card; nuq again, which skips
    every layer. Held: the packed arrays equal quantize_model's on the same
    tree and thresholds, and an f32 request is token-identical to the
    plain path."""
    import dataclasses
    import shutil

    import numpy as np

    from squeezellm_tpu_torch import checkpoint, engine
    from squeezellm_tpu_torch.models import fuse
    from squeezellm_tpu_torch.models.llama import HF_NAMES
    from squeezellm_tpu_torch.quantize import pipeline, staged

    n = STAGED_LAYERS
    cfg = dataclasses.replace(config, n_layers=n)
    root = os.path.join(HERE, "build", "staged")
    shutil.rmtree(root, ignore_errors=True)
    d = {k: os.path.join(root, k) for k in ("chunks", "nuq", "ckpt")}
    d["oc"] = os.path.join(root, "outlier_config.json")
    hf_dir = config_dir(os.path.join(root, "hf"), n)
    res = {"layers": n, "seconds": {}, "bytes": {}}
    secs = res["seconds"]
    t0 = time.perf_counter()
    tree = dense_tree(torch, cfg, seed=31)
    sd = {"model.embed_tokens.weight": tree["embed"],
          "model.norm.weight": tree["final_norm"],
          "lm_head.weight": tree["lm_head"]["w"]}
    for li, layer in enumerate(tree["layers"]):
        p = f"model.layers.{li}."
        sd.update({f"{p}{hf}.weight": layer[name]["w"]
                   for name, hf in HF_NAMES.items()})
        sd[p + "input_layernorm.weight"] = layer["input_norm"]
        sd[p + "post_attention_layernorm.weight"] = layer["post_norm"]
    torch.save(sd, os.path.join(hf_dir, "pytorch_model.bin"))
    del sd
    secs["write HF dir"] = time.perf_counter() - t0

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    stage("chunk", lambda: staged.chunk_model(hf_dir, d["chunks"]))
    cfg_json = stage("outlier-config", lambda: staged.make_outlier_config(
        d["chunks"], STAGED_RANGE, d["oc"]))
    nuq_stats = {}
    fitted = stage("nuq", lambda: staged.nuq(
        d["chunks"], d["nuq"], 4, outlier_config_json=d["oc"],
        method="auto", stats=nuq_stats))
    again = stage("nuq again", lambda: staged.nuq(
        d["chunks"], d["nuq"], 4, outlier_config_json=d["oc"]))
    if (fitted, again) != (n, 0):
        raise AssertionError(f"staged: nuq fitted {fitted} then {again} "
                             f"layers of {n}")
    stage("pack", lambda: staged.pack(hf_dir, d["nuq"], 4, d["ckpt"]))
    for k in ("hf", "chunks", "nuq", "ckpt"):
        res["bytes"][k] = _dir_bytes(os.path.join(root, k))
    res["nuq_stages_s"] = nuq_stats
    res["outlier_pct"] = cfg_json["outlier_threshold"]
    # the one-shot pipeline on the same tree and thresholds
    t0 = time.perf_counter()
    _, want = pipeline.quantize_model("llama", cfg, tree, 4,
                                      outlier_config=cfg_json[
                                          "outlier_config"])
    secs["quantize_model (to compare)"] = time.perf_counter() - t0
    del tree
    compared = 0
    for li in range(n):
        with np.load(os.path.join(d["ckpt"], f"layer_{li:03d}.npz")) as z:
            got = {k: z[k] for k in z.files}
        flat = {}
        for k, v in want["layers"][li].items():
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
                flat[k if kk is None else f"{k}.{kk}"] = np.asarray(vv)
        if sorted(got) != sorted(flat):
            raise AssertionError(f"staged layer {li}: arrays {sorted(got)} "
                                 f"!= quantize_model's {sorted(flat)}")
        for k, v in flat.items():
            if got[k].dtype != v.dtype or not np.array_equal(got[k], v):
                raise AssertionError(f"staged layer {li} {k}: differs from "
                                     "quantize_model's")
            compared += 1
    del want
    t0 = time.perf_counter()
    _, model = checkpoint.load_quantized(d["ckpt"])
    torch.cuda.synchronize()
    secs["load_quantized"] = time.perf_counter() - t0
    shutil.rmtree(root)
    fuse.fuse_for_decode(model)
    rng = np.random.default_rng(24)
    prompt = rng.integers(0, cfg.vocab_size, (1, PROMPT_LENS[-1]))
    reset_counts()
    got = engine.Engine(model).generate(prompt, NEW_TOKENS)
    res["launches"] = expect_counts(
        record, "staged w4 request",
        [NEW_TOKENS * 4 * n, (NEW_TOKENS - 1) * n, n])
    ref = engine.Engine(model, plain=True).generate(prompt, NEW_TOKENS)
    hold_equal("staged w4 request, kernels vs plain", got, ref)
    res.update(tokens=got[0].tolist(), arrays_compared=compared)
    record["staged"] = res
    print(f"staged w4 (LLaMA-2-7B widths, {n} layers): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f" ({secs['nuq'] / n:.2f} s a layer; its stages "
          + ", ".join(f"{k} {v:.1f}" for k, v in nuq_stats.items())
          + "); on disk " + ", ".join(f"{k} {v / 2**20:.0f} MiB"
                                      for k, v in res["bytes"].items())
          + f"; {res['outlier_pct']}% outliers at IQR range {STAGED_RANGE}; "
          f"{compared} packed arrays equal quantize_model's; f32 request "
          f"token-identical to the plain path, launches K1..K12 "
          f"{res['launches']}")


def tf_logits(torch, model):
    """f32 teacher-forced logits of 16 tokens through the kernels against
    the plain path: finite and within TOL_TF_EXACT of max |logit|."""
    import numpy as np

    from squeezellm_tpu_torch import engine

    ids = (np.arange(16, dtype=np.int64)[None] * 7919) % model.config.vocab_size
    got = engine.Engine(model).teacher_forced_logits(ids, max_seq=BENCH_TOKENS)
    want = engine.Engine(model, plain=True).teacher_forced_logits(
        ids, max_seq=BENCH_TOKENS)
    err = rel_err(got, want)
    if not (torch.isfinite(got).all() and err <= TOL_TF_EXACT):
        raise AssertionError(f"f32 teacher-forced logits: finite "
                             f"{bool(torch.isfinite(got).all())}, rel err {err}")
    return err


def _bench(torch, model, ids, label, smi):
    """The bf16 decode benchmark and its device time per step."""
    from squeezellm_tpu_torch import engine

    bf = engine.Engine(model, dtype=torch.bfloat16,
                       cache_dtype=torch.bfloat16, mode="bf16")
    torch.cuda.reset_peak_memory_stats()
    stats = bf.benchmark(ids, max_seq=BENCH_TOKENS)
    stats["check_ppl"] = bf.benchmark(ids, max_seq=BENCH_TOKENS,
                                      check=True)["check_ppl"]
    stats["profile"] = profile_decode(torch, bf, ids)
    if not math.isfinite(stats["check_ppl"]):
        raise AssertionError(f"{label} bf16 benchmark: {stats}")
    prof = stats["profile"]
    busy = ("not measured" if prof["profile_failed"]
            else f"{prof['device_ms_per_step']:.3f} ms")
    print(f"{label} bf16 decode: {stats['tokens_per_s']:.2f} tok/s, "
          f"{stats['median_latency_s'] * 1e3:.3f} ms/token, device time a "
          f"step {busy}, peak {stats['peak_memory_mib']:.0f} MiB [{smi}]")
    return bf, stats


def _one_step(torch, bf, record, path, want):
    """Launches of one bf16 decode step after a prompt, held to `want`."""
    cache = bf.new_cache(1, BENCH_TOKENS)
    kw = dict(dtype=torch.bfloat16, mode="bf16")
    bf.model.prefill(torch.arange(1, 17, device="cuda")[None], cache, **kw)
    reset_counts()
    bf.model.decode_step(torch.tensor([[1]], device="cuda"), 16, cache, **kw)
    return expect_counts(record, path, want)


def run_structured(torch, config, record, smi):
    """A structured w4 LLaMA-2-7B at full width and depth (bench.py's
    structured statistics), fused: its 129 linears take K10; then the same
    model with the structured table withheld (K1 on the expanded LUT), and
    with transposed words attached (K11 and K12 at decode)."""
    import numpy as np

    from squeezellm_tpu_torch import engine, synthetic
    from squeezellm_tpu_torch.models import fuse

    L = config.n_layers
    per_step = 4 * L + 1
    model = fuse.fuse_for_decode(synthetic.quantized_llama(
        config, 4, seed=10, structured=True))
    lins = fuse.quant_linears(model)
    if not all("struct_a" in m.tensors() for m in lins):
        raise AssertionError("structured model: a linear lacks its table")
    prompt = np.random.default_rng(10).integers(0, config.vocab_size,
                                                (1, PROMPT_LENS[-1]))
    ids = ((np.arange(BENCH_TOKENS, dtype=np.int64)[None] * 7919)
           % config.vocab_size)
    res = {}

    def request(label, want):
        tf = tf_logits(torch, model)
        reset_counts()
        got = engine.Engine(model).generate(prompt, NEW_TOKENS)
        launches = expect_counts(record, f"{label} request", want)
        ref = engine.Engine(model, plain=True).generate(prompt, NEW_TOKENS)
        if not np.array_equal(got, ref):
            raise AssertionError(f"{label} request: kernel tokens {got} != "
                                 f"plain tokens {ref}")
        print(f"{label}: f32 request ({PROMPT_LENS[-1]}-token prompt, "
              f"{NEW_TOKENS} new) token-identical to the plain path; "
              f"launches K1..K12 {launches}; f32 teacher-forced logits rel "
              f"err {tf:.3g}")
        return dict(launches=launches, tokens=got[0].tolist(),
                    tf_exact_rel_err=tf)

    # K10: the prompt (100 rows) and every decode step
    want = [0] * 12
    want[9] = NEW_TOKENS * per_step
    want[1], want[2] = (NEW_TOKENS - 1) * L, L
    res["structured"] = request("structured w4", want)
    bf, res["structured"]["bench"] = _bench(torch, model, ids,
                                            "structured w4 (K10)", smi)
    step = [0] * 12
    step[9], step[1] = per_step, L
    res["structured"]["launches_per_decode_step"] = _one_step(
        torch, bf, record, "structured w4 decode step", step)
    del bf
    # the same model without its structured table: K1 on the expanded LUT
    for m in lins:
        m.drop_tensors("struct_a", "struct_d")
    bf, res["withheld"] = _bench(torch, model, ids,
                                 "structured w4, table withheld (K1)", smi)
    step = [0] * 12
    step[0], step[1] = per_step, L
    res["withheld"]["launches_per_decode_step"] = _one_step(
        torch, bf, record, "structured w4 withheld decode step", step)
    del bf
    fuse.attach_decode_luts(model, transposed=True)
    # transposed: the 100-row prompt takes K10 but for the lm_head, which
    # reads the last row only (K11); every decode step takes K11 for the
    # 129 linears and K12 for the 128 sidecars
    want = [0] * 12
    want[9] = 4 * L
    want[10] = (NEW_TOKENS - 1) * per_step + 1
    want[11] = (NEW_TOKENS - 1) * 4 * L
    want[1], want[2] = (NEW_TOKENS - 1) * L, L
    res["transposed"] = request("transposed w4", want)
    bf, res["transposed"]["bench"] = _bench(torch, model, ids,
                                            "transposed w4 (K11 + K12)", smi)
    step = [0] * 12
    step[10], step[11], step[1] = per_step, 4 * L, L
    res["transposed"]["launches_per_decode_step"] = _one_step(
        torch, bf, record, "transposed w4 decode step", step)
    del bf
    dev = {}
    for k in ("structured", "withheld", "transposed"):
        prof = res[k].get("bench", res[k])["profile"]
        dev[k] = ("not measured" if prof["profile_failed"]
                  else f"{prof['device_ms_per_step']:.3f} ("
                  + ", ".join(f"{n} {v:.3f}" for n, v in
                              prof["ms_per_step_by_kernel"].items() if v)
                  + f"; {prof['launches_per_step']:.0f} device launches)")
        if prof["profile_failed"]:
            record["profile_failed"].append(f"{k} w4")
    print("structured w4 device ms a bf16 decode step: "
          + ", ".join(f"{k} {v}" for k, v in dev.items()) + f" [{smi}]")
    record["structured"] = res


def print_profile(label, stats, record):
    prof = stats["profile"]
    if prof["profile_failed"]:
        record["profile_failed"].append(label)
        print(f"{label} PROFILE FAILED, device busy not measured: "
              f"{prof['profile_failed']}")
        return
    step_ms = stats["median_latency_s"] * 1e3
    busy = prof["device_ms_per_step"]
    print(f"{label} profile: device busy {busy:.3f} ms of a {step_ms:.3f} ms "
          f"step (idle share {1 - busy / step_ms:.3f}); top: " + "; ".join(
              f"{k} {v:.3f}" for k, v in prof["top_ms_per_step"]))


def print_long_profile(label, stats, record):
    """The decode step at LONG_CONTEXT rows beside the short one."""
    prof, short = stats["profile_long"], stats["profile"]
    if prof["profile_failed"] or short["profile_failed"]:
        record["profile_failed"].append(f"{label} long context")
        print(f"{label} decode at {LONG_CONTEXT} rows: PROFILE FAILED, not "
              f"measured: {prof['profile_failed'] or short['profile_failed']}")
        return
    print(f"{label} bf16 decode step, device ms: "
          f"{short['device_ms_per_step']:.3f} at positions "
          f"{short['context']}-{short['context'] + 7} (K2 "
          f"{short['k2_k5_ms_per_step']:.3f}), "
          f"{prof['device_ms_per_step']:.3f} at positions "
          f"{LONG_CONTEXT}-{LONG_CONTEXT + 7} (K2 "
          f"{prof['k2_k5_ms_per_step']:.3f}); top at the long context: "
          + "; ".join(f"{k} {v:.3f}" for k, v in prof["top_ms_per_step"]))


def tp_expect(eng, L, rows):
    """The launches K1..K12 of a serving run on one rank's fused local
    model, from the engine's own count of model calls: each call runs 4L+1
    linears (K4 instead for a layer's four at a prefill of 1024 rows or
    more), each prefill L K3s, each decode step L dense (K2/K5) or paged
    (K6/K7) attentions, each verify window L K8/K9 over a page pool."""
    from squeezellm_tpu_torch.models import common

    st, want = eng.stats, [0] * 12
    if eng.plain:
        return want
    big = sum(n >= 1024 for n in rows)
    want[0] = ((4 * L + 1) * (len(rows) + st["decode_steps"]
                              + st["spec_windows"]) - 4 * L * big)
    want[2], want[3] = L * len(rows), 4 * L * big
    paged = hasattr(eng, "pool")
    q8 = eng.pool.quantized if paged else common.is_int8(eng.cache_dtype)
    want[(6 if q8 else 5) if paged else (4 if q8 else 1)] = (
        L * st["decode_steps"])
    if paged:
        want[8 if q8 else 7] = L * st["spec_windows"]
    return want


def tp_rank(rank, config_dict, prompts, ids):
    """One rank of the tensor-parallel phase (``parallel.multihost.launch``
    runs it in its own process, on card 0 over gloo): the same full-width
    model as every rank (seed TP_SEED), served through the TP engines, each
    path's launches held to the engine's count of model calls. Returns
    each path's tokens, launches and stats, the teacher-forced logits, and
    the bf16 decode step's counts and times."""
    import numpy as np
    import torch

    from squeezellm_tpu_torch import engine, serving, synthetic
    from squeezellm_tpu_torch.models import llama
    from squeezellm_tpu_torch.sampling import SamplingParams

    cfg = llama.LlamaConfig(**config_dict)
    L = cfg.n_layers
    model = synthetic.quantized_llama(cfg, 4, seed=TP_SEED)
    out = {"paths": {}, "tokens": {}}
    f32 = dict(dtype=torch.float32, cache_dtype=torch.float32)
    bf16 = dict(dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                mode="bf16")

    def serve(label, paged=False, sampling=None, **kw):
        cls = (serving.TPPagedContinuousBatchEngine if paged
               else serving.TPContinuousBatchEngine)
        extra = (dict(n_pages=PAGED_PAGES, page_size=PAGE_SIZE,
                      max_seq=PAGED_MAX_SEQ) if paged
                 else dict(max_seq=DENSE_MAX_SEQ))
        eng = cls(model, tp=TP, fuse=True, slots=PAGED_SLOTS, graphs=False,
                  **extra, **kw)
        rows = []
        prefill = eng._prefill

        def counted(tokens, dense, start):
            rows.append(tokens.numel())
            prefill(tokens, dense, start)

        eng._prefill = counted
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(prompts, max_new_tokens=TP_NEW, sampling=sampling)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got, want = read_counts(), tp_expect(eng, L, rows)
        if got != want:
            raise AssertionError(f"rank {rank} tp {label}: launches "
                                 f"K1..K12 {got} != {want}")
        out["paths"][label] = dict(launches=got, variants=variants(),
                                   seconds=secs, stats=dict(eng.stats),
                                   prefill_rows=rows)
        out["tokens"][label] = {r: [int(t) for t in v]
                                for r, v in res.items()}
        return eng

    with torch.no_grad():
        eng = serve("dense f32", **f32)
        tf = engine.Engine(eng.model, graphs=False).teacher_forced_logits(
            ids, max_seq=BENCH_TOKENS)
        out["tf_logits"] = tf.cpu().numpy()
        del eng
        serve("dense f32 plain", plain=True, **f32)
        serve("dense bf16 sampled", sampling=SamplingParams(
            temperature=SAMPLED["temperature"], top_k=SAMPLED["top_k"],
            top_p=SAMPLED["top_p"]), seed=SAMPLED["seed"], **bf16)
        for pool in ("f32", "int8"):
            kw = dict(f32, cache_dtype=torch.float32 if pool == "f32"
                      else "int8")
            serve(f"paged {pool}", paged=True, **kw)
            serve(f"paged {pool} speculative", paged=True,
                  speculative=SPECULATIVE, **kw)

        # one bf16 decode step at 8 slots: its launches and collectives,
        # its host and device time, and the host time inside collectives
        eng = serving.TPContinuousBatchEngine(
            model, tp=TP, fuse=True, slots=PAGED_SLOTS,
            max_seq=DENSE_MAX_SEQ, graphs=False, **bf16)
        tp = eng.model.tp
        eng.add_requests(prompts[:PAGED_SLOTS], 64)
        for _ in range(3):
            eng.step()
        reset_counts()
        calls = dict(tp.counts)
        eng.step()
        step = dict(launches=read_counts(), collectives={
            k: tp.counts[k] - calls[k] for k in calls})
        want = [4 * L + 1, L] + [0] * 10
        if (step["launches"] != want or step["collectives"]
                != {"all_reduce": 2 * L, "gather": 1}):
            raise AssertionError(f"rank {rank} tp bf16 decode step: {step}")
        steps = 8

        def run_steps():
            for _ in range(steps):
                eng.step()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps()
        torch.cuda.synchronize()
        step["host_ms"] = (time.perf_counter() - t0) / steps * 1e3
        tp.timed, tp.seconds = True, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps()
        torch.cuda.synchronize()
        timed = time.perf_counter() - t0
        tp.timed = False
        step["host_ms_timed"] = timed / steps * 1e3
        step["collective_share"] = tp.seconds / timed
        by_name, why = device_ms_by_kernel(torch, run_steps)
        step["device_ms"] = (None if by_name is None
                             else sum(by_name.values()) / steps)
        step["profile_failed"] = why
        out["bf16_step"] = step
        out["tp_layers"] = L
    return out


def run_tp(torch, config, record, smi):
    """Tensor parallelism on the card: TP ranks (processes) share card 0
    over gloo (NCCL refuses two ranks on one device) and serve LLaMA-2-7B
    w4 at full width, TP_LAYERS layers, with a 0.45% sidecar, top-X 10 and
    a quantized lm_head (``tp_rank``). Held: every rank's tokens equal the
    others', the f32 greedy tokens equal the TP engine's plain path, the
    f32 teacher-forced logits lie within TOL_TF_EXACT of max |logit| of the
    single-device engine's (through the kernels), speculation keeps the
    greedy tokens, and every path's launches match its model calls.
    Reported: the share of TP greedy tokens equal to the single-device
    engine's, and each rank's bf16 decode step."""
    import dataclasses

    import numpy as np

    from squeezellm_tpu_torch import engine, serving, synthetic
    from squeezellm_tpu_torch.models import fuse
    from squeezellm_tpu_torch.parallel import multihost

    cfg = dataclasses.replace(config, n_layers=TP_LAYERS)
    L = cfg.n_layers
    prompts = paged_requests(cfg)
    ids = (np.arange(16, dtype=np.int64)[None] * 7919) % cfg.vocab_size
    if torch.cuda.device_count() < TP:
        print(f"tensor parallel: {torch.cuda.device_count()} card, so the "
              f"NCCL path with graphed steps (a card a rank) did not run; "
              f"{TP} ranks share card 0 over gloo, steps eager")
    # the single-device reference, made and freed before the ranks start
    t0 = time.perf_counter()
    model = fuse.fuse_for_decode(synthetic.quantized_llama(cfg, 4,
                                                           seed=TP_SEED))
    single = serving.ContinuousBatchEngine(
        model, slots=PAGED_SLOTS, max_seq=DENSE_MAX_SEQ,
        cache_dtype=torch.float32).run(prompts, max_new_tokens=TP_NEW)
    single_tf = engine.Engine(model).teacher_forced_logits(
        ids, max_seq=BENCH_TOKENS).cpu().numpy()
    del model
    torch.cuda.empty_cache()
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = multihost.launch(tp_rank, TP, args=(
        dataclasses.asdict(cfg), prompts, ids), device="cuda",
        join_timeout_s=900)
    t_ranks = time.perf_counter() - t0
    res = {"layers": L, "backend": multihost.backend_for("cuda", TP),
           "single_s": t_single, "ranks_s": t_ranks, "by_rank": []}
    for r, got in enumerate(ranks):
        if got["tokens"] != ranks[0]["tokens"]:
            bad = [k for k in got["tokens"]
                   if got["tokens"][k] != ranks[0]["tokens"][k]]
            raise AssertionError(f"tp: rank {r}'s tokens differ from rank "
                                 f"0's in {bad}")
        if not np.array_equal(got["tf_logits"], ranks[0]["tf_logits"]):
            raise AssertionError(f"tp: rank {r}'s logits differ from rank 0's")
    tok = ranks[0]["tokens"]
    hold_equal("tp dense f32: kernels vs plain", tok["dense f32"],
               tok["dense f32 plain"])
    for pool in ("f32", "int8"):
        hold_equal(f"tp paged {pool}: speculative vs steps",
                   tok[f"paged {pool} speculative"], tok[f"paged {pool}"])
    tf = ranks[0]["tf_logits"]
    res["tf_rel_err"] = float(np.abs(tf - single_tf).max()
                              / np.abs(single_tf).max())
    if not (np.isfinite(tf).all() and res["tf_rel_err"] <= TOL_TF_EXACT):
        raise AssertionError(f"tp f32 teacher-forced logits vs single "
                             f"device: rel err {res['tf_rel_err']}")
    same = sum(a == b for rid in single for a, b in zip(
        tok["dense f32"][rid], single[rid]))
    res["greedy_equal_share"] = same / sum(len(v) for v in single.values())
    for r, got in enumerate(ranks):
        for label, p in got["paths"].items():
            record["paths"].append({"path": f"tp rank {r} {label}",
                                    "launches": p["launches"],
                                    "replayed": [0] * 12,
                                    "variants": p["variants"]})
        res["by_rank"].append({"paths": got["paths"],
                               "bf16_step": got["bf16_step"]})
    p0 = ranks[0]["paths"]
    print(f"tp={TP} ({res['backend']}, ranks sharing card 0, steps eager) "
          f"on LLaMA-2-7B w4 at full width, {L} layers: "
          f"{len(prompts)} requests of {TP_NEW} new tokens a path; every "
          f"rank's tokens identical; f32 greedy identical to the TP plain "
          f"path; paged speculation identical to its steps (f32 and int8 "
          f"pools); f32 teacher-forced logits (16 steps) rel err "
          f"{res['tf_rel_err']:.3g} against the single-device engine "
          f"(limit {TOL_TF_EXACT}); {res['greedy_equal_share']:.3f} of the "
          f"f32 greedy tokens equal the single-device engine's (reported) "
          f"[{smi}]")
    for label, p in p0.items():
        print(f"  tp rank 0 {label}: {p['seconds']:.2f} s, launches K1..K12 "
              f"{p['launches']}, {p['stats']}")
    for r, got in enumerate(ranks):
        st = got["bf16_step"]
        dev = ("not measured (" + st["profile_failed"] + ")"
               if st["device_ms"] is None else f"{st['device_ms']:.3f} ms")
        print(f"tp rank {r} bf16 decode step at {PAGED_SLOTS} slots: "
              f"launches K1..K12 {st['launches']} (K1 {4 * L + 1} = 4 x {L} "
              f"layers + lm_head, K2 {L}), collectives {st['collectives']} "
              f"(2 a layer + the vocab gather); host {st['host_ms']:.3f} ms "
              f"a step, device {dev}; with each collective timed (synced "
              f"before and after) {st['host_ms_timed']:.3f} ms, of it "
              f"{st['collective_share']:.3f} inside collectives [{smi}]")
    print(f"tp: two ranks time-sharing one card measure correctness and "
          f"host cost, not tensor-parallel speed; single-device reference "
          f"{t_single:.1f} s, ranks {t_ranks:.1f} s")
    record["tp"] = res


def kernel_lines(record):
    """One entry per kernel: its time at one main-path decode/prefill shape
    (named in "at"); every shape's numbers are in build/chip_smoke.json."""
    k1 = next(r for r in record["k1_detail"] if r["shape"] == "gateup"
              and r["bits"] == 4 and r["M"] == 1 and r["mode"] == "bf16")
    k2, k5 = (next(r for r in record[f"k{n}_detail"] if r["n"] == 128)
              for n in (2, 5))
    k3, k3x = (next(r for r in record["k3_detail"] if r["Sq"] == 100
                    and r["regime"] == regime) for regime in ("bf16", "exact"))
    k4 = next(r for r in record["k4_detail"] if r["shape"] == "gateup"
              and r["bits"] == 4 and r["mode"] == "bf16")
    k6, k7, k8, k9 = (record[f"k{n}_detail"][0] for n in (6, 7, 8, 9))
    # every path's run: counts set to 0 just before it, read just after
    launches = [sum(p["launches"][i] for p in record["paths"])
                for i in range(len(counters()))]
    # of them, added by CUDA graph replays
    replayed = [sum(p["replayed"][i] for p in record["paths"])
                for i in range(len(counters()))]
    k3_launches = {regime: sum(p["variants"]["K3"][regime]
                               for p in record["paths"])
                   for regime in ("bf16", "exact")}
    k3_err = record["k3_max_abs_err_by_regime"]
    # the same kernels at a long context, beside the short one
    long_ = {
        "decode_attention": (next(r for r in record["k2_detail"]
                                  if r["n"] == 2048), "2048 valid rows"),
        "decode_attention_q8": (next(r for r in record["k5_detail"]
                                     if r["n"] == 2048), "2048 valid rows"),
        "flash_attention": (next(r for r in record["k3_detail"]
                                 if r["Sq"] == 2048 and r["regime"] == "bf16"),
                            "the 2048-token eval stride"),
        "flash_attention_exact": (next(
            r for r in record["k3_detail"]
            if r["Sq"] == 2048 and r["regime"] == "exact"),
            "the 2048-token eval stride"),
        "spmv": (next(r for r in record["k12_detail"] if r["shape"] == "down"
                      and r["M"] == 8 and r["mode"] == "bf16"),
                 "0.45% CSR sidecar of down 4096x11008, 8 rows of bf16 x "
                 "(a paged decode step at 8 slots)")}
    paged_at = (f"LLaMA-2-7B layer, {PAGED_SLOTS} slots x {PAGED_AT_ROWS} "
                f"valid rows, {PAGE_SIZE}-row pages, ")
    rows = [
        ("lut_matmul", "squeezellm_tpu_torch/csrc/lut_matmul.cu",
         "squeezellm_tpu/ops/pallas_ops.py:252 (+ :208 _lut_matmul_kernel, "
         ":427 _spmv_kernel)", launches[0], record["k1_max_abs_err"], k1,
         "fused gate|up 22016x4096 w4, 1 row, bf16 mode, 0.45% sidecar"),
        ("decode_attention", "squeezellm_tpu_torch/csrc/decode_attn.cu",
         "squeezellm_tpu/ops/decode_attn.py:130", launches[1],
         record["k2_max_abs_err"], k2,
         "LLaMA-2-7B layer, B=1, 128 valid rows of a 2048-row bf16 cache"),
        ("flash_attention", "squeezellm_tpu_torch/csrc/flash_attn.cu",
         "squeezellm_tpu/ops/flash_attn.py:40", k3_launches["bf16"],
         k3_err["bf16"], k3,
         "LLaMA-2-7B layer, 100-token prompt, bf16 q/k/v, bf16 regime "
         "(tensor cores)"),
        ("flash_attention_exact", "squeezellm_tpu_torch/csrc/flash_attn.cu",
         "squeezellm_tpu/ops/flash_attn.py:40", k3_launches["exact"],
         k3_err["exact"], k3x,
         "LLaMA-2-7B layer, 100-token prompt, f32 q, bf16 k/v, exact regime "
         "(f32 FMAs)"),
        ("dequant_dense", "squeezellm_tpu_torch/csrc/dequant_dense.cu",
         "squeezellm_tpu/ops/pallas_ops.py:765", launches[3],
         record["k4_max_abs_err"], k4,
         "fused gate|up 22016x4096 w4 to a bf16 W, 0.45% sidecar folded in"),
        ("decode_attention_q8", "squeezellm_tpu_torch/csrc/decode_attn.cu",
         "squeezellm_tpu/ops/decode_attn.py:386", launches[4],
         record["k5_max_abs_err"], k5,
         "LLaMA-2-7B layer, B=1, 128 valid rows of a 2048-row int8 cache"),
        ("paged_decode_attention", "squeezellm_tpu_torch/csrc/paged_attn.cu",
         "squeezellm_tpu/ops/paged_attn.py:74", launches[5],
         record["k6_max_abs_err"], k6, paged_at + "bf16 pool"),
        ("paged_decode_attention_q8",
         "squeezellm_tpu_torch/csrc/paged_attn.cu",
         "squeezellm_tpu/ops/paged_attn.py:202", launches[6],
         record["k7_max_abs_err"], k7, paged_at + "int8 pool"),
        ("paged_verify_attention", "squeezellm_tpu_torch/csrc/paged_attn.cu",
         "squeezellm_tpu/ops/paged_attn.py:589", launches[7],
         record["k8_max_abs_err"], k8, paged_at + "bf16 pool, W=5"),
        ("paged_verify_attention_q8",
         "squeezellm_tpu_torch/csrc/paged_attn.cu",
         "squeezellm_tpu/ops/paged_attn.py:715", launches[8],
         record["k9_max_abs_err"], k9, paged_at + "int8 pool, W=5"),
    ]
    k10 = next(r for r in record["k10_detail"] if r["shape"] == "gateup"
               and r["M"] == 1 and r["mode"] == "bf16")
    k11 = next(r for r in record["k11_detail"] if r["shape"] == "gateup"
               and r["M"] == 1 and r["mode"] == "bf16")
    k12 = next(r for r in record["k12_detail"] if r["shape"] == "gateup"
               and r["M"] == 1 and r["mode"] == "bf16")
    rows += [
        ("lut_matmul_struct", "squeezellm_tpu_torch/csrc/lut_matmul.cu",
         "squeezellm_tpu/ops/pallas_ops.py:190 (_dequant_plane_struct_sel, "
         "through _lut_matmul_body :307)", launches[9],
         record["k10_max_abs_err"], k10,
         "fused gate|up 22016x4096 w4 structured, 1 row, bf16 mode, 0.45% "
         "sidecar"),
        ("lut_matmul_t", "squeezellm_tpu_torch/csrc/lut_matmul_t.cu",
         "squeezellm_tpu/ops/pallas_ops.py:613", launches[10],
         record["k11_max_abs_err"], k11,
         "fused gate|up 22016x4096 w4, transposed words, 1 row, bf16 mode"),
        ("spmv", "squeezellm_tpu_torch/csrc/spmv.cu",
         "squeezellm_tpu/ops/pallas_ops.py:462 (_spmv_kernel_grouped; and "
         ":427 _spmv_kernel)", launches[11], record["k12_max_abs_err"], k12,
         "0.45% CSR sidecar of fused gate|up 22016x4096, 1 row of bf16 x"),
    ]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    lines = []
    names = [fn.__name__ for fn in counters()]
    for name, src, rep, n, err, r, at in rows:
        line = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": n, "max_abs_err": err, **{k: r[k] for k in keys},
                "at": at}
        if name in names:  # K3's regimes share one wrapper's count
            line["launches_replayed"] = replayed[names.index(name)]
        if "device_ms" in r:  # the profiler's, beside the timer's ms
            line["device_ms"] = r["device_ms"]
        if name in long_:
            r, at = long_[name]
            line["long"] = {"at": at, **{k: r[k] for k in keys}}
            if "device_ms" in r:
                line["long"]["device_ms"] = r["device_ms"]
        lines.append(line)
    return {"kernels": lines}


def build_seconds():
    """Each CUDA source's seconds from the build's common start (one nvcc a
    source, all started together), from the build log."""
    from squeezellm_tpu_torch import _build

    log = os.path.join(os.path.dirname(_build.build()), "build.log")
    with open(log) as f:
        return {m[0]: float(m[1]) for m in re.findall(
            r"^== (\S+) \(rc \d+, ([\d.]+) s\)$", f.read(), re.M)}


def ptxas_lines(source):
    """One line per kernel of `source` from the build's -Xptxas -v log:
    name, registers, shared memory and spill bytes."""
    from squeezellm_tpu_torch import _build

    log = os.path.join(os.path.dirname(_build.build()), "build.log")
    with open(log) as f:
        text = f.read().split(f"== {source} ")[1].split("\n== ")[0]
    out, name, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in ("flash_attn_mma_kernel",
                                     "flash_attn_kernel",
                                     "decode_attn_kernel",
                                     "paged_attn_kernel", "gemv_kernel",
                                     "mma_kernel", "k4_dequant_kernel",
                                     "k11_kernel", "spmv_interleave_kernel",
                                     "spmv_kernel") if k in mangled),
                        mangled)
            args = [("b" + b) for b in re.findall(r"Lb(\d)E", mangled)]
            args += re.findall(r"Li(\d+)E", mangled)
            args.append(("int8 " if "aLi" in mangled else "")
                        + ("bf16" if "bfloat16" in mangled else "f32"))
            name += "<" + ",".join(args) + ">"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def main():
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from squeezellm_tpu_torch import _build
    from squeezellm_tpu_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, nvcc: "
          f"{sh([_build.nvcc_path(), '--version']).splitlines()[-1]}")
    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "k1_detail": [], "k2_detail": [],
              "k3_detail": [], "k4_detail": [], "k5_detail": [],
              "k6_detail": [], "k7_detail": [], "k8_detail": [],
              "k9_detail": [], "k10_detail": [], "k11_detail": [],
              "k12_detail": [], "k10_per_decode_step": [],
              "k11_per_decode_step": [], "k12_per_decode_step": [],
              "k1_bf16_flips": [], "k1_per_decode_step": [],
              "k4_per_forward": [], "k1_cross": [], "models": [],
              "paths": [],
              "profile_failed": [], "failed": []}
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    record["build_s"] = time.perf_counter() - t0
    record["build_s_by_source"] = build_seconds()
    print(f"kernels built and loaded in {record['build_s']:.1f} s (each "
          f"source's nvcc, started together: " + ", ".join(
              f"{k} {v:.1f} s"
              for k, v in record["build_s_by_source"].items()) + ")")
    t0 = time.perf_counter()
    _build.host_lib()
    record["host_build_s"] = time.perf_counter() - t0
    print(f"host k-means solver (csrc/host/nuq_kmeans.cpp, g++) built and "
          f"loaded in {record['host_build_s']:.1f} s")
    record["ptxas"] = [line for src in ("lut_matmul.cu", "flash_attn.cu",
                                        "decode_attn.cu", "paged_attn.cu",
                                        "dequant_dense.cu", "lut_matmul_t.cu",
                                        "spmv.cu")
                       for line in ptxas_lines(src)]
    for line in record["ptxas"]:
        print(f"  ptxas {line}")

    timer = Timer(torch)
    _, config = registry.load_config(os.path.join(HERE, "models",
                                                  "llama-2-7b"))
    phases = [("K1", lambda: check_k1(torch, timer, record)),
              ("K1 at the tp=2 shapes", lambda: check_k1(
                  torch, timer, record, K1_TP_SHAPES, K1_TP_ROWS,
                  "k1_tp2_detail", "k1_tp2_per_decode_step", "K1 tp=2")),
              ("K1 crossover", lambda: check_k1_cross(torch, timer, record)),
              ("K2", lambda: check_k2(torch, timer, record)),
              ("K3", lambda: check_k3(torch, timer, record)),
              ("K4", lambda: check_k4(torch, timer, record)),
              ("K5", lambda: check_k5(torch, timer, record))]
    phases += [(f"K{n}", lambda n=n: check_paged(torch, timer, record, n))
               for n in (6, 7, 8, 9)]
    phases += [("K10", lambda: check_k10(torch, timer, record)),
               ("K11", lambda: check_k11(torch, timer, record)),
               ("K12", lambda: check_k12(torch, timer, record))]
    phases += [(f"model w{b}", lambda b=b: run_model(torch, config, b, record))
               for b in (4, 3)]
    serve_cfg = dataclasses.replace(config, n_layers=SERVE_LAYERS)
    print(f"serving phases: LLaMA-2-7B at full width, {SERVE_LAYERS} of "
          f"{config.n_layers} layers (cut for the run's time limit)")
    phases += [("paged serving",
                lambda: run_paged(torch, serve_cfg, record, smi)),
               ("dense-slot serving",
                lambda: run_dense_slots(torch, serve_cfg, record, smi)),
               ("opt-6.7b w4", lambda: run_opt(torch, record)),
               ("dense bf16", lambda: run_dense(torch, config, record)),
               ("quantize on the card",
                lambda: run_quantize(torch, config, record)),
               ("convert", lambda: run_convert(torch, config, record)),
               ("staged", lambda: run_staged(torch, config, record)),
               ("structured and transposed w4",
                lambda: run_structured(torch, config, record, smi)),
               ("tensor parallel", lambda: run_tp(torch, config, record,
                                                  smi))]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # record the phase, go on to the next
            traceback.print_exc()
            record["failed"].append(name)
            print(f"PHASE FAILED: {name}")
        torch.cuda.empty_cache()
        print(f"[{name}: {time.perf_counter() - t0:.1f} s]")
    if "dense_bf16" in record:
        dense = record["dense_bf16"]["tokens_per_s"]
        for m in record["models"]:
            print(f"w{m['bits']}-s45 vs bf16 dense: "
                  f"{m['bench']['tokens_per_s'] / dense:.3f}x")

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    if record["failed"]:
        print(f"chip_smoke: failed phases {record['failed']}",
              file=sys.stderr)
        return 1
    lines = kernel_lines(record)
    idle = [k["name"] for k in lines["kernels"] if not k["launches"]]
    if idle:
        print(f"chip_smoke: no path launched {idle}", file=sys.stderr)
        return 1
    print(json.dumps(lines))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
