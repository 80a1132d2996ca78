"""Command line of the port: ``python -m squeezellm_tpu_torch <command>``.

  quantize   dense HF checkpoint (+ optional grad^2 chunks) -> quantized
             checkpoint (outliers -> k-means -> pack, one layer at a time)
  fisher     grad^2 sensitivity chunks of a dense HF checkpoint
  chunk      dense HF checkpoint -> per-layer weight chunks
  outlier-config  chunks -> IQR outlier thresholds (JSON)
  nuq        chunks -> per-layer codebooks and outliers, resumable
  pack       dense HF checkpoint + nuq artifacts -> quantized checkpoint
  convert    the reference's packed ``.pt`` checkpoint -> quantized
             checkpoint
  eval       perplexity (GPTQ stride protocol) on ``synthetic`` tokens, a
             ``.npy`` token file or a text dataset (wikitext2, ptb, c4,
             ...) read with the model directory's tokenizer
  benchmark  batch-1 decode latency, tok/s, peak memory; ``--profile DIR``
             also writes a torch.profiler trace there and prints its
             per-kernel device time table
  generate   greedy or sampled generation from comma-separated prompt token
             ids, or greedy with prompt-lookup or draft-model speculation
  serve-bench  continuous-batching throughput and latency over random
             prompts: the dense-slot engine, or ``--paged``; ``--tp N``
             serves N tensor-parallel ranks
  serve      the HTTP front end (``/v1/completions``, ``/health``) over
             either engine, ``--tp N`` as serve-bench's

``quantize``, ``fisher``, the staged commands (chunk -> outlier-config ->
nuq -> pack) and ``convert`` take the JAX package's arguments (``--model``
an HF directory with ``config.json`` and its weights; ``convert``'s a
directory with ``config.json``). ``eval``, ``benchmark``, ``generate``,
``serve-bench`` and ``serve`` take ``--model DIR`` (a quantized checkpoint
directory, which either package's ``save_quantized`` writes) or
``--synthetic CONFIG --wbits N`` (a random Dense-and-Sparse model of an HF
``config.json``, e.g. ``models/llama-2-7b/config.json``); a text dataset
needs tokenizer files in that directory. Every command takes ``--device``
(default ``cuda``). ``--mode exact`` runs f32 throughout; ``--mode bf16``
the flagship regime (bf16 activations and cache, bf16-rounded LUT and x
with f32 accumulation). The counterpart of the JAX package's ``cli.py``
commands of the same names.

``serve-bench --tp N`` and ``serve --tp N`` (N above 1) run N ranks, one
process each: under torchrun (WORLD_SIZE = N in the environment) each
process is a rank; otherwise the command starts the N ranks itself
(``parallel.multihost.launch``; the kernels are built once first). Every
rank loads the same model and serves its shards through
``serving.TPContinuousBatchEngine`` (``--paged``:
``TPPagedContinuousBatchEngine``); rank 0 alone prints. The collective
backend follows ``parallel.multihost.backend_for``: NCCL and graphed steps
with a card a rank, gloo and eager steps for ranks that share one card or
the CPU; the JSON names both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

CALIB_SAMPLES = 128  # sizes the synthetic corpus as the JAX CLI's default
METHODS = ["auto", "native", "batched", "sklearn"]
METHOD_HELP = ("k-means solver: 'auto' is 'native' (the sorted-Lloyd C++ "
               "solver, built with the host's g++ at first use), 'batched' "
               "the PyTorch one on the device, 'sklearn' scikit-learn's "
               "KMeans a channel at a time on the host (as the reference)")


def _load_model(args, path=None):
    """The --model checkpoint or the --synthetic model; `path` (a draft
    model's) is read as a checkpoint directory when it holds a
    manifest.json, else as a config like --synthetic's."""
    from squeezellm_tpu_torch import checkpoint, synthetic
    from squeezellm_tpu_torch.models import fuse, registry

    ckpt = args.model if path is None else path
    if ckpt and os.path.exists(os.path.join(ckpt, "manifest.json")):
        _, model = checkpoint.load_quantized(ckpt, args.device)
    else:
        path = path or args.synthetic
        model_dir = os.path.dirname(path) if os.path.isfile(path) else path
        model_type, config = registry.load_config(model_dir)
        make = {"opt": synthetic.quantized_opt,
                "mellum": synthetic.quantized_mellum}.get(
                    model_type, synthetic.quantized_llama)
        model = make(config, args.wbits, seed=args.seed, device=args.device)
    # a tensor-parallel engine shards the unfused model and fuses its shards
    if getattr(args, "fuse", False) and _tp(args) <= 1:
        fuse.fuse_for_decode(model)
    return model


def _tp(args) -> int:
    return getattr(args, "tp", 0) or 0


def _is_text(dataset: str) -> bool:
    return dataset != "synthetic" and not dataset.endswith(".npy")


def _tokens(args, config) -> np.ndarray:
    """The dataset's eval tokens; a text dataset is read with the
    tokenizer of the --model directory or of the --synthetic config's
    directory, where it has one (as the JAX package's ``_eval_tokens``)."""
    from squeezellm_tpu_torch import data
    from squeezellm_tpu_torch.utils import hf

    tokenizer = None
    if _is_text(args.dataset):
        src = args.model or args.synthetic
        model_dir = os.path.dirname(src) if os.path.isfile(src) else src
        if hf.has_tokenizer(model_dir):
            tokenizer = hf.load_tokenizer(model_dir)
    _, test = data.get_loaders(args.dataset, nsamples=CALIB_SAMPLES,
                               seed=args.seed, seqlen=args.seqlen,
                               tokenizer=tokenizer,
                               vocab_size=config.vocab_size)
    return np.asarray(test)


def _dtypes(args):
    """(activation dtype, cache dtype) of --mode and --kv-dtype."""
    dtype = torch.bfloat16 if args.mode == "bf16" else torch.float32
    return dtype, {None: dtype, "bf16": torch.bfloat16,
                   "f32": torch.float32, "int8": "int8"}[args.kv_dtype]


def _engine(args, model):
    from squeezellm_tpu_torch import engine

    dtype, cache = _dtypes(args)
    return engine.Engine(model, dtype=dtype, cache_dtype=cache,
                         mode=args.mode)


def _build_serving_engine(args, model):
    """The engine of serve-bench and serve: the dense-slot one, or the
    paged one with --paged (a pool of ceil(seqlen / page size) pages a
    slot), with speculation and chunked admission as asked; with --tp N
    above 1 their tensor-parallel forms on this rank (the JAX CLI's ladder:
    ``main`` keeps an int8 dense cache to one device), graphed when the
    group's backend can be captured (NCCL)."""
    import torch.distributed as dist

    from squeezellm_tpu_torch import serving

    tp = _tp(args)
    dtype, cache = _dtypes(args)
    kw = dict(slots=args.slots, dtype=dtype, cache_dtype=cache,
              mode=args.mode, max_seq=args.seqlen, seed=args.seed,
              speculative=tuple(args.speculative) if args.speculative
              else None, prefill_chunk=args.prefill_chunk)
    if tp > 1:
        kw.update(tp=tp, fuse=args.fuse,
                  graphs=dist.get_backend() == "nccl")
    if args.paged:
        cls = (serving.TPPagedContinuousBatchEngine if tp > 1
               else serving.PagedContinuousBatchEngine)
        return cls(model, page_size=args.page_size,
                   n_pages=-(-args.seqlen // args.page_size) * args.slots,
                   **kw)
    cls = (serving.TPContinuousBatchEngine if tp > 1
           else serving.ContinuousBatchEngine)
    return cls(model, **kw)


def _tp_fields(args) -> dict:
    """The JSON fields of a tensor-parallel run: ranks, backend, graphs."""
    if _tp(args) <= 1:
        return {}
    import torch.distributed as dist

    backend = dist.get_backend()
    return {"tp": _tp(args), "backend": backend, "graphs": backend == "nccl"}


def _tp_rank(rank: int, argv) -> None:
    """One rank of a ``--tp`` command that started its own ranks."""
    main(argv)


def cmd_quantize(args):
    from squeezellm_tpu_torch import checkpoint
    from squeezellm_tpu_torch.quantize import outlier_config as oc_mod
    from squeezellm_tpu_torch.quantize import pipeline
    from squeezellm_tpu_torch.utils import hf

    model_type, config, params = hf.load_dense_model(args.model)
    names = list(config.linear_shapes())
    grads = None
    if args.gradient:
        grads = []
        for li in range(config.n_layers):
            pt = os.path.join(args.gradient, f"layer_{li}.pt")
            if os.path.exists(pt):  # the reference's SqueezeLLM-gradients
                g = torch.load(pt, map_location="cpu", weights_only=True)
                grads.append({n: g[n].float() for n in names})
            else:  # the `fisher` command's chunks
                with np.load(os.path.join(args.gradient,
                                          f"layer_{li}.npz")) as g:
                    grads.append({n: g[n] for n in names})
    outlier_cfg = None
    if args.outlier_range:
        cfg = oc_mod.make_outlier_config(
            ({n: lp[n]["w"] for n in names} for lp in params["layers"]),
            args.outlier_range, verbose=True)
        outlier_cfg = cfg["outlier_config"]
        print(f"measured outlier %: {cfg['outlier_threshold']}")
    specs, qparams = pipeline.quantize_model(
        model_type, config, params, args.bits, gradients_per_layer=grads,
        sensitivity=args.sensitivity, outlier_config=outlier_cfg,
        method=args.method, quantize_lm_head=args.quantize_lm_head,
        verbose=True, device=args.device)
    checkpoint.save_quantized(args.output, model_type, config, specs, qparams)
    print(f"saved quantized checkpoint to {args.output}")


def cmd_fisher(args):
    from squeezellm_tpu_torch import data
    from squeezellm_tpu_torch.quantize import gradients
    from squeezellm_tpu_torch.utils import hf

    model_type, config, params = hf.load_dense_model(args.model)
    tokenizer = (hf.load_tokenizer(args.model) if _is_text(args.dataset)
                 else None)
    calib, _ = data.get_loaders(args.dataset, nsamples=args.nsamples,
                                seed=args.seed, seqlen=args.seqlen,
                                tokenizer=tokenizer,
                                vocab_size=config.vocab_size)
    grads = gradients.compute_fisher(model_type, config, params, calib,
                                     batch_size=args.batch_size,
                                     verbose=True, device=args.device)
    gradients.save_gradient_chunks(grads, args.output, model_type,
                                   args.model)
    print(f"grad^2 chunks -> {args.output}")


def cmd_chunk(args):
    from squeezellm_tpu_torch.quantize import staged

    n = staged.chunk_model(args.model, args.output, verbose=True)
    print(f"chunked {n} layers into {args.output}")


def cmd_outlier_config(args):
    from squeezellm_tpu_torch.quantize import staged

    cfg = staged.make_outlier_config(args.chunks, args.range, args.output,
                                     verbose=True)
    print(f"measured outlier %: {cfg['outlier_threshold']} -> {args.output}")


def cmd_nuq(args):
    from squeezellm_tpu_torch.quantize import staged

    staged.nuq(args.chunks, args.output, args.bits,
               gradient_chunks_dir=args.gradient_chunks,
               sensitivity=args.sensitivity,
               outlier_config_json=args.outlier_config, method=args.method,
               seed=args.seed, device=args.device, verbose=True)
    print(f"nuq artifacts in {args.output}")


def cmd_pack(args):
    from squeezellm_tpu_torch.quantize import staged

    staged.pack(args.model, args.nuq, args.wbits, args.output,
                device=args.device, verbose=True)
    print(f"packed checkpoint -> {args.output}")


def cmd_convert(args):
    from squeezellm_tpu_torch import convert

    convert.convert_reference_checkpoint(args.checkpoint, args.model,
                                         args.wbits, args.output,
                                         device=args.device)
    print(f"converted {args.checkpoint} -> {args.output}")


def cmd_eval(args):
    from squeezellm_tpu_torch import eval as eval_mod

    model = _load_model(args)
    ppl = eval_mod.perplexity(
        model, _tokens(args, model.config), seqlen=args.seqlen,
        nsamples=args.nsamples, group=args.group, mode=args.mode,
        dtype=torch.bfloat16 if args.mode == "bf16" else torch.float32,
        verbose=True)
    print(json.dumps({"dataset": args.dataset, "seqlen": args.seqlen,
                      "ppl": ppl}))


def cmd_benchmark(args):
    model = _load_model(args)
    ids = _tokens(args, model.config)[:, : args.tokens]
    eng = _engine(args, model)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        from squeezellm_tpu_torch.utils import profiling

        acts = [ProfilerActivity.CPU]
        if model.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            stats = eng.benchmark(ids, check=args.check)
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profile trace written to {path}")
        # the per-kernel self-time table (the reference's --torch_profile)
        profiling.print_trace_summary(args.profile)
    else:
        stats = eng.benchmark(ids, check=args.check)
    print(json.dumps(stats, indent=2))


def cmd_serve_bench(args):
    """Continuous-batching throughput: generated tokens a second across a
    pool of concurrent requests (the latency side is `benchmark`), with
    each request's time to first token and to completion."""
    import time

    from squeezellm_tpu_torch.parallel import multihost

    model = _load_model(args)
    eng = _build_serving_engine(args, model)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, model.config.vocab_size,
                            rng.integers(4, 32)).tolist()
               for _ in range(args.requests)]
    # warm up: the first calls capture the step programs
    eng.run(prompts[:1], max_new_tokens=2, window=args.window)

    # per request: admission (before its prefill), first token, done. A
    # cohort's requests share its admission time, so time to first token
    # includes the cohort's batched prefill
    admit, first, done = {}, {}, {}
    add = eng.add_requests

    def timed_add(prompts_, max_new_tokens, **akw):
        t = time.perf_counter()
        rids = add(prompts_, max_new_tokens, **akw)
        for rid in rids:
            admit[rid] = t
        return rids

    eng.add_requests = timed_add

    def on_token(rid, new, is_done):
        now = time.perf_counter()  # after the window's host sync
        first.setdefault(rid, now)
        if is_done:
            done[rid] = now

    t0 = time.perf_counter()
    results = eng.run(prompts, max_new_tokens=args.max_new_tokens,
                      window=args.window, on_token=on_token)
    dt = time.perf_counter() - t0
    total = sum(len(t) for t in results.values())
    ttft = sorted(first[r] - admit[r] for r in first)
    lat = sorted(done[r] - admit[r] for r in done)

    def pct(xs, p):
        return round(xs[min(len(xs) - 1, int(p * len(xs)))], 4) if xs else None

    if not multihost.is_primary():
        return
    print(json.dumps({
        "engine": type(eng).__name__, **_tp_fields(args),
        "requests": args.requests, "slots": args.slots,
        "total_tokens": total, "elapsed_s": round(dt, 3),
        "throughput_tok_s": round(total / dt, 2),
        "ttft_s_p50": pct(ttft, 0.50), "ttft_s_p95": pct(ttft, 0.95),
        "request_latency_s_p50": pct(lat, 0.50),
        "request_latency_s_p95": pct(lat, 0.95),
    }))


def cmd_serve(args):
    import time

    import torch.distributed as dist

    from squeezellm_tpu_torch import server

    model = _load_model(args)
    eng = _build_serving_engine(args, model)
    # tensor parallel: rank 0 serves HTTP and sends every engine call to
    # the other ranks over a gloo group, which follow it
    control = dist.new_group(backend="gloo") if _tp(args) > 1 else None
    if control is not None and dist.get_rank() != 0:
        server.follow(eng, control)
        return
    httpd = server.serve(eng, host=args.host, port=args.port,
                         window=args.window, control=control)
    print(json.dumps({"listening": f"http://{args.host}:"
                                   f"{httpd.server_port}",
                      "slots": args.slots, "paged": args.paged,
                      **_tp_fields(args)}),
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        httpd.serving_loop.shutdown()
        httpd.shutdown()


def cmd_generate(args):
    from squeezellm_tpu_torch import engine

    if args.draft_model or args.draft_layers:
        if args.temperature > 0:
            raise SystemExit("draft speculation is greedy-only (exactness)")
        if args.draft_model and args.draft_layers:
            raise SystemExit("--draft-model and --draft-layers are "
                             "mutually exclusive")
    elif args.speculative and args.temperature > 0:
        raise SystemExit("--speculative is greedy-only (exactness)")
    model = _load_model(args)
    eng = _engine(args, model)
    prompt = np.asarray([int(t) for t in args.prompt_tokens.split(",")],
                        np.int64)[None]
    if args.draft_model or args.draft_layers:
        # a second checkpoint, or the early-exit draft: the target's first
        # layers, weights shared
        dmodel = (_load_model(args, args.draft_model) if args.draft_model
                  else engine.truncate_for_draft(model, args.draft_layers))
        draft = _engine(args, dmodel)
        out = eng.generate_draft_speculative(prompt, args.max_new_tokens,
                                             draft, draft_len=args.draft_len)
    elif args.speculative:
        out = eng.generate_speculative(prompt, args.max_new_tokens,
                                       draft_len=args.draft_len,
                                       ngram=args.ngram)
    else:
        out = eng.generate(prompt, args.max_new_tokens,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, seed=args.seed)
        print(json.dumps({"tokens": out[0].tolist()}))
        return
    print(json.dumps({"tokens": out[0].tolist(),
                      "spec_stats": eng.spec_stats}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m squeezellm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        src = sp.add_mutually_exclusive_group(required=True)
        src.add_argument("--model", help="quantized checkpoint directory")
        src.add_argument("--synthetic", metavar="CONFIG",
                         help="HF config.json (or its directory) of a random "
                              "Dense-and-Sparse model")
        sp.add_argument("--wbits", type=int, default=4, choices=[3, 4],
                        help="bit width of a --synthetic model")
        sp.add_argument("--device", default="cuda")
        sp.add_argument("--mode", default="exact", choices=["exact", "bf16"])
        sp.add_argument("--seed", type=int, default=0,
                        help="seed of a --synthetic model's weights (and of "
                             "generate's sampler)")

    def tokens(sp):
        sp.add_argument("--dataset", default="synthetic",
                        help="'synthetic', a .npy file of token ids, or a "
                             "text dataset (wikitext2, ptb, c4, ...; needs "
                             "the model directory's tokenizer)")
        sp.add_argument("--seqlen", type=int, default=2048)

    def decode(sp):
        sp.add_argument("--fuse", action="store_true",
                        help="fuse q|k|v and gate|up projections")
        sp.add_argument("--kv-dtype", default=None,
                        choices=["bf16", "f32", "int8"],
                        help="KV cache storage; int8 stores codes and "
                             "per-row f32 scales")

    q = sub.add_parser("quantize", help="quantize a dense HF checkpoint")
    q.add_argument("--model", required=True,
                   help="HF model dir (config + weights)")
    q.add_argument("--gradient", default=None,
                   help="dir of grad^2 chunks (layer_{i}.npz from `fisher`, "
                        "or the reference's layer_{i}.pt)")
    q.add_argument("--bits", type=int, default=4, choices=[3, 4])
    q.add_argument("--sensitivity", type=float, default=0.0,
                   help="top-%% of weights by grad^2 moved to sparse")
    q.add_argument("--outlier-range", type=float, default=None,
                   help="IQR multiplier for threshold outliers (e.g. 1.8)")
    q.add_argument("--method", default="auto", choices=METHODS,
                   help=METHOD_HELP)
    q.add_argument("--quantize-lm-head", action="store_true",
                   help="also quantize lm_head (the reference keeps it "
                        "fp16)")
    q.add_argument("--output", required=True)
    q.add_argument("--device", default="cuda")
    q.set_defaults(fn=cmd_quantize)

    fi = sub.add_parser("fisher", help="compute grad^2 sensitivity chunks")
    fi.add_argument("--model", required=True)
    fi.add_argument("--dataset", default="synthetic",
                    help="'synthetic', a .npy file of token ids, or a text "
                         "dataset read with the --model directory's "
                         "tokenizer")
    fi.add_argument("--nsamples", type=int, default=128)
    fi.add_argument("--seqlen", type=int, default=2048)
    fi.add_argument("--seed", type=int, default=0)
    fi.add_argument("--batch-size", type=int, default=1)
    fi.add_argument("--output", required=True)
    fi.add_argument("--device", default="cuda")
    fi.set_defaults(fn=cmd_fisher)

    ch = sub.add_parser("chunk", help="split an HF checkpoint into "
                        "per-layer weight chunks")
    ch.add_argument("--model", required=True)
    ch.add_argument("--output", required=True)
    ch.set_defaults(fn=cmd_chunk)

    oc = sub.add_parser("outlier-config", help="IQR outlier thresholds")
    oc.add_argument("--chunks", required=True)
    oc.add_argument("--range", type=float, required=True,
                    help="IQR multiplier (e.g. 1.8)")
    oc.add_argument("--output", required=True)
    oc.set_defaults(fn=cmd_outlier_config)

    nq = sub.add_parser("nuq", help="per-layer weighted k-means "
                        "(resumable)")
    nq.add_argument("--chunks", required=True)
    nq.add_argument("--gradient-chunks", default=None,
                    help="dir of grad^2 chunks (layer_{i}.npz)")
    nq.add_argument("--bits", type=int, default=4, choices=[3, 4])
    nq.add_argument("--sensitivity", type=float, default=0.0)
    nq.add_argument("--outlier-config", default=None)
    nq.add_argument("--method", default="auto", choices=METHODS,
                    help=METHOD_HELP)
    nq.add_argument("--seed", type=int, default=0)
    nq.add_argument("--output", required=True)
    nq.add_argument("--device", default="cuda")
    nq.set_defaults(fn=cmd_nuq)

    pk = sub.add_parser("pack", help="collate codebooks into a quantized "
                        "checkpoint")
    pk.add_argument("--model", required=True)
    pk.add_argument("--nuq", required=True)
    pk.add_argument("--wbits", type=int, required=True, choices=[3, 4])
    pk.add_argument("--no-spmv", action="store_true",
                    help="accepted for the JAX command's sake: the port "
                         "writes no SpMV slot plans (a TPU layout) either "
                         "way")
    pk.add_argument("--output", required=True)
    pk.add_argument("--device", default="cuda")
    pk.set_defaults(fn=cmd_pack)

    c = sub.add_parser("convert", help="convert a reference SqueezeLLM .pt")
    c.add_argument("--checkpoint", required=True)
    c.add_argument("--model", required=True,
                   help="HF model dir with config.json")
    c.add_argument("--wbits", type=int, required=True, choices=[3, 4])
    c.add_argument("--output", required=True)
    c.add_argument("--device", default="cuda",
                   help="where the packed words are unpacked and repacked")
    c.set_defaults(fn=cmd_convert)

    e = sub.add_parser("eval", help="perplexity evaluation")
    common(e)
    tokens(e)
    e.add_argument("--nsamples", type=int, default=None,
                   help="strides to evaluate (default: the whole corpus)")
    e.add_argument("--group", type=int, default=8,
                   help="strides per forward")
    e.set_defaults(fn=cmd_eval)

    b = sub.add_parser("benchmark", help="decode latency benchmark")
    common(b)
    tokens(b)
    decode(b)
    b.add_argument("--tokens", type=int, default=128)
    b.add_argument("--check", action="store_true",
                   help="also compute the fed sequence's next-token "
                        "perplexity inside the timed loop (check_ppl)")
    b.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the benchmark "
                        "to DIR/trace.json and print its per-kernel "
                        "device time")
    b.set_defaults(fn=cmd_benchmark)

    def serving_args(sp, seqlen):
        sp.add_argument("--slots", type=int, default=8)
        sp.add_argument("--seqlen", type=int, default=seqlen,
                        help="the engine's max_seq")
        sp.add_argument("--window", type=int, default=8,
                        help="decode steps a host sync")
        sp.add_argument("--paged", action="store_true",
                        help="the paged KV pool with prefix sharing")
        sp.add_argument("--page-size", type=int, default=128)
        sp.add_argument("--speculative", nargs=2, type=int, default=None,
                        metavar=("DRAFT_LEN", "NGRAM"),
                        help="slot-batched prompt-lookup speculation "
                             "(greedy-exact)")
        sp.add_argument("--prefill-chunk", type=int, default=None,
                        help="admit long prompts N tokens an engine step, "
                             "interleaved with decode")
        sp.add_argument("--tp", type=int, default=0,
                        help="tensor-parallel serving over N ranks, one "
                             "process each (Megatron column/row-parallel "
                             "linears, KV heads split); started by the "
                             "command, or by torchrun")

    sb = sub.add_parser("serve-bench",
                        help="continuous-batching throughput benchmark")
    common(sb)
    decode(sb)
    serving_args(sb, 256)
    sb.add_argument("--requests", type=int, default=32)
    sb.add_argument("--max-new-tokens", type=int, default=32)
    sb.set_defaults(fn=cmd_serve_bench)

    sv = sub.add_parser("serve", help="HTTP serving front end "
                        "(/v1/completions and /health)")
    common(sv)
    decode(sv)
    serving_args(sv, 2048)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.set_defaults(fn=cmd_serve)

    g = sub.add_parser("generate", help="generate tokens")
    common(g)
    decode(g)
    g.add_argument("--prompt-tokens", required=True,
                   help="comma-separated ids")
    g.add_argument("--max-new-tokens", type=int, default=32)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (greedy-exact)")
    g.add_argument("--draft-model", default=None,
                   help="a smaller model of the same vocabulary, a "
                        "checkpoint directory or (with --synthetic) a "
                        "config: two-model speculative decoding "
                        "(greedy-exact)")
    g.add_argument("--draft-layers", type=int, default=0,
                   help="early-exit draft: speculate with the target's "
                        "first K layers (weights shared, greedy-exact)")
    g.add_argument("--draft-len", type=int, default=8)
    g.add_argument("--ngram", type=int, default=2)
    g.set_defaults(fn=cmd_generate)

    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    tp = _tp(args)
    if tp > 1:
        if args.kv_dtype == "int8" and not args.paged:
            raise SystemExit("--kv-dtype int8 on the dense engine is single-"
                             "device only (use --paged for tensor-parallel "
                             "int8 KV)")
        if not _join_ranks(args, argv, tp):
            return
    args.fn(args)


def _join_ranks(args, argv, tp: int) -> bool:
    """Make this process a rank of a ``--tp`` command: under torchrun join
    its group (True: go on); otherwise start the ``tp`` ranks, which run
    the command themselves, and wait for them (False: done)."""
    import torch.distributed as dist

    from squeezellm_tpu_torch.parallel import multihost

    if dist.is_initialized():  # a rank this command started
        return True
    backend = multihost.backend_for(args.device, tp)
    if os.environ.get("WORLD_SIZE"):
        multihost.initialize(backend=backend)
        if dist.get_world_size() != tp:
            raise SystemExit(f"--tp {tp} under a group of "
                             f"{dist.get_world_size()} ranks")
        dev = multihost.rank_device(args.device, dist.get_rank(), backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return True
    if torch.device(args.device).type == "cuda":
        from squeezellm_tpu_torch import _build

        _build.build()  # once, before the ranks load it
    try:
        multihost.launch(_tp_rank, tp, args=(argv,), device=args.device)
    except KeyboardInterrupt:  # serve's end: the launcher stops the ranks
        pass
    return False
