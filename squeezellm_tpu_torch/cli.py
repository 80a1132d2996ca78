"""Command line of the port: ``python -m squeezellm_tpu_torch <command>``.

  quantize   dense HF checkpoint (+ optional grad^2 chunks) -> quantized
             checkpoint (outliers -> k-means -> pack, one layer at a time)
  fisher     grad^2 sensitivity chunks of a dense HF checkpoint
  eval       perplexity (GPTQ stride protocol) on ``synthetic`` tokens or a
             ``.npy`` token file
  benchmark  batch-1 decode latency, tok/s, peak memory
  generate   greedy or sampled generation from comma-separated prompt token
             ids, or greedy with prompt-lookup or draft-model speculation

``quantize`` and ``fisher`` take the JAX package's arguments (``--model``
an HF directory with ``config.json`` and its weights). ``eval``,
``benchmark`` and ``generate`` take ``--model DIR`` (a quantized checkpoint
directory, which either package's ``save_quantized`` writes) or
``--synthetic CONFIG --wbits N`` (a random Dense-and-Sparse model of an HF
``config.json``, e.g. ``models/llama-2-7b/config.json``). Every command
takes ``--device`` (default ``cuda``). ``--mode exact`` runs f32
throughout; ``--mode bf16`` the flagship regime (bf16 activations and
cache, bf16-rounded LUT and x with f32 accumulation). The counterpart of
the JAX package's ``cli.py`` commands of the same names; its staged
commands (chunk, outlier-config, nuq, pack) and ``convert`` are not
ported.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

CALIB_SAMPLES = 128  # sizes the synthetic corpus as the JAX CLI's default


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
        make = (synthetic.quantized_opt if model_type == "opt"
                else synthetic.quantized_llama)
        model = make(config, args.wbits, seed=args.seed, device=args.device)
    if getattr(args, "fuse", False):
        fuse.fuse_for_decode(model)
    return model


def _tokens(args, config) -> np.ndarray:
    from squeezellm_tpu_torch import data

    _, test = data.get_loaders(args.dataset, nsamples=CALIB_SAMPLES,
                               seed=args.seed, seqlen=args.seqlen,
                               vocab_size=config.vocab_size)
    return np.asarray(test)


def _engine(args, model):
    from squeezellm_tpu_torch import engine

    bf16 = args.mode == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    cache = {None: dtype, "bf16": torch.bfloat16, "f32": torch.float32,
             "int8": "int8"}[args.kv_dtype]
    return engine.Engine(model, dtype=dtype, cache_dtype=cache,
                         mode=args.mode)


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
    calib, _ = data.get_loaders(args.dataset, nsamples=args.nsamples,
                                seed=args.seed, seqlen=args.seqlen,
                                vocab_size=config.vocab_size)
    grads = gradients.compute_fisher(model_type, config, params, calib,
                                     batch_size=args.batch_size,
                                     verbose=True, device=args.device)
    gradients.save_gradient_chunks(grads, args.output, model_type,
                                   args.model)
    print(f"grad^2 chunks -> {args.output}")


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
    print(json.dumps(_engine(args, model).benchmark(ids, check=args.check),
                     indent=2))


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
                        help="'synthetic' or a .npy file of token ids")
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
    q.add_argument("--method", default="auto",
                   choices=["auto", "native", "batched"],
                   help="k-means solver: 'auto' is 'native' (the sorted-"
                        "Lloyd C++ solver, built with the host's g++ at "
                        "first use), 'batched' the PyTorch one on the "
                        "device")
    q.add_argument("--quantize-lm-head", action="store_true",
                   help="also quantize lm_head (the reference keeps it "
                        "fp16)")
    q.add_argument("--output", required=True)
    q.add_argument("--device", default="cuda")
    q.set_defaults(fn=cmd_quantize)

    fi = sub.add_parser("fisher", help="compute grad^2 sensitivity chunks")
    fi.add_argument("--model", required=True)
    fi.add_argument("--dataset", default="synthetic",
                    help="'synthetic' or a .npy file of token ids")
    fi.add_argument("--nsamples", type=int, default=128)
    fi.add_argument("--seqlen", type=int, default=2048)
    fi.add_argument("--seed", type=int, default=0)
    fi.add_argument("--batch-size", type=int, default=1)
    fi.add_argument("--output", required=True)
    fi.add_argument("--device", default="cuda")
    fi.set_defaults(fn=cmd_fisher)

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
    b.set_defaults(fn=cmd_benchmark)

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

    args = p.parse_args(argv)
    args.fn(args)
