"""Seeded raw weights, made on the device.

One recipe for both sides: the port gets these arrays packed by its own
``formats`` functions (``pbench/port.py``), the plain reference gets them
as they are (``reference/``). ``layer`` and ``globals_`` make the dense
families' weights (``families/mistral.py``, ``families/opt.py``); every
layer draws from a generator of its own, seeded from (seed, layer), so
the reference can make one layer at a time again after the program's
state is freed. ``raw_linear`` makes one linear in the same recipe from a
generator of its own (seed, tag), for a family whose layers hold other
linears.

The recipe follows the reference implementation's packed checkpoints:
every decoder linear is 4-bit with one LUT of 16 values per output
channel, plus a 0.45% sparse sidecar (added on top of the LUT's value at
its slot) and top-X dense rows (added to X output channels); embeddings
and ``lm_head`` are dense bf16, norms and biases f32.

Scales keep the model out of chaos and out of rank collapse, so that a
served token's logit gap measures the arithmetic. Each code appears
equally often in a row, so that a row's weights sum to about 0 as its LUT
does and no layer adds a vector common to every token behind OPT's ReLU
(whose outputs average 0.4). A LUT's values are
sorted N(0, gain / sqrt(in)) draws less their mean (gain 1 keeps a
linear's output at its input's scale; o takes 0.5), outliers are
N(0, 3 / sqrt(in)), embeddings N(0, 1), and the head (LLaMA family) or
the final norm before OPT's tied head gives logits of deviation about 2.
Attention scores then deviate by about 1. Trials of the reference at
32 layers (full width on an H100, 512 wide on the CPU) chose these:

* q and k at twice the gain (scores of deviation 4) made the model
  chaotic: bf16 rounding grew through the layers until a bf16 and an f32
  forward's logits differed by 5-6, as far apart as float8's.
* embeddings of 0.03 and o at gain 1 let attention's averaging wash the
  tokens out: 43% (OPT 89%) of the logits' variance was common to every
  position, and 50 (OPT 7) of 200 positions had a distinct best token, so
  a slot served another slot's token could go unseen. At 1 and 0.5: 2%
  (OPT 58%) and 191 (OPT 180) of 200; with balanced codes OPT's 18% and
  197 of 200 (at full width unbalanced: 72% and 4 of 192).
* OPT ties its head to the token embedding, so an embedding of 1 that
  the residual carries to the end gives the input token a logit of
  ~HEAD_GAIN * sqrt(hidden) / rms(state), far above every other: 99% of
  positions predicted their own token and greedy decoding repeated it.
  OPT's configuration sets ``embed_std`` 0.1 (no position copies its
  token; 45% of the variance common, 92 of 160 best tokens distinct at
  512 wide).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

LUT_GAIN = 1.0      # a LUT value's std times sqrt(in); q and k too
O_GAIN = 0.5        # the same for o
OUTLIER_GAIN = 3.0  # a sidecar value's std times sqrt(in)
TOPX_GAIN = 1.0     # a top-X weight's std times sqrt(in)
HEAD_GAIN = 2.0     # the logits' std at unit-rms final states
NORM_JITTER = 0.05  # norm weights 1 + N(0, jitter)
BIAS_STD = 0.02     # OPT's biases and layer-norm biases


def derive(seed: int, tag: str) -> int:
    """A 63-bit generator seed for (seed, tag); any integer seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def is_opt(cfg: dict) -> bool:
    return cfg["model_type"] == "opt"


def kv_heads(cfg: dict) -> int:
    return cfg.get("num_key_value_heads") or cfg["num_attention_heads"]


def head_dim(cfg: dict) -> int:
    """The configuration's ``head_dim`` where it gives one, else hidden /
    heads."""
    return (cfg.get("head_dim")
            or cfg["hidden_size"] // cfg["num_attention_heads"])


def ffn(cfg: dict) -> int:
    return cfg["ffn_dim"] if is_opt(cfg) else cfg["intermediate_size"]


def linear_shapes(cfg: dict) -> Dict[str, Tuple[int, int]]:
    """(out, in) of each linear of a decoder layer, by the port's names."""
    h, f = cfg["hidden_size"], ffn(cfg)
    kv = kv_heads(cfg) * head_dim(cfg)
    shapes = {"q": (h, h), "k": (kv, h), "v": (kv, h), "o": (h, h)}
    if is_opt(cfg):
        shapes.update(up=(f, h), down=(h, f))
    else:
        shapes.update(gate=(f, h), up=(f, h), down=(h, f))
    return shapes


def embed_std(cfg: dict) -> float:
    """Token (and OPT position) embeddings' std: 1, or the
    configuration's ``weights.embed_std``."""
    return cfg.get("weights", {}).get("embed_std", 1.0)


def quant(cfg: dict) -> dict:
    return cfg["quant"]


def sidecar_count(out_f: int, in_f: int, sparsity: float) -> int:
    return max(1, round(out_f * in_f * sparsity))


def _balanced_codes(out_f: int, in_f: int, k: int, gen, device):
    """uint8 codes (out, in): in each row every code in/k times (in % k
    == 0; the rest otherwise spread), in a random order."""
    order = torch.rand(out_f, in_f, generator=gen, device=device).argsort(1)
    return (order % k).to(torch.uint8)


def _lut(draws: torch.Tensor, std: float) -> torch.Tensor:
    """Sorted LUTs of ``draws * std``, each channel's mean taken out: with
    uniform codes a weight's mean is then 0, as k-means centroids of a
    trained layer's weights are near 0. Left in, a channel's mean (about
    std / 4) summed over in inputs adds in * std / 4 times the input's mean
    to its output: behind OPT's ReLU (mean 0.4) that is ~13 a channel at
    ffn 16384, a token-independent vector that sets every logit's rank."""
    lut = draws * std
    return (lut - lut.mean(1, keepdim=True)).sort(1).values


@torch.no_grad()
def raw_linear(seed: int, tag: str, out_f: int, in_f: int, quant: dict,
               gain: float, device, bias_std=None) -> dict:
    """One linear's raw arrays in the recipe of ``layer`` (balanced codes,
    a sorted mean-free LUT a channel at ``gain``, the bucketed sidecar,
    top-X rows; a bias of ``bias_std`` where given), drawn from a
    generator of its own seeded from (seed, tag): for architectures whose
    layers hold many linears, such as experts, each under a tag of its
    own. ``layer`` keeps its own code: it draws a whole layer's arrays of
    each kind at once, and its every allocation, in order, is what the
    published cells' ``peak_mem_gib`` was measured with (the caching
    allocator's peak counts whole blocks, so moving a temporary's free
    moves the reading by megabytes)."""
    bits, topx = quant["bits"], quant["topx"]
    gen = generator(seed, tag, device)
    n = sidecar_count(out_f, in_f, quant["sparsity"])
    codes = _balanced_codes(out_f, in_f, 2**bits, gen, device)
    lut_draws = torch.randn(out_f, 2**bits, generator=gen, device=device)
    offs = torch.rand(n, generator=gen, device=device)
    vals = torch.randn(n, generator=gen, device=device)
    tw = torch.randn(in_f, topx, generator=gen, device=device)
    bucket = out_f * in_f // n
    pos = (torch.arange(n, device=device) * bucket
           + (offs * bucket).long().clamp(max=bucket - 1))
    lin = {
        "codes": codes,
        "lut": _lut(lut_draws, gain / math.sqrt(in_f)),
        "sp_rows": pos // in_f,
        "sp_cols": pos % in_f,
        "sp_vals": vals * (OUTLIER_GAIN / math.sqrt(in_f)),
        "topx_idx": torch.randperm(out_f, generator=gen,
                                   device=device)[:topx].sort().values,
        "topx_w": tw * (TOPX_GAIN / math.sqrt(in_f)),
    }
    if bias_std is not None:
        lin["bias"] = torch.randn(out_f, generator=gen,
                                  device=device) * bias_std
    return lin


@torch.no_grad()
def layer(cfg: dict, seed: int, index: int, device) -> dict:
    """Layer ``index``'s raw arrays: per linear ``codes`` uint8 (out, in),
    ``lut`` f32 (out, 2**bits) sorted, the sidecar ``sp_rows``/``sp_cols``
    int64 (sorted by row, then column; no slot twice) and ``sp_vals`` f32,
    ``topx_idx`` int64 (X,) sorted and ``topx_w`` f32 (in, X), and for OPT
    ``bias`` f32 (out,); then the norms."""
    q = quant(cfg)
    bits, topx = q["bits"], q["topx"]
    gen = generator(seed, f"layer{index}", device)
    shapes = linear_shapes(cfg)
    sizes = [o * i for o, i in shapes.values()]
    outs = [o for o, _ in shapes.values()]
    # each code equally often in a row, in a random order of the seed's
    codes = [_balanced_codes(o, i, 2**bits, gen, device)
             for o, i in shapes.values()]
    luts = torch.randn(sum(outs), 2**bits, generator=gen, device=device)
    nnz = [sidecar_count(o, i, q["sparsity"]) for o, i in shapes.values()]
    # one slot a bucket of size // nnz consecutive row-major slots: no slot
    # twice, rows and columns in order
    offs = torch.rand(sum(nnz), generator=gen, device=device)
    vals = torch.randn(sum(nnz), generator=gen, device=device)
    tw = torch.randn(topx * sum(i for _, i in shapes.values()),
                     generator=gen, device=device)
    h = cfg["hidden_size"]
    norms = torch.randn(4 * h, generator=gen, device=device)
    biases = (torch.randn(sum(outs), generator=gen, device=device)
              if is_opt(cfg) else None)
    linears = {}
    l0 = n0 = t0 = 0
    for k, ((name, (o, i)), size, n) in enumerate(zip(shapes.items(), sizes,
                                                      nnz)):
        gain = O_GAIN if name == "o" else LUT_GAIN
        bucket = size // n
        pos = (torch.arange(n, device=device) * bucket
               + (offs[n0:n0 + n] * bucket).long().clamp(max=bucket - 1))
        lin = {
            "codes": codes[k],
            "lut": _lut(luts[l0:l0 + o], gain / math.sqrt(i)),
            "sp_rows": pos // i,
            "sp_cols": pos % i,
            "sp_vals": vals[n0:n0 + n] * (OUTLIER_GAIN / math.sqrt(i)),
            "topx_idx": torch.randperm(o, generator=gen,
                                       device=device)[:topx].sort().values,
            "topx_w": (tw[t0:t0 + i * topx].view(i, topx)
                       * (TOPX_GAIN / math.sqrt(i))),
        }
        if biases is not None:
            lin["bias"] = biases[l0:l0 + o] * BIAS_STD
        linears[name] = lin
        l0, n0, t0 = l0 + o, n0 + n, t0 + i * topx
    w = 1 + NORM_JITTER * norms[:2 * h]
    if is_opt(cfg):
        b = BIAS_STD * norms[2 * h:]
        norm = {"attn_norm": (w[:h], b[:h]), "ffn_norm": (w[h:], b[h:])}
    else:
        norm = {"input_norm": w[:h], "post_norm": w[h:]}
    return {"linears": linears, "norms": norm}


@torch.no_grad()
def globals_(cfg: dict, seed: int, device) -> dict:
    """The embeddings, the final norm and the head: ``embed`` bf16
    (vocab, hidden); OPT's ``embed_pos`` bf16 (positions + 2, hidden) and
    its head tied to ``embed``, as OPT's checkpoints tie it; the LLaMA
    family's own ``lm_head`` bf16 (vocab, hidden)."""
    std = embed_std(cfg)
    gen = generator(seed, "globals", device)
    v, h = cfg["vocab_size"], cfg["hidden_size"]
    bf = torch.bfloat16
    out = {"embed": torch.randn(v, h, generator=gen, device=device,
                                dtype=bf) * std}
    jitter = torch.randn(2 * h, generator=gen, device=device)
    w = 1 + NORM_JITTER * jitter[:h]
    if is_opt(cfg):
        out["embed_pos"] = torch.randn(
            cfg["max_position_embeddings"] + 2, h, generator=gen,
            device=device, dtype=bf) * std
        # the tied head's logits at HEAD_GAIN's deviation: the final norm's
        # weight and bias scaled alike (an unscaled bias of 0.02 gave
        # every position a common logit vector of deviation 1.3)
        g = HEAD_GAIN / (std * math.sqrt(h))
        out["final_norm"] = (w * g, BIAS_STD * jitter[h:] * g)
        out["lm_head"] = out["embed"]
    else:
        out["final_norm"] = w
        out["lm_head"] = torch.randn(v, h, generator=gen, device=device,
                                     dtype=bf) * (HEAD_GAIN
                                                  / math.sqrt(h))
    return out
