"""Random LLaMA and OPT models made on the device from a seeded generator.

``quantized_llama`` is the flagship the JAX package's ``bench.py`` measures
(``_build_quantized_llama``): packed random codes, sorted random LUTs
(scale 0.02), a 0.45% COO-style sparse sidecar (every entry live, rows
sorted, values N(0, 0.08)), top-X=10 hybrid channels (N(0, 0.05)), a
quantized lm_head at the model's bit width, a bf16 embedding and unit
norms. Unlike ``bench.py``, every layer gets its own tensors: a layer set
shared across layers would let the 50 MB L2 of an H100 serve part of each
step from cache and inflate the achieved bandwidth.

``dense_llama`` is the speed yardstick: the same config with bf16 dense
weights (N(0, 1) * 0.5 / sqrt(in), as the JAX ``random_dense_params``).

``structured=True`` (4-bit) gives every LUT ``bench.py``'s structured
statistics instead, centred: ``lut[c] = A[c & 7] + (c >> 3) * d`` with d =
|N(0, 0.01)| + 0.005 per channel and A the sorted N(0, 0.02) draws of 8
entries less d / 2 (the form ``quantize.kmeans.fit_structured_luts`` fits,
which ``models.fuse`` detects and sends through K10). ``bench.py`` does
not subtract d / 2: there every weight is biased by d / 2 on average, so
each linear amplifies the common mode of its input by ~in * d / 2 (~27 at
4096 inputs) and 32 layers overflow even f32; it only times the model.

``quantized_mellum`` is ``quantized_llama`` for a sparse-expert config
(``models/moe.MoEConfig``): attention linears and every expert's gate, up
and down as above, a router of N(0, 1.5 / sqrt(hidden)) f32 (logits of
deviation 1.5 at unit-rms states, so that a token's top-k weights spread
over several experts), stacked experts (``models.moe.Experts``) and the
model's counters attached.

``quantized_opt`` and ``dense_opt`` are the same two for an OPT config:
every layer linear also has a bias (N(0, 0.02)), the lm_head has none, the
layer norms are unit with zero bias, and the learned position table has
``max_seq + 2`` rows (N(0, 0.02)).
"""

from __future__ import annotations

import math

import torch

from squeezellm_tpu_torch import formats
from squeezellm_tpu_torch.models import llama, moe, opt
from squeezellm_tpu_torch.models.common import Linear, LinearSpec
from squeezellm_tpu_torch.ops.quant_linear import QuantLinearSpec


def _lut(gen, device, out_f: int, bits: int, structured: bool):
    if structured and bits == 4:
        a = (torch.randn(out_f, 8, generator=gen, device=device)
             * 0.02).sort(dim=1).values
        d = (torch.randn(out_f, 1, generator=gen, device=device).abs()
             * 0.01 + 0.005)
        a = a - d / 2
        return torch.cat([a, a + d], dim=1)
    return (torch.randn(out_f, 2**bits, generator=gen, device=device)
            * 0.02).sort(dim=1).values


def random_quant_linear(gen, device, out_f: int, in_f: int, bits: int,
                        sparsity: float, topx: int, bias: bool = False,
                        structured: bool = False) -> Linear:
    """One random quantized linear (bench.py's statistics), unfused."""
    nw = formats.n_words(in_f, bits)
    tensors = {
        "qweight": torch.randint(-2**31, 2**31 - 1, (nw, out_f),
                                 generator=gen, device=device,
                                 dtype=torch.int64).to(torch.int32),
        "lut": _lut(gen, device, out_f, bits, structured),
    }
    nnz = 0
    n = int(out_f * in_f * sparsity)
    if n:
        nnz = max(512, -(-n // 512) * 512)  # bench.py's padded count, all live
        rows = torch.randint(0, out_f, (nnz,), generator=gen,
                             device=device).sort().values
        counts = torch.bincount(rows, minlength=out_f)
        rowptr = torch.zeros(out_f + 1, dtype=torch.int64, device=device)
        rowptr[1:] = torch.cumsum(counts, 0)
        tensors["sp_rowptr"] = rowptr.to(torch.int32)
        tensors["sp_cols"] = torch.randint(0, in_f, (nnz,), generator=gen,
                                           device=device, dtype=torch.int32)
        tensors["sp_vals"] = torch.randn(nnz, generator=gen,
                                         device=device) * 0.08
    if topx:
        tensors["topx_weights"] = torch.randn(in_f, topx, generator=gen,
                                              device=device) * 0.05
        tensors["topx_indices"] = torch.randperm(
            out_f, generator=gen, device=device)[:topx].to(torch.int32)
    if bias:
        tensors["bias"] = torch.randn(out_f, generator=gen,
                                      device=device) * 0.02
    q = QuantLinearSpec(bits=bits, in_features=in_f, out_features=out_f,
                        has_bias=bias, nnz=nnz, topx=topx)
    return Linear(LinearSpec(in_features=in_f, out_features=out_f,
                             has_bias=bias, quant=q), tensors)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def quantized_llama(config: llama.LlamaConfig, bits: int, *,
                    sparsity: float = 0.0045, topx: int = 10,
                    seed: int = 0, device="cuda",
                    structured: bool = False) -> llama.Llama:
    """The random Dense-and-Sparse flagship, unfused; with ``structured``
    (4-bit) every LUT, the lm_head's included, is a structured one."""
    device = torch.device(device)
    gen = _generator(seed, device)
    h = config.hidden_size
    layers = []
    for _ in range(config.n_layers):
        linears = {name: random_quant_linear(gen, device, o, i, bits,
                                             sparsity, topx,
                                             structured=structured)
                   for name, (o, i) in config.linear_shapes().items()}
        layers.append(llama.DecoderLayer(
            config, linears, torch.ones(h, device=device),
            torch.ones(h, device=device)))
    embed = (torch.randn(config.vocab_size, h, generator=gen, device=device)
             * 0.02).to(torch.bfloat16)
    head = random_quant_linear(gen, device, config.vocab_size, h, bits, 0.0, 0,
                               structured=structured)
    return llama.Llama(config, embed, layers, torch.ones(h, device=device),
                       head)


ROUTER_GAIN = 1.5  # a router weight's std times sqrt(hidden)


def quantized_mellum(config: moe.MoEConfig, bits: int, *,
                     sparsity: float = 0.0045, topx: int = 10,
                     seed: int = 0, device="cuda") -> llama.Llama:
    """The random Dense-and-Sparse sparse-expert model, unfused."""
    device = torch.device(device)
    gen = _generator(seed, device)
    h = config.hidden_size
    layers = []
    for i in range(config.n_layers):
        linears = {name: random_quant_linear(gen, device, o, i_f, bits,
                                             sparsity, topx)
                   for name, (o, i_f) in config.linear_shapes().items()}
        experts = {
            name: moe.Experts.stack([
                random_quant_linear(gen, device, o, i_f, bits, sparsity,
                                    topx)
                for _ in range(config.n_experts)])
            for name, (o, i_f) in config.expert_shapes().items()}
        router = torch.randn(config.n_experts, h, generator=gen,
                             device=device) * (ROUTER_GAIN / math.sqrt(h))
        layers.append(llama.DecoderLayer(
            config, linears, torch.ones(h, device=device),
            torch.ones(h, device=device),
            mlp=moe.MoEBlock(config, router, experts),
            layer_type=config.layer_type(i)))
    embed = (torch.randn(config.vocab_size, h, generator=gen, device=device)
             * 0.02).to(torch.bfloat16)
    head = random_quant_linear(gen, device, config.vocab_size, h, bits, 0.0,
                               0)
    return moe.attach_counters(llama.Llama(
        config, embed, layers, torch.ones(h, device=device), head))


def dense_llama(config: llama.LlamaConfig, *, seed: int = 0,
                device="cuda") -> llama.Llama:
    """The dense yardstick model: every weight in bf16."""
    dtype = torch.bfloat16
    device = torch.device(device)
    gen = _generator(seed, device)
    h = config.hidden_size

    def lin(o, i, scale):
        w = torch.randn(o, i, generator=gen, device=device, dtype=dtype)
        return Linear(LinearSpec(in_features=i, out_features=o),
                      {"w": w * scale})

    layers = []
    for _ in range(config.n_layers):
        linears = {name: lin(o, i, 0.5 / math.sqrt(i))
                   for name, (o, i) in config.linear_shapes().items()}
        layers.append(llama.DecoderLayer(
            config, linears, torch.ones(h, device=device, dtype=dtype),
            torch.ones(h, device=device, dtype=dtype)))
    embed = torch.randn(config.vocab_size, h, generator=gen, device=device,
                        dtype=dtype) * 0.02
    return llama.Llama(config, embed, layers,
                       torch.ones(h, device=device, dtype=dtype),
                       lin(config.vocab_size, h, 0.02))


def _opt_model(config: opt.OPTConfig, gen, device, dtype, make_linear,
               make_head) -> opt.OPT:
    h = config.hidden_size

    def norm():
        return (torch.ones(h, device=device, dtype=dtype),
                torch.zeros(h, device=device, dtype=dtype))

    layers = []
    for _ in range(config.n_layers):
        linears = {name: make_linear(o, i)
                   for name, (o, i) in config.linear_shapes().items()}
        layers.append(opt.DecoderLayer(
            config, linears, {"attn_norm": norm(), "ffn_norm": norm()}))
    embed = (torch.randn(config.vocab_size, h, generator=gen, device=device)
             * 0.02).to(torch.bfloat16)
    embed_pos = (torch.randn(config.max_seq + opt.POS_OFFSET, h,
                             generator=gen, device=device)
                 * 0.02).to(torch.bfloat16)
    return opt.OPT(config, embed, embed_pos, layers, norm(), make_head())


def quantized_opt(config: opt.OPTConfig, bits: int, *,
                  sparsity: float = 0.0045, topx: int = 10, seed: int = 0,
                  device="cuda") -> opt.OPT:
    """The random Dense-and-Sparse OPT, unfused, with a quantized head."""
    device = torch.device(device)
    gen = _generator(seed, device)
    return _opt_model(
        config, gen, device, torch.float32,
        lambda o, i: random_quant_linear(gen, device, o, i, bits, sparsity,
                                         topx, bias=True),
        lambda: random_quant_linear(gen, device, config.vocab_size,
                                    config.hidden_size, bits, 0.0, 0))


def dense_opt(config: opt.OPTConfig, *, seed: int = 0,
              device="cuda") -> opt.OPT:
    """The dense OPT of the same config: every weight in bf16."""
    dtype = torch.bfloat16
    device = torch.device(device)
    gen = _generator(seed, device)

    def lin(o, i, scale, bias):
        tensors = {"w": torch.randn(o, i, generator=gen, device=device,
                                    dtype=dtype) * scale}
        if bias:
            tensors["b"] = torch.randn(o, generator=gen, device=device,
                                       dtype=dtype) * 0.02
        return Linear(LinearSpec(in_features=i, out_features=o,
                                 has_bias=bias), tensors)

    return _opt_model(
        config, gen, device, dtype,
        lambda o, i: lin(o, i, 0.5 / math.sqrt(i), True),
        lambda: lin(config.vocab_size, config.hidden_size, 0.02, False))
