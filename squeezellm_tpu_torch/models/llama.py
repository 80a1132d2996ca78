"""LLaMA-family decoder (LLaMA 1/2, Vicuna, Mistral, XGen) in PyTorch.

The counterpart of the JAX package's ``models/llama.py`` for one device:
GQA, optional sliding window, a token-major KV cache (f32, bf16 or int8),
dense or a shared page pool. Decode attention goes through K2, or K5 over
an int8 cache (``ops/decode_attn``); over a page pool decode goes through
K6/K7 and a speculative verify window through K8/K9 (``ops/paged_attn``),
over a dense cache a verify window through plain attention (the JAX
package's XLA chain: it runs no kernel there); prefill and full-sequence
attention through K3 (``ops/flash_attn``) for every prompt length; every
quantized linear through K1
(``ops/lut_matmul``) below 1024 rows and K4 (``ops/dequant_dense``) from
there. ``plain=True`` runs each kernel's
plain PyTorch version instead, whatever the device: the reference the
kernels are held against on the card.

A tensor-parallel shard (``parallel.tp.shard_model``) is the same model
over its rank's linears, with ``model.tp`` set: the attention block takes
its head counts from its linears' widths (head_dim stays the config's),
the row-parallel o and down projections all-reduce their partial outputs
before the residual joins (:func:`row_parallel`), and the lm_head gathers
the vocab blocks, as the JAX package's ``axis_name=`` paths do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.models.common import Linear
from squeezellm_tpu_torch.ops import decode_attn, flash_attn, paged_attn
from squeezellm_tpu_torch.tracing import span


# each linear's name in an HF (and the reference's) state dict of a layer
HF_NAMES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
            "v": "self_attn.v_proj", "o": "self_attn.o_proj",
            "gate": "mlp.gate_proj", "up": "mlp.up_proj",
            "down": "mlp.down_proj"}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq: int = 2048
    sliding_window: Optional[int] = None  # Mistral: 4096
    tie_embeddings: bool = False
    # a head's width; None (the HF config gives none): hidden / heads
    head_dim: Optional[int] = None
    # each layer's attention type, "sliding_attention" (under
    # sliding_window) or "full_attention"; None: every layer alike, under
    # sliding_window where one is given
    layer_types: Optional[Tuple[str, ...]] = None
    # each layer type's rope as (type, RopeSpec) pairs; None: rope_theta's
    # default rope in every layer
    ropes: Optional[Tuple[Tuple[str, common.RopeSpec], ...]] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.hidden_size // self.n_heads)

    def layer_type(self, i: int) -> Optional[str]:
        return None if self.layer_types is None else self.layer_types[i]

    def window(self, layer_type: Optional[str]) -> Optional[int]:
        """The sliding window of a layer of this type (None: full)."""
        return None if layer_type == "full_attention" else \
            self.sliding_window

    def rope(self, layer_type: Optional[str]) -> common.RopeSpec:
        """The rope of a layer of this type."""
        return (dict(self.ropes) if self.ropes else {}).get(
            layer_type, common.RopeSpec(self.rope_theta))

    def linear_shapes(self) -> Dict[str, tuple]:
        """(out, in) of each quantizable module, torch W orientation."""
        h = self.hidden_size
        qd = self.n_heads * self.head_dim
        kv = self.n_kv_heads * self.head_dim
        return {
            "q": (qd, h),
            "k": (kv, h),
            "v": (kv, h),
            "o": (h, qd),
            "gate": (self.intermediate_size, h),
            "up": (self.intermediate_size, h),
            "down": (h, self.intermediate_size),
        }

    @staticmethod
    def hf_fields(d: dict) -> dict:
        """The fields read from an HF config.json dict."""
        types = d.get("layer_types")
        rp = d.get("rope_parameters")
        ropes = None
        if types and isinstance(rp, dict) and all(t in rp for t in types):
            ropes = tuple((t, common.RopeSpec.from_hf(rp[t]))
                          for t in sorted(set(types)))
        theta = d.get("rope_theta", 10000.0)
        if ropes:
            theta = ropes[0][1].theta
        return dict(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            n_layers=d["num_hidden_layers"],
            n_heads=d["num_attention_heads"],
            n_kv_heads=d.get("num_key_value_heads") or d["num_attention_heads"],
            rope_theta=theta,
            rms_eps=d.get("rms_norm_eps", 1e-5),
            max_seq=min(d.get("max_position_embeddings", 2048), 8192),
            sliding_window=d.get("sliding_window"),
            tie_embeddings=d.get("tie_word_embeddings", False),
            head_dim=d.get("head_dim"),
            layer_types=tuple(types) if types else None,
            ropes=ropes,
        )

    @staticmethod
    def from_hf_config(d: dict) -> "LlamaConfig":
        """From an HF config.json dict (llama / mistral / vicuna / xgen)."""
        return LlamaConfig(**LlamaConfig.hf_fields(d))

    def manifest(self) -> dict:
        """The fields a checkpoint's manifest records: the JAX package's
        (which has no head_dim, layer types or ropes), and beside them
        only those that depart from it."""
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)}
        if d["head_dim"] == self.hidden_size // self.n_heads:
            del d["head_dim"]
        for name in ("layer_types", "ropes"):
            if d[name] is None:
                del d[name]
        return d


def _state_dict_getter(sd, dtype):
    def g(name):
        return sd[name].detach().to("cpu", dtype)
    return g


def from_torch_state_dict(config: LlamaConfig, sd, dtype=torch.float32):
    """An HF LlamaForCausalLM / MistralForCausalLM state dict -> the dense
    params tree of the JAX package's ``from_torch_state_dict`` ({'embed',
    'layers': [{q..down: {'w'}, 'input_norm', 'post_norm'}], 'final_norm',
    'lm_head': {'w'}}), tensors in ``dtype`` on the CPU."""
    g = _state_dict_getter(sd, dtype)
    layers = []
    for i in range(config.n_layers):
        p = f"model.layers.{i}."
        d = {n: {"w": g(p + hf + ".weight")} for n, hf in HF_NAMES.items()}
        d["input_norm"] = g(p + "input_layernorm.weight")
        d["post_norm"] = g(p + "post_attention_layernorm.weight")
        layers.append(d)
    head = ("model.embed_tokens.weight"
            if config.tie_embeddings or "lm_head.weight" not in sd
            else "lm_head.weight")
    return {"embed": g("model.embed_tokens.weight"), "layers": layers,
            "final_norm": g("model.norm.weight"), "lm_head": {"w": g(head)}}


# a verify window of at most this many rows runs its linears as a decode
# step does (unless its caller passes window_decode=False): the JAX package's
# quantized linear takes one kernel and one sidecar fold for every call of
# up to SQUEEZELLM_SGB_MAX = 16 rows (``squeezellm_tpu/ops/quant_linear.py``)
WINDOW_DECODE_ROWS = 16


@dataclasses.dataclass
class Step:
    """Per-call state shared by every layer of one forward. A model
    without rope (OPT) leaves ``ropes`` empty."""

    dtype: torch.dtype
    mode: str
    plain: bool
    # each layer type's rope (key None where the model has one type,
    # ``LlamaConfig.layer_types``) as (cos, sin, rope_cos, rope_sin): cos
    # and sin (S, hd) in dtype where the layer ropes q and k itself
    # (prefill, a dense verify window), else None; rope_cos and rope_sin
    # (B, hd) f32, (B, W, hd) for a paged verify window, the attention
    # kernel's operands in decode, else None
    ropes: Dict[Optional[str], tuple] = dataclasses.field(
        default_factory=dict)
    # prefill: position of the first token, an int or an int tensor of one
    # element on the device (read by K3 and the cache write there)
    start: object = 0
    # decode (one token per slot, with a cache): K2/K5/K6/K7 operands
    lengths: Optional[torch.Tensor] = None  # (B,) int32
    # a verify window per slot (over a page pool the K8/K9 operand; over a
    # dense cache where the window's rows are written)
    starts: Optional[torch.Tensor] = None  # (B,) int32, < 0: inactive
    # a page pool's table, shared by every layer
    page_table: Optional[torch.Tensor] = None  # (B, maxp) int32
    # a speculative verify window (``verify_window``, or ``prefill`` with
    # ``all_logits``) called with window_decode: its rows in all, B * W; 0
    # for any other call
    window_rows: int = 0
    # a tensor-parallel shard's place (``model.tp``): row-parallel outputs
    # are all-reduced before the residual joins, the lm_head's gathered
    tp: Optional[common.TPGroup] = None

    def rope(self, layer_type: Optional[str]) -> tuple:
        """(cos, sin, rope_cos, rope_sin) of a layer of this type."""
        return self.ropes.get(layer_type, (None,) * 4)

    def lin(self) -> dict:
        """The linears' keyword arguments: the regime, and whether K1/K10
        run their decode kernel (``decode``; bf16 mode's decode tensor-core
        kernel, exact mode's GEMV). The call site picks the kernel, not the
        row count: a one-token-a-slot decode step takes the decode kernel,
        and so does a verify window of at most WINDOW_DECODE_ROWS rows, as
        the JAX package runs such a window through its decode step's
        kernel and fold; every other call takes the mode's kernel (the
        prefill tensor-core kernel in bf16 mode)."""
        window = 0 < self.window_rows <= WINDOW_DECODE_ROWS
        return dict(mode=self.mode, plain=self.plain,
                    decode=self.lengths is not None or window)


# (one token per slot, int8 pool) -> (kernel wrapper, plain version)
_PAGED_ATTN = {
    (True, False): (paged_attn.paged_decode_attention,
                    paged_attn.paged_decode_attention_plain),
    (True, True): (paged_attn.paged_decode_attention_q8,
                   paged_attn.paged_decode_attention_q8_plain),
    (False, False): (paged_attn.paged_verify_attention,
                     paged_attn.paged_verify_attention_plain),
    (False, True): (paged_attn.paged_verify_attention_q8,
                    paged_attn.paged_verify_attention_q8_plain),
}


def row_parallel(linear: Linear, x, step: Step, residual=None):
    """``_o_proj`` / the down projection of ``_mlp_block``: y = residual +
    x @ W, the residual folded into the linear's output init on one device.
    On a tensor-parallel shard the linear is row-parallel and its partial
    outputs are all-reduced BEFORE the residual joins: folded into each
    rank's partial, the sum would add it tp times."""
    lin = step.lin()
    if step.tp is None:
        return linear(x, y0=residual, **lin)
    y = common.all_reduce(linear(x, **lin), step.tp)
    return y if residual is None else residual + y


class AttnBlock(nn.Module):
    """``_attn_block``: q|k|v (fused or not), attention, o-proj with the
    residual, when one is given, folded into its output init
    (:func:`row_parallel`). Shared with OPT, whose steps carry no rope
    rows. ``layer_type`` (``LlamaConfig.layer_types``) picks the layer's
    window and its type's rope rows from the step."""

    def __init__(self, config, proj: Dict[str, Linear],
                 layer_type: Optional[str] = None):
        super().__init__()
        self.config = config
        self.proj = nn.ModuleDict(proj)
        self.layer_type = layer_type
        window = getattr(config, "window", None)
        self.window = (window(layer_type) if window is not None
                       else config.sliding_window)

    def heads(self):
        """(query heads, kv heads) this block holds, from its linears'
        widths, not the config: a tensor-parallel shard holds n_heads / tp
        and n_kv_heads / tp of them, while head_dim stays the config's. A
        fused q|k|v of (nh + 2 nkv) * hd outputs splits in the config's
        ratio (the JAX package's ``_attn_block``)."""
        cfg, hd = self.config, self.config.head_dim
        if "qkv" in self.proj:
            units = self.proj["qkv"].spec.out_features // hd
            nkv = cfg.n_kv_heads * units // (cfg.n_heads + 2 * cfg.n_kv_heads)
            return units - 2 * nkv, nkv
        return (self.proj["q"].spec.out_features // hd,
                self.proj["k"].spec.out_features // hd)

    def forward(self, x, step: Step, cache=None, residual=None):
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.head_dim
        nh, nkv = self.heads()
        lin = step.lin()
        if "qkv" in self.proj:
            qkv = self.proj["qkv"](x, **lin)
            q = qkv[..., : nh * hd]
            k = qkv[..., nh * hd: (nh + nkv) * hd]
            v = qkv[..., (nh + nkv) * hd:]
        else:
            q = self.proj["q"](x, **lin)
            k = self.proj["k"](x, **lin)
            v = self.proj["v"](x, **lin)
        q = q.reshape(b, s, nh, hd)
        k = k.reshape(b, s, nkv, hd)
        v = v.reshape(b, s, nkv, hd)
        cos, sin, rope_cos, rope_sin = step.rope(self.layer_type)

        if cache is not None and "pk" in cache:
            # a page pool: rope + pool write + attention through the page
            # table in one launch. One token per slot: K6, K7 over an int8
            # pool; a window per slot: K8, K9. q, k and v go in head-major
            # (views of the projection, no copy) and pre-rope.
            q8, decode = "sk" in cache, step.starts is None
            attend = _PAGED_ATTN[decode, q8][step.plain]
            names = ("pk", "pv", "sk", "sv") if q8 else ("pk", "pv")
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            if decode:
                qh, kh, vh = qh[:, :, 0], kh[:, :, 0], vh[:, :, 0]
            out = attend(
                qh, kh, vh, *(cache[n] for n in names), step.page_table,
                step.lengths if decode else step.starts,
                sliding_window=self.window, rope_cos=rope_cos,
                rope_sin=rope_sin)
            if not decode:
                out = out.transpose(1, 2)  # (B, W, H, hd)
            out = out.to(step.dtype).reshape(b, s, nh * hd)
        elif step.lengths is not None:
            # decode: rope + cache write + attention in one launch, K5
            # over an int8 cache and K2 otherwise
            if "ks" in cache:
                attend = (decode_attn.decode_attention_q8_plain if step.plain
                          else decode_attn.decode_attention_q8)
                caches = (cache["k"], cache["v"], cache["ks"], cache["vs"])
            else:
                attend = (decode_attn.decode_attention_plain if step.plain
                          else decode_attn.decode_attention)
                caches = (cache["k"], cache["v"])
            out = attend(
                q[:, 0], k[:, 0], v[:, 0], *caches, step.lengths,
                sliding_window=self.window, rope_cos=rope_cos,
                rope_sin=rope_sin)
            out = out.to(step.dtype).reshape(b, 1, nh * hd)
        else:
            if cos is not None:
                q = common.apply_rope_tm(q, cos, sin)
                k = common.apply_rope_tm(k, cos, sin)
            qh = q.transpose(1, 2)
            if step.starts is not None:
                # a verify window per slot over a dense cache: the JAX
                # package's XLA chain (it runs no kernel there either):
                # the rows written at each slot's own start, attention
                # under the per-slot causal mask
                common.update_kv_window(cache, k, v, step.starts)
                kh, vh = common.read_kv(cache, step.dtype, nkv)
                mask = common.window_mask(s, kh.shape[2], step.starts,
                                          self.window)
                out = common.attention(qh, common.repeat_kv(kh, nh // nkv),
                                       common.repeat_kv(vh, nh // nkv), mask)
            else:
                if cache is not None:
                    # prefill writes rows [start, start + s) (an int8 cache
                    # quantizes them at insert), then attends the cache as
                    # it holds them, the rows before start included: the
                    # history decode will read
                    with span("kv"):
                        common.write_kv_rows(cache, k, v, step.start)
                        kh, vh = common.read_kv(cache, step.dtype, nkv)
                else:
                    if k.stride() != v.stride():
                        # a roped k is a new tensor while v is still a
                        # column slice of the fused q|k|v output: K3 reads
                        # k and v through one set of strides
                        k, v = k.contiguous(), v.contiguous()
                    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
                attend = (flash_attn.flash_attention_plain if step.plain
                          else flash_attn.flash_attention)
                with span("attn"):
                    out = attend(qh, kh, vh, step.start,
                                 sliding_window=self.window,
                                 mode=step.mode)
            out = out.to(step.dtype).transpose(1, 2).reshape(b, s, nh * hd)
        return row_parallel(self.proj["o"], out, step, residual)


class MLPBlock(nn.Module):
    """``_mlp_block``: gate|up (fused or not), silu * up, down-proj with the
    residual folded in (:func:`row_parallel`)."""

    def __init__(self, proj: Dict[str, Linear]):
        super().__init__()
        self.proj = nn.ModuleDict(proj)

    def forward(self, x, step: Step, residual=None):
        lin = step.lin()
        if "gateup" in self.proj:
            gu = self.proj["gateup"](x, **lin)
            inter = gu.shape[-1] // 2
            gate, up = gu[..., :inter], gu[..., inter:]
        else:
            gate = self.proj["gate"](x, **lin)
            up = self.proj["up"](x, **lin)
        with span("act"):
            h = torch.nn.functional.silu(gate) * up
        return row_parallel(self.proj["down"], h, step, residual)


class DecoderLayer(nn.Module):
    """``_layer``: pre-norm attention and MLP blocks with residuals. ``mlp``
    replaces the dense MLP of ``linears`` (a sparse-expert block,
    ``models/moe.py``); ``layer_type`` is the attention's
    (``AttnBlock``)."""

    def __init__(self, config: LlamaConfig, linears: Dict[str, Linear],
                 input_norm: torch.Tensor, post_norm: torch.Tensor,
                 mlp: Optional[nn.Module] = None,
                 layer_type: Optional[str] = None):
        super().__init__()
        self.config = config
        attn = {n: m for n, m in linears.items()
                if n in ("q", "k", "v", "qkv", "o")}
        self.attn = AttnBlock(config, attn, layer_type)
        self.mlp = mlp if mlp is not None else MLPBlock(
            {n: m for n, m in linears.items()
             if n in ("gate", "up", "gateup", "down")})
        self.register_buffer("input_norm", input_norm)
        self.register_buffer("post_norm", post_norm)

    def forward(self, x, step: Step, cache=None):
        eps = self.config.rms_eps
        h = common.rms_norm(x, self.input_norm, eps)
        x = self.attn(h, step, cache, residual=x)
        h = common.rms_norm(x, self.post_norm, eps)
        return self.mlp(h, step, residual=x)


class LMHead(nn.Module):
    """``_lm_head``: the final linear, logits in f32; on a tensor-parallel
    shard the vocab-sharded (column-parallel) logits gathered into full
    rows (the cast to f32 first: exact, so the gather is that of the JAX
    package, which gathers before its cast)."""

    def __init__(self, linear: Linear):
        super().__init__()
        self.linear = linear

    def forward(self, x, step: Step):
        y = self.linear(x, **step.lin()).float()
        return y if step.tp is None else common.gather_vocab(y, step.tp)


class Llama(nn.Module):
    """The whole decoder: embed, layers, final norm, lm_head."""

    def __init__(self, config: LlamaConfig, embed: torch.Tensor,
                 layers: List[DecoderLayer], final_norm: torch.Tensor,
                 lm_head: Linear):
        super().__init__()
        self.config = config
        self.register_buffer("embed", embed)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("final_norm", final_norm)
        self.lm_head = LMHead(lm_head)
        # a tensor-parallel shard's place (``parallel.tp.shard_model``)
        self.tp: Optional[common.TPGroup] = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _step(self, dtype, mode, plain, *, positions=None, start=0,
              decode_pos=None, window_pos=None, cache=None) -> Step:
        """Per-call state, shared by every layer: rope cos/sin at
        ``positions`` (``start + arange(s)`` for a prefill); or for a decode
        step at ``decode_pos`` (B,) the attention kernel's operands:
        lengths and the rope rows (the rope_cos_sin values in dtype, as
        f32); or for a W-token window from ``window_pos`` (B,) the starts
        and the (B, W, hd) rope rows; each layer type's in ``Step.ropes``.
        A page pool's table is read from the first layer's cache."""
        cfg = self.config
        step = Step(dtype=dtype, mode=mode, plain=plain, tp=self.tp)
        if cache is not None and "pk" in cache[0]:
            step.page_table = cache[0]["pt"]
        decode = decode_pos is not None or window_pos is not None
        if decode:
            if window_pos is None:
                step.lengths = (decode_pos + 1).to(torch.int32)
            else:
                step.starts = window_pos[:, 0].to(torch.int32)
        else:
            step.start = start

        def rope(spec):
            if not decode:
                cos, sin = common.rope_cos_sin_spec(positions, cfg.head_dim,
                                                    spec, dtype)
                return cos, sin, None, None
            at = decode_pos if window_pos is None else window_pos
            cos, sin = common.rope_cos_sin_spec(at, cfg.head_dim, spec,
                                                dtype)
            if window_pos is not None and step.page_table is None:
                return cos, sin, None, None  # a dense window ropes itself
            return None, None, cos.float().contiguous(), \
                sin.float().contiguous()

        step.ropes = {t: rope(cfg.rope(t))
                      for t in dict.fromkeys(cfg.layer_types or (None,))}
        return step

    def _finish(self, x, step: Step):
        with span("head"):
            x = common.rms_norm(x, self.final_norm, self.config.rms_eps)
            return self.lm_head(x, step)

    def forward(self, tokens: torch.Tensor, *, dtype=torch.float32,
                mode: str = "exact", plain: bool = False,
                remat: bool = False) -> torch.Tensor:
        """Full-sequence causal forward -> logits (B, S, V) f32. remat:
        keep only each layer's input for the backward pass and recompute
        the rest (``torch.utils.checkpoint``, for Fisher gradients)."""
        s = tokens.shape[1]
        x = self.embed[tokens].to(dtype)
        step = self._step(dtype, mode, plain,
                          positions=torch.arange(s, device=self.device))
        for layer in self.layers:
            x = (checkpoint(layer, x, step, use_reentrant=False) if remat
                 else layer(x, step))
        return self._finish(x, step)

    def prefill(self, tokens: torch.Tensor, cache, *, dtype=torch.float32,
                mode: str = "exact", plain: bool = False, start=0,
                all_logits: bool = False,
                window_decode: bool = True) -> torch.Tensor:
        """Process the prompt and fill the cache (in place); returns the
        last token's logits (B, 1, V) f32, or every position's (B, S, V)
        with ``all_logits`` (a verify window: with window_decode, one of at
        most WINDOW_DECODE_ROWS rows runs its linears as a decode step,
        ``Step.lin``; False keeps the mode's kernel).

        start: position of ``tokens[:, 0]``, a python int or an int tensor
        of one element on the device (a step captured in a CUDA graph then
        serves every position). A continuation prefill (the cache already
        holds rows [0, start)) attends the cached prefix through the
        offset causal mask."""
        b, s = tokens.shape
        x = self.embed[tokens].to(dtype)
        if torch.is_tensor(start):
            start = start.reshape(()).long()
        if s == 1:
            # a one-token prompt is a decode step at position start
            pos = (start.expand(b).contiguous() if torch.is_tensor(start)
                   else torch.full((b,), start, dtype=torch.long,
                                   device=self.device))
            step = self._step(dtype, mode, plain, decode_pos=pos)
        else:
            step = self._step(
                dtype, mode, plain, start=start,
                positions=start + torch.arange(s, device=self.device))
        if all_logits and window_decode:  # a verify window (``Step.lin``)
            step.window_rows = b * s
        for layer, layer_cache in zip(self.layers, cache):
            x = layer(x, step, layer_cache)
        return self._finish(x if all_logits else x[:, -1:], step)

    def verify_window(self, tokens: torch.Tensor, pos: torch.Tensor, cache,
                      *, dtype=torch.float32, mode: str = "exact",
                      plain: bool = False,
                      window_decode: bool = True) -> torch.Tensor:
        """A speculative verify window per slot: tokens (B, W), slot b's
        window starting at its own position pos[b] (< 0: an inactive slot,
        which writes nothing). Writes the W rows, through the page table
        of a page pool (K8/K9) or at the slot's rows of a dense cache
        (``common.update_kv_window``, then plain attention as in the JAX
        package), and returns the logits of every window position
        (B, W, V) f32. window_decode: as for :meth:`prefill`."""
        w = tokens.shape[1]
        positions = pos.reshape(-1, 1) + torch.arange(w, device=self.device)
        x = self.embed[tokens].to(dtype)
        step = self._step(dtype, mode, plain, window_pos=positions,
                          cache=cache)
        if window_decode:
            step.window_rows = positions.numel()
        for layer, layer_cache in zip(self.layers, cache):
            x = layer(x, step, layer_cache)
        return self._finish(x, step)

    def decode_step(self, token: torch.Tensor, pos, cache, *,
                    dtype=torch.float32, mode: str = "exact",
                    plain: bool = False) -> torch.Tensor:
        """One decode step. token (B, 1); pos: int or (B,) tensor, the
        0-based position of this token (over a page pool -1 marks an
        inactive slot, which writes nothing). Updates the cache in place
        and returns logits (B, 1, V) f32."""
        b = token.shape[0]
        pos_t = (torch.full((b,), pos, device=self.device)
                 if isinstance(pos, int) else pos.reshape(-1))
        x = self.embed[token].to(dtype)
        step = self._step(dtype, mode, plain, decode_pos=pos_t, cache=cache)
        for layer, layer_cache in zip(self.layers, cache):
            x = layer(x, step, layer_cache)
        return self._finish(x, step)
