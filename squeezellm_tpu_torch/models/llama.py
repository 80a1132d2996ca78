"""LLaMA-family decoder (LLaMA 1/2, Vicuna, Mistral, XGen) in PyTorch.

The counterpart of the JAX package's ``models/llama.py`` for one device:
GQA, optional sliding window, a token-major KV cache (f32, bf16 or int8).
Decode attention goes through K2, or K5 over an int8 cache
(``ops/decode_attn``); prefill and full-sequence attention through K3
(``ops/flash_attn``) for every prompt length; every quantized linear
through K1 (``ops/lut_matmul``) below 1024 rows and K4
(``ops/dequant_dense``) from there. ``plain=True`` runs each kernel's
plain PyTorch version instead, whatever the device: the reference the
kernels are held against on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.models.common import Linear
from squeezellm_tpu_torch.ops import decode_attn, flash_attn


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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_heads

    def linear_shapes(self) -> Dict[str, tuple]:
        """(out, in) of each quantizable module, torch W orientation."""
        h = self.hidden_size
        kv = self.n_kv_heads * self.head_dim
        return {
            "q": (h, h),
            "k": (kv, h),
            "v": (kv, h),
            "o": (h, h),
            "gate": (self.intermediate_size, h),
            "up": (self.intermediate_size, h),
            "down": (h, self.intermediate_size),
        }

    @staticmethod
    def from_hf_config(d: dict) -> "LlamaConfig":
        """From an HF config.json dict (llama / mistral / vicuna / xgen)."""
        return LlamaConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            n_layers=d["num_hidden_layers"],
            n_heads=d["num_attention_heads"],
            n_kv_heads=d.get("num_key_value_heads") or d["num_attention_heads"],
            rope_theta=d.get("rope_theta", 10000.0),
            rms_eps=d.get("rms_norm_eps", 1e-5),
            max_seq=min(d.get("max_position_embeddings", 2048), 8192),
            sliding_window=d.get("sliding_window"),
            tie_embeddings=d.get("tie_word_embeddings", False),
        )


@dataclasses.dataclass
class Step:
    """Per-call state shared by every layer of one forward. A model
    without rope (OPT) leaves the four rope fields None."""

    dtype: torch.dtype
    mode: str
    plain: bool
    cos: Optional[torch.Tensor] = None  # (S, hd) in dtype
    sin: Optional[torch.Tensor] = None
    # decode (one token per slot, with a cache): K2/K5 operands
    lengths: Optional[torch.Tensor] = None  # (B,) int32
    rope_cos: Optional[torch.Tensor] = None  # (B, hd) f32
    rope_sin: Optional[torch.Tensor] = None


class AttnBlock(nn.Module):
    """``_attn_block``: q|k|v (fused or not), attention, o-proj with the
    residual, when one is given, folded into its output init. Shared with
    OPT, whose steps carry no rope rows."""

    def __init__(self, config, proj: Dict[str, Linear]):
        super().__init__()
        self.config = config
        self.proj = nn.ModuleDict(proj)

    def forward(self, x, step: Step, cache=None, residual=None):
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.head_dim
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        lin = dict(mode=step.mode, plain=step.plain)
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

        if step.lengths is not None:
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
                sliding_window=cfg.sliding_window, rope_cos=step.rope_cos,
                rope_sin=step.rope_sin)
            out = out.to(step.dtype).reshape(b, 1, nh * hd)
        else:
            if step.cos is not None:
                q = common.apply_rope_tm(q, step.cos, step.sin)
                k = common.apply_rope_tm(k, step.cos, step.sin)
            if cache is not None:
                # prefill writes rows [0, s) (an int8 cache quantizes them
                # at insert), then attends the cache as it holds them: the
                # history decode will read
                common.write_kv_rows(cache, k, v)
                kh, vh = common.read_kv(cache, step.dtype, nkv)
            else:
                if k.stride() != v.stride():
                    # a roped k is a new tensor while v is still a column
                    # slice of the fused q|k|v output: K3 reads k and v
                    # through one set of strides
                    k, v = k.contiguous(), v.contiguous()
                kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            attend = (flash_attn.flash_attention_plain if step.plain
                      else flash_attn.flash_attention)
            out = attend(q.transpose(1, 2), kh, vh, 0,
                         sliding_window=cfg.sliding_window)
            out = out.to(step.dtype).transpose(1, 2).reshape(b, s, nh * hd)
        return self.proj["o"](out, y0=residual, **lin)


class MLPBlock(nn.Module):
    """``_mlp_block``: gate|up (fused or not), silu * up, down-proj with the
    residual folded in."""

    def __init__(self, proj: Dict[str, Linear]):
        super().__init__()
        self.proj = nn.ModuleDict(proj)

    def forward(self, x, step: Step, residual=None):
        lin = dict(mode=step.mode, plain=step.plain)
        if "gateup" in self.proj:
            gu = self.proj["gateup"](x, **lin)
            inter = gu.shape[-1] // 2
            gate, up = gu[..., :inter], gu[..., inter:]
        else:
            gate = self.proj["gate"](x, **lin)
            up = self.proj["up"](x, **lin)
        return self.proj["down"](torch.nn.functional.silu(gate) * up,
                                 y0=residual, **lin)


class DecoderLayer(nn.Module):
    """``_layer``: pre-norm attention and MLP blocks with residuals."""

    def __init__(self, config: LlamaConfig, linears: Dict[str, Linear],
                 input_norm: torch.Tensor, post_norm: torch.Tensor):
        super().__init__()
        self.config = config
        attn = {n: m for n, m in linears.items()
                if n in ("q", "k", "v", "qkv", "o")}
        mlp = {n: m for n, m in linears.items()
               if n in ("gate", "up", "gateup", "down")}
        self.attn = AttnBlock(config, attn)
        self.mlp = MLPBlock(mlp)
        self.register_buffer("input_norm", input_norm)
        self.register_buffer("post_norm", post_norm)

    def forward(self, x, step: Step, cache=None):
        eps = self.config.rms_eps
        h = common.rms_norm(x, self.input_norm, eps)
        x = self.attn(h, step, cache, residual=x)
        h = common.rms_norm(x, self.post_norm, eps)
        return self.mlp(h, step, residual=x)


class LMHead(nn.Module):
    """``_lm_head``: the final linear, logits in f32."""

    def __init__(self, linear: Linear):
        super().__init__()
        self.linear = linear

    def forward(self, x, step: Step):
        return self.linear(x, mode=step.mode, plain=step.plain).float()


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

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _step(self, dtype, mode, plain, *, positions=None,
              decode_pos=None) -> Step:
        """Per-call state: rope cos/sin at ``positions``, or for a decode
        step at ``decode_pos`` (B,) K2's operands, shared by every layer:
        lengths and the rope rows (the rope_cos_sin values in dtype, as
        f32)."""
        cfg = self.config
        step = Step(dtype=dtype, mode=mode, plain=plain)
        if decode_pos is not None:
            cos, sin = common.rope_cos_sin(decode_pos, cfg.head_dim,
                                           cfg.rope_theta, dtype)
            step.lengths = (decode_pos + 1).to(torch.int32)
            step.rope_cos = cos.float().contiguous()
            step.rope_sin = sin.float().contiguous()
        else:
            step.cos, step.sin = common.rope_cos_sin(
                positions, cfg.head_dim, cfg.rope_theta, dtype)
        return step

    def _finish(self, x, step: Step):
        x = common.rms_norm(x, self.final_norm, self.config.rms_eps)
        return self.lm_head(x, step)

    def forward(self, tokens: torch.Tensor, *, dtype=torch.float32,
                mode: str = "exact", plain: bool = False) -> torch.Tensor:
        """Full-sequence causal forward -> logits (B, S, V) f32."""
        s = tokens.shape[1]
        x = self.embed[tokens].to(dtype)
        step = self._step(dtype, mode, plain,
                          positions=torch.arange(s, device=self.device))
        for layer in self.layers:
            x = layer(x, step)
        return self._finish(x, step)

    def prefill(self, tokens: torch.Tensor, cache, *, dtype=torch.float32,
                mode: str = "exact", plain: bool = False) -> torch.Tensor:
        """Process the prompt from position 0 and fill the cache (in
        place); returns the last token's logits (B, 1, V) f32."""
        b, s = tokens.shape
        x = self.embed[tokens].to(dtype)
        if s == 1:
            # a one-token prompt is a decode step at position 0
            step = self._step(dtype, mode, plain,
                              decode_pos=torch.zeros(b, dtype=torch.long,
                                                     device=self.device))
        else:
            step = self._step(dtype, mode, plain,
                              positions=torch.arange(s, device=self.device))
        for layer, layer_cache in zip(self.layers, cache):
            x = layer(x, step, layer_cache)
        return self._finish(x[:, -1:], step)

    def decode_step(self, token: torch.Tensor, pos, cache, *,
                    dtype=torch.float32, mode: str = "exact",
                    plain: bool = False) -> torch.Tensor:
        """One decode step. token (B, 1); pos: int or (B,) tensor, the
        0-based position of this token. Updates the cache in place and
        returns logits (B, 1, V) f32."""
        b = token.shape[0]
        pos_t = (torch.full((b,), pos, device=self.device)
                 if isinstance(pos, int) else pos.reshape(-1))
        x = self.embed[token].to(dtype)
        step = self._step(dtype, mode, plain, decode_pos=pos_t)
        for layer, layer_cache in zip(self.layers, cache):
            x = layer(x, step, layer_cache)
        return self._finish(x, step)
