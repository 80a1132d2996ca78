"""OPT decoder (OPT 1.3B - 30B) in PyTorch.

The counterpart of the JAX package's ``models/opt.py`` for one device:
pre-LN layers, learned positional embeddings (HF offset +2), a ReLU MLP,
biases on all six linears, none on the lm_head. No rope, no GQA, no
sliding window: the attention block is the LLaMA one with no rope rows,
so decode runs K2 (K5 over an int8 cache) with ``rope_cos=None``, over a
page pool K6/K7 and a verify window K8/K9 likewise (over a dense cache a
verify window's plain attention), prefill and full-sequence attention K3,
and every quantized linear K1 or K4.
Unlike LLaMA, the residual is added after each block, not folded into a
linear's output init, as in the JAX package. On a tensor-parallel shard
(``parallel.tp.shard_model``) the o and down projections' partial outputs
(their biases pre-scaled by 1/tp) are all-reduced before that add, and the
lm_head gathers its vocab blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.models.common import Linear
from squeezellm_tpu_torch.models.llama import (AttnBlock, LMHead, Step,
                                               _state_dict_getter,
                                               row_parallel)
from squeezellm_tpu_torch.tracing import span

MODULE_NAMES = ("q", "k", "v", "o", "up", "down")
# each linear's name in an HF (and the reference's) state dict of a layer
HF_NAMES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
            "v": "self_attn.v_proj", "o": "self_attn.out_proj",
            "up": "fc1", "down": "fc2"}
POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding offset


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 2048
    ffn_dim: int = 8192
    n_layers: int = 24
    n_heads: int = 32
    max_seq: int = 2048
    ln_eps: float = 1e-5

    sliding_window = None  # not a field: OPT attends its whole prefix

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_heads

    @property
    def n_kv_heads(self) -> int:
        return self.n_heads

    def linear_shapes(self) -> Dict[str, Tuple[int, int]]:
        """(out, in) of each quantizable module, torch W orientation."""
        h = self.hidden_size
        return {
            "q": (h, h),
            "k": (h, h),
            "v": (h, h),
            "o": (h, h),
            "up": (self.ffn_dim, h),
            "down": (h, self.ffn_dim),
        }

    @staticmethod
    def from_hf_config(d: dict) -> "OPTConfig":
        if d.get("word_embed_proj_dim", d["hidden_size"]) != d["hidden_size"]:
            raise ValueError(
                "OPT variants with embedding projection are not supported")
        if not d.get("do_layer_norm_before", True):
            raise ValueError("post-LN OPT not supported")
        return OPTConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            ffn_dim=d["ffn_dim"],
            n_layers=d["num_hidden_layers"],
            n_heads=d["num_attention_heads"],
            max_seq=d.get("max_position_embeddings", 2048),
            ln_eps=1e-5,
        )


def from_torch_state_dict(config: OPTConfig, sd, dtype=torch.float32):
    """An HF OPTForCausalLM state dict -> the dense params tree of the JAX
    package's ``from_torch_state_dict`` (linears and layer norms as {'w',
    'b'}, 'embed_pos' beside 'embed', the lm_head tied to the embedding
    when the dict has none), tensors in ``dtype`` on the CPU."""
    g = _state_dict_getter(sd, dtype)

    def wb(prefix):
        return {"w": g(prefix + ".weight"), "b": g(prefix + ".bias")}

    layers = []
    for i in range(config.n_layers):
        p = f"model.decoder.layers.{i}."
        d = {n: wb(p + hf) for n, hf in HF_NAMES.items()}
        d["attn_norm"] = wb(p + "self_attn_layer_norm")
        d["ffn_norm"] = wb(p + "final_layer_norm")
        layers.append(d)
    embed = g("model.decoder.embed_tokens.weight")
    return {"embed": embed,
            "embed_pos": g("model.decoder.embed_positions.weight"),
            "layers": layers,
            "final_norm": wb("model.decoder.final_layer_norm"),
            "lm_head": {"w": g("lm_head.weight") if "lm_head.weight" in sd
                        else embed}}


class DecoderLayer(nn.Module):
    """``_layer``: pre-LN attention and ReLU MLP blocks with residuals.

    norms: {'attn_norm': (w, b), 'ffn_norm': (w, b)}."""

    def __init__(self, config: OPTConfig, linears: Dict[str, Linear],
                 norms: Dict[str, Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.config = config
        self.attn = AttnBlock(config, {n: m for n, m in linears.items()
                                       if n in ("q", "k", "v", "qkv", "o")})
        self.up = linears["up"]
        self.down = linears["down"]
        for name in ("attn_norm", "ffn_norm"):
            self.register_buffer(name + "_w", norms[name][0])
            self.register_buffer(name + "_b", norms[name][1])

    def forward(self, x, step: Step, cache=None):
        eps = self.config.ln_eps
        lin = step.lin()
        h = common.layer_norm(x, self.attn_norm_w, self.attn_norm_b, eps)
        x = x + self.attn(h, step, cache)
        h = common.layer_norm(x, self.ffn_norm_w, self.ffn_norm_b, eps)
        h = self.up(h, **lin)
        with span("act"):
            h = torch.relu(h)
        return x + row_parallel(self.down, h, step)


class OPT(nn.Module):
    """The whole decoder: token and position embeddings, layers, final
    layer norm, lm_head."""

    def __init__(self, config: OPTConfig, embed: torch.Tensor,
                 embed_pos: torch.Tensor, layers: List[DecoderLayer],
                 final_norm: Tuple[torch.Tensor, torch.Tensor],
                 lm_head: Linear):
        super().__init__()
        self.config = config
        self.register_buffer("embed", embed)
        self.register_buffer("embed_pos", embed_pos)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("final_norm_w", final_norm[0])
        self.register_buffer("final_norm_b", final_norm[1])
        self.lm_head = LMHead(lm_head)
        # a tensor-parallel shard's place (``parallel.tp.shard_model``)
        self.tp: Optional[common.TPGroup] = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens, positions, dtype):
        """tokens (B, S); positions (S,) or (B, S), 0-based."""
        pos = self.embed_pos[positions + POS_OFFSET].to(dtype)
        return self.embed[tokens].to(dtype) + pos

    def _finish(self, x, step: Step):
        with span("head"):
            x = common.layer_norm(x, self.final_norm_w, self.final_norm_b,
                                  self.config.ln_eps)
            return self.lm_head(x, step)

    def forward(self, tokens: torch.Tensor, *, dtype=torch.float32,
                mode: str = "exact", plain: bool = False,
                remat: bool = False) -> torch.Tensor:
        """Full-sequence causal forward -> logits (B, S, V) f32. remat:
        keep only each layer's input for the backward pass and recompute
        the rest (``torch.utils.checkpoint``, for Fisher gradients)."""
        s = tokens.shape[1]
        x = self._embed(tokens, torch.arange(s, device=self.device), dtype)
        step = Step(dtype=dtype, mode=mode, plain=plain, tp=self.tp)
        for layer in self.layers:
            x = (checkpoint(layer, x, step, use_reentrant=False) if remat
                 else layer(x, step))
        return self._finish(x, step)

    def _cache_step(self, dtype, mode, plain, cache, **fields) -> Step:
        """A step over a cache; a page pool's table is read from the first
        layer's cache."""
        step = Step(dtype=dtype, mode=mode, plain=plain, tp=self.tp, **fields)
        if "pk" in cache[0]:
            step.page_table = cache[0]["pt"]
        return step

    def prefill(self, tokens: torch.Tensor, cache, *, dtype=torch.float32,
                mode: str = "exact", plain: bool = False, start=0,
                all_logits: bool = False,
                window_decode: bool = True) -> torch.Tensor:
        """Process the prompt and fill the cache (in place); returns the
        last token's logits (B, 1, V) f32, or every position's (B, S, V)
        with ``all_logits`` (window_decode as for ``Llama.prefill``). start:
        position of ``tokens[:, 0]``, a python int or an int tensor of one
        element on the device (a continuation prefill attends the rows the
        cache already holds)."""
        b, s = tokens.shape
        if torch.is_tensor(start):
            start = start.reshape(()).long()
        x = self._embed(tokens, start + torch.arange(s, device=self.device),
                        dtype)
        step = Step(dtype=dtype, mode=mode, plain=plain, start=start,
                    tp=self.tp)
        if s == 1:
            # a one-token prompt is a decode step at position start
            step.lengths = ((start + 1).to(torch.int32).expand(b).contiguous()
                            if torch.is_tensor(start) else
                            torch.full((b,), start + 1, dtype=torch.int32,
                                       device=self.device))
        if all_logits and window_decode:  # a verify window (``Step.lin``)
            step.window_rows = b * s
        for layer, layer_cache in zip(self.layers, cache):
            x = layer(x, step, layer_cache)
        return self._finish(x if all_logits else x[:, -1:], step)

    def verify_window(self, tokens: torch.Tensor, pos: torch.Tensor, cache,
                      *, dtype=torch.float32, mode: str = "exact",
                      plain: bool = False,
                      window_decode: bool = True) -> torch.Tensor:
        """A speculative verify window per slot, over a page pool or a
        dense cache: tokens (B, W) from each slot's own position pos[b]
        (< 0: inactive, which writes nothing). Returns the logits of every
        window position (B, W, V) f32 (window_decode as for
        ``Llama.prefill``)."""
        b, w = tokens.shape
        pos = pos.reshape(-1)
        positions = pos[:, None] + torch.arange(w, device=self.device)
        x = self._embed(tokens, positions, dtype)
        step = self._cache_step(dtype, mode, plain, cache,
                                starts=pos.to(torch.int32),
                                window_rows=b * w if window_decode else 0)
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
        x = self._embed(token, pos_t[:, None], dtype)
        step = self._cache_step(dtype, mode, plain, cache,
                                lengths=(pos_t + 1).to(torch.int32))
        for layer, layer_cache in zip(self.layers, cache):
            x = layer(x, step, layer_cache)
        return self._finish(x, step)
