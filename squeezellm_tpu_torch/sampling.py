"""On-device batched sampling for the serving decode loops.

The counterpart of the JAX package's ``sampling.py``: per-slot temperature
/ top-k / top-p sampling, vectorized over the slot batch and run on the
model's device with no host round trip per token. Greedy slots
(temperature <= 0) take the argmax through the same call.

Determinism: each draw comes from a stream that is a pure function of
(engine seed, request id, position) and of nothing else: a counter-based
integer hash gives 64 uniforms, and Gumbel-max over the masked
log-probabilities picks the token. So a request's sampled continuation does
not depend on which other requests share the batch, on its slot, or on how
decode windows are sliced. No global RNG state is read. The JAX package's
PRNG cannot be matched bit for bit; the kept set and the distribution are
the same.
"""

from __future__ import annotations

import dataclasses

import torch

# top-k/top-p operate inside the MAX_TOPK largest logits; per-slot k is a
# runtime value clamped to this bound
MAX_TOPK = 64

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (greedy by default)."""

    temperature: float = 0.0
    top_k: int = 0          # 0 = disabled (all MAX_TOPK candidates)
    top_p: float = 1.0      # 1.0 = disabled

    def __post_init__(self):
        if self.top_k > MAX_TOPK:
            raise ValueError(f"top_k > {MAX_TOPK} unsupported (static bound)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")


GREEDY = SamplingParams()


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on uint32 values held in int64 (products wrap
    in int64, which keeps their low 32 bits)."""
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _M32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def stream_uniforms(seed, rids: torch.Tensor, pos: torch.Tensor,
                    n: int = MAX_TOPK) -> torch.Tensor:
    """(B, n) f32 uniforms in (0, 1): draw j of the stream of
    (seed, rids[b], pos[b]), a pure function of those four integers. seed:
    a python int, or an int tensor of one element on the device (a step
    captured in a CUDA graph then reads it at each replay)."""
    if torch.is_tensor(seed):
        h = ((seed.reshape(()).long() ^ 0x9E3779B9) & _M32).expand(
            rids.shape[0])
    else:
        h = torch.full_like(rids, (int(seed) ^ 0x9E3779B9) & _M32,
                            dtype=torch.int64)
    h = _mix32(h)
    h = _mix32(h ^ _mix32((rids.long() + 0x7F4A7C15) & _M32))
    h = _mix32(h ^ _mix32((pos.long() + 0x94D049BB) & _M32))
    j = torch.arange(n, device=rids.device, dtype=torch.int64)
    h = _mix32(h[:, None] ^ _mix32((j + 0x2545F491) & _M32)[None, :])
    # the top 24 bits, centred in their cell: exact in f32, never 0 or 1
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def candidates(logits, temperature, top_k, top_p):
    """The MAX_TOPK largest logits of each slot as (token ids (B, K),
    log-probabilities at the slot's temperature (B, K), keep mask (B, K)):
    the candidates that survive top-k and the exclusive-cumulative top-p."""
    vals, idx = torch.topk(logits, MAX_TOPK, dim=-1)
    t = temperature.clamp_min(1e-6)[:, None]
    logp = torch.log_softmax(vals / t, dim=-1)
    probs = torch.exp(logp)
    arange = torch.arange(MAX_TOPK, device=logits.device)[None, :]
    k = torch.where(top_k > 0, top_k.clamp(max=MAX_TOPK),
                    torch.full_like(top_k, MAX_TOPK))
    keep = arange < k[:, None]
    # nucleus: keep the smallest prefix whose EXCLUSIVE cumulative mass is
    # below top_p (the first candidate always survives)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep & ((cum - probs) < top_p[:, None])
    return idx, logp, keep


def sample_tokens(logits, temperature, top_k, top_p, rids, pos, seed):
    """Draw one token per slot from (B, V) logits.

    Args:
      logits: (B, V) f32.
      temperature: (B,) f32; <= 0 means greedy for that slot.
      top_k: (B,) int; 0 disables, else keep the k largest.
      top_p: (B,) f32, nucleus mass; 1.0 disables.
      rids: (B,) int request ids (the stream's identity).
      pos: (B,) int current positions (the stream's step).
      seed: python int engine seed, or an int tensor of one element.

    Returns:
      (B,) int64 sampled token ids.
    """
    idx, logp, keep = candidates(logits.float(), temperature, top_k, top_p)
    masked = torch.where(keep, logp, torch.full_like(logp, float("-inf")))
    u = stream_uniforms(seed, rids, pos, logp.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(masked + gumbel, dim=-1, keepdim=True)
    chosen = torch.gather(idx, 1, sampled)[:, 0]
    return torch.where(temperature <= 0.0, idx[:, 0], chosen)
