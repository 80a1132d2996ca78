"""Inference engine: prefill + greedy decode with a preallocated KV cache,
plus the decode benchmark.

The counterpart of the JAX package's ``engine.py`` ``Engine`` (``new_cache``,
``generate``, ``benchmark``). Every step is enqueued on the device with no
host round trip: the greedy argmax, the position and the benchmark's nll
stay on the device, and the host waits once at the end.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from squeezellm_tpu_torch.models import common

WARMUP_STEPS = 3


class Engine:
    """Runs a Llama or OPT model.

    dtype: activation dtype; cache_dtype: KV cache dtype, or "int8" for
    int8 codes with f32 row scales (``ops/kv_quant.py``); mode: 'exact'
    (f32 LUT matmul) or 'bf16' (x and LUT rounded to bf16, f32
    accumulation: the flagship regime); plain: run each kernel's plain
    PyTorch version whatever the device (the reference the kernels are
    held against). The Engine runs the model as it is given; fusing
    q|k|v and gate|up is the loader's or caller's step
    (``models.fuse.fuse_for_decode``)."""

    def __init__(self, model, *, dtype=torch.float32,
                 cache_dtype=torch.float32, mode: str = "exact",
                 plain: bool = False):
        self.model = model
        self.config = model.config
        self.dtype = dtype
        self.cache_dtype = cache_dtype
        self.mode = mode
        self.plain = plain
        self.device = model.device

    def _run(self):
        return dict(dtype=self.dtype, mode=self.mode, plain=self.plain)

    def new_cache(self, batch: int = 1, max_seq: Optional[int] = None):
        c = self.config
        # the token axis rounds up to 16 rows (128 for int8), so that cache
        # shapes match the JAX package's; the kernels take any row count
        align = 128 if common.is_int8(self.cache_dtype) else 16
        s = -(-(max_seq or c.max_seq) // align) * align
        return common.init_kv_cache(batch, s, c.n_layers, c.n_kv_heads,
                                    c.head_dim, self.cache_dtype,
                                    self.device)

    @torch.no_grad()
    def generate(self, prompt_tokens, max_new_tokens: int,
                 temperature: float = 0.0) -> np.ndarray:
        """Greedy generation. prompt_tokens: (B, S) ints. Returns
        (B, S + max_new_tokens) int64."""
        if temperature > 0.0:
            raise NotImplementedError(
                "sampling (temperature > 0) comes with the sampling slice "
                "of the port; this engine decodes greedily")
        prompt = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.long,
                                 device=self.device)
        b, s = prompt.shape
        cache = self.new_cache(b)
        logits = self.model.prefill(prompt, cache, **self._run())
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out = [prompt, tok]
        pos = torch.full((b,), s, dtype=torch.long, device=self.device)
        for _ in range(max_new_tokens - 1):
            logits = self.model.decode_step(tok, pos, cache, **self._run())
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
            pos = pos + 1
        return torch.cat(out[: 1 + max_new_tokens], dim=1).cpu().numpy()

    @torch.no_grad()
    def teacher_forced_logits(self, input_ids,
                              max_seq: Optional[int] = None) -> torch.Tensor:
        """Feed (1, T) tokens one decode step at a time from an empty cache;
        returns the (T, V) f32 logits of every step."""
        ids = torch.as_tensor(np.asarray(input_ids).reshape(1, -1),
                              dtype=torch.long, device=self.device)
        cache = self.new_cache(1, max_seq)
        rows = []
        pos = torch.zeros(1, dtype=torch.long, device=self.device)
        for i in range(ids.shape[1]):
            rows.append(self.model.decode_step(ids[:, i: i + 1], pos, cache,
                                               **self._run())[0, -1])
            pos = pos + 1
        return torch.stack(rows)

    @torch.no_grad()
    def benchmark(self, input_ids, max_seq: Optional[int] = None,
                  check: bool = False) -> Dict[str, Any]:
        """Decode benchmark with the JAX package's protocol: 3 warmup
        steps, then token 0 seeds the loop, every token is one decode step
        from an empty cache, the whole run ends in one fence; median
        per-token latency. check: also accumulate the next-token
        perplexity of the fed sequence (``check_ppl``) inside the timed
        loop, as the JAX package does with ``check=True``; without it the
        loop runs the decode steps alone."""
        ids = torch.as_tensor(np.asarray(input_ids).reshape(1, -1),
                              dtype=torch.long, device=self.device)
        T = ids.shape[1]
        on_cuda = self.device.type == "cuda"

        def fence():
            if on_cuda:
                torch.cuda.synchronize(self.device)

        cache = self.new_cache(1, max_seq)
        pos0 = torch.zeros(1, dtype=torch.long, device=self.device)
        for _ in range(1 + WARMUP_STEPS):  # first call, then warmup
            self.model.decode_step(ids[:, :1], pos0, cache, **self._run())
        fence()
        cache = self.new_cache(1, max_seq)
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        fence()

        nll = torch.zeros((), dtype=torch.float32, device=self.device)
        pos = pos0
        tick = time.perf_counter()
        for i in range(T):
            logits = self.model.decode_step(ids[:, i: i + 1], pos, cache,
                                            **self._run())
            if check and i < T - 1:
                logp = torch.log_softmax(logits[0, -1].float(), dim=-1)
                nll = nll - logp.gather(0, ids[0, i + 1: i + 2])[0]
            pos = pos + 1
        fence()
        elapsed = time.perf_counter() - tick
        med = elapsed / T  # one window: its per-token time is the median
        stats: Dict[str, Any] = {
            "tokens": T,
            "median_latency_s": med,
            "tokens_per_s": 1.0 / med,
            "device": (torch.cuda.get_device_name(self.device) if on_cuda
                       else "cpu"),
        }
        if check:
            stats["check_ppl"] = float(torch.exp(nll / (T - 1)))
        if on_cuda:
            stats["peak_memory_mib"] = (
                torch.cuda.max_memory_allocated(self.device) / 2**20)
        pbytes = self.param_bytes()
        stats["param_bytes"] = pbytes
        stats["achieved_gb_s"] = pbytes / med / 1e9
        return stats

    def param_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in self.model.buffers()))
