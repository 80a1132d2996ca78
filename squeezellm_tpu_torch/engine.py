"""Inference engine: prefill + decode with a preallocated KV cache, sampled
generation, prompt-lookup and draft-model speculation, and the decode
benchmark.

The counterpart of the JAX package's ``engine.py`` (``Engine``,
``truncate_for_draft``, ``_lookup_draft``). Where the JAX package runs a
jitted step with a donated cache, the engine runs a step program
(``graphs.StepGraph``): the step's body over persistent buffers, captured
once as a CUDA graph and replayed, the cache updated in place. An engine
keeps one cache with its buffers and graphs, for one key (the call's
batch, cache rows and mode), and replaces them when a call needs another
key; rows an earlier call left in the cache lie beyond every position the
next call attends, as a rejected draft's rows do. Prefill stays eager: its
shape follows the prompt. Within a call the token select, the position
advance and every speculative window's bookkeeping stay on the device, and
the host waits once at the end (a few times for speculation, see
:meth:`Engine.generate_speculative`).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from squeezellm_tpu_torch import graphs, sampling, serving
from squeezellm_tpu_torch.graphs import check_capturable
from squeezellm_tpu_torch.models import common

WARMUP_STEPS = 3
# peak device memory rate, GB/s, by the name torch.cuda.get_device_name
# gives (NVIDIA's data sheet, SXM part)
HBM_GB_S = {"NVIDIA H100 80GB HBM3": 3350.0}


def _select(logits, st, sampled: bool) -> torch.Tensor:
    """The next token of every row from (B, V) logits: the argmax, or a
    draw of the stream of (seed, row, position) from the step's sampler
    buffers (``_select`` of the JAX package)."""
    if not sampled:
        return torch.argmax(logits, dim=-1)
    return sampling.sample_tokens(logits.float(), st.temp, st.topk, st.topp,
                                  st.rows, st.pos, st.seed)


def _accept(st, draft, logits) -> None:
    """Greedy-exact acceptance of one verify window (``_spec_loop``'s
    body), by the paged engine's ``_accept_drafts`` on a batch of one: the
    emitted run (the accepted drafts and the bonus token) into ``ctx``
    after ``pos`` and into ``out`` at ``out_n``, both advanced by ``m =
    min(n_acc + 1, max_new - out_n)``; a window that starts with every
    token emitted advances nothing and is not counted."""
    emit, n_acc, _, _ = serving._accept_drafts(logits, draft, st.ctx,
                                               st.pos)
    live = st.out_n < st.max_new
    m = torch.minimum(n_acc + 1, st.max_new - st.out_n)
    ar = torch.arange(emit.shape[1], device=emit.device)
    st.out.index_copy_(1, st.out_n + ar, emit)
    st.pos.add_(m)
    st.out_n.add_(m)
    st.wins.add_(live.long())
    st.acc.add_(torch.where(live, n_acc, torch.zeros_like(n_acc)))


class Engine:
    """Runs a Llama or OPT model.

    dtype: activation dtype; cache_dtype: KV cache dtype, or "int8" for
    int8 codes with f32 row scales (``ops/kv_quant.py``); mode: 'exact'
    (f32 LUT matmul) or 'bf16' (x and LUT rounded to bf16, f32
    accumulation: the flagship regime); plain: run each kernel's plain
    PyTorch version whatever the device (the reference the kernels are
    held against), always eagerly; graphs: capture every per-token step
    program as a CUDA graph on a CUDA device (False runs the same steps
    eagerly: the comparison of the two in one process); window_decode: a
    speculative verify window of at most ``WINDOW_DECODE_ROWS`` rows runs
    its linears through K1/K10's decode kernel, as a decode step (False:
    the mode's kernel, the prefill tensor cores in bf16 mode). The Engine
    runs the model as it is given; fusing q|k|v and gate|up is the
    loader's or caller's step (``models.fuse.fuse_for_decode``). A
    tensor-parallel shard (``parallel.tp.shard_model``) runs too, every
    rank making the same calls, its cache over the rank's kv heads; its
    steps are captured only over NCCL (``graphs.check_capturable``)."""

    def __init__(self, model, *, dtype=torch.float32,
                 cache_dtype=torch.float32, mode: str = "exact",
                 plain: bool = False, graphs: bool = True,
                 window_decode: bool = True):
        self.model = model
        self.config = model.config
        self.dtype = dtype
        self.cache_dtype = cache_dtype
        self.mode = mode
        self.plain = plain
        self.graphs = graphs
        self.window_decode = window_decode
        self.device = model.device
        if graphs and not plain:
            check_capturable(model)
        self.spec_stats: Dict[str, int] = {}
        self._state = None  # (key, buffers, step programs)

    def _run(self):
        return dict(dtype=self.dtype, mode=self.mode, plain=self.plain)

    def _verify(self):
        """The keyword arguments of a verify window's ``prefill``."""
        return dict(self._run(), all_logits=True,
                    window_decode=self.window_decode)

    def _rows(self, max_seq: Optional[int]) -> int:
        """Cache rows for max_seq: the token axis rounds up to 16 rows (128
        for int8), so that cache shapes match the JAX package's; the
        kernels take any row count."""
        align = 128 if common.is_int8(self.cache_dtype) else 16
        return -(-(max_seq or self.config.max_seq) // align) * align

    def new_cache(self, batch: int = 1, max_seq: Optional[int] = None):
        c = self.config
        return common.init_kv_cache(batch, self._rows(max_seq), c.n_layers,
                                    common.kv_heads(self.model), c.head_dim,
                                    self.cache_dtype, self.device)

    def release(self) -> None:
        """Drop the persistent cache, buffers and graphs."""
        self._state = None

    def _persistent(self, key, make):
        """The buffers and step programs of `key`, made from ``make()``
        (-> (buffers, {name: body})) when the engine holds another key's,
        which are dropped first."""
        if self._state is not None and self._state[0] == key:
            return self._state[1], self._state[2]
        self._state = None
        capture = self.graphs and not self.plain
        pool = (torch.cuda.graph_pool_handle()
                if capture and self.device.type == "cuda" else None)
        st, bodies = make()
        steps = {name: graphs.StepGraph(body, self.device, capture=capture,
                                        pool=pool)
                 for name, body in bodies.items()}
        self._state = (key, st, steps)
        return st, steps

    def _tensor(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.array(tokens, dtype=np.int64),
                               device=self.device)

    # ------------------------------------------------------------------
    # generate
    # ------------------------------------------------------------------

    def _gen_state(self, b: int, rows: int, sampled: bool):
        dev = self.device
        st = SimpleNamespace(
            cache=self.new_cache(b, rows),
            tok=torch.zeros((b, 1), dtype=torch.long, device=dev),
            pos=torch.zeros(b, dtype=torch.long, device=dev),
            out=torch.zeros((b, rows), dtype=torch.long, device=dev),
            rows=torch.arange(b, device=dev),
            temp=torch.zeros(b, dtype=torch.float32, device=dev),
            topk=torch.zeros(b, dtype=torch.long, device=dev),
            topp=torch.ones(b, dtype=torch.float32, device=dev),
            seed=torch.zeros(1, dtype=torch.long, device=dev))
        model, kw = self.model, self._run()

        def step():
            """``_gen_step``: decode, select, the token into ``out`` at its
            position, the position advance."""
            logits = model.decode_step(st.tok, st.pos, st.cache, **kw)
            nxt = _select(logits[:, -1], st, sampled)
            st.tok.copy_(nxt[:, None])
            st.out.scatter_(1, (st.pos + 1)[:, None], nxt[:, None])
            st.pos.add_(1)

        return st, {"step": step}

    @torch.no_grad()
    def generate(self, prompt_tokens, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 max_seq: Optional[int] = None, top_k: int = 0,
                 top_p: float = 1.0) -> np.ndarray:
        """Greedy (temperature 0) or sampled (temperature / top-k / top-p)
        generation through the on-device sampler (``sampling``: the stream
        of (seed, row, position)). prompt_tokens: (B, S) ints. Returns
        (B, S + max_new_tokens) int64.

        The prefill is eager; then one step program a token (decode,
        select, advance), greedy and sampled being two programs, and one
        host sync at the end."""
        sampled = temperature > 0.0
        if sampled:  # refuses what the sampler cannot honour
            sampling.SamplingParams(temperature=temperature, top_k=top_k,
                                    top_p=top_p)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = self._tensor(prompt_tokens)
        b, s = prompt.shape
        rows = self._rows(max_seq)
        if s + max_new_tokens > rows:
            raise ValueError(f"prompt ({s}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds the cache's "
                             f"{rows} rows")
        st, steps = self._persistent(
            ("generate", b, rows, sampled),
            lambda: self._gen_state(b, rows, sampled))
        logits = self.model.prefill(prompt, st.cache, **self._run())
        st.pos.fill_(s)
        if sampled:
            st.temp.fill_(temperature)
            st.topk.fill_(top_k)
            st.topp.fill_(top_p)
            st.seed.fill_(seed)
        first = _select(logits[:, -1], st, sampled)
        st.tok.copy_(first[:, None])
        st.out[:, :s] = prompt
        st.out[:, s] = first
        for _ in range(max_new_tokens - 1):
            steps["step"]()
        # a copy: the buffer is the next call's
        return st.out[:, : s + max_new_tokens].cpu().numpy().copy()

    # ------------------------------------------------------------------
    # prompt-lookup speculation
    # ------------------------------------------------------------------

    def _check_spec(self, prompt, max_new_tokens, draft_len, max_seq):
        b, s = prompt.shape
        if b != 1:
            raise ValueError("the speculative path is single-stream")
        if max_new_tokens < 1 or draft_len < 1:
            raise ValueError("max_new_tokens and draft_len must be >= 1")
        cache_len = max_seq or self.config.max_seq
        # verification windows must never write past the cache end
        if s + max_new_tokens + draft_len + 1 > cache_len:
            raise ValueError("prompt + max_new + draft_len + 1 must fit in "
                             "max_seq")
        return s, cache_len

    def _spec_buffers(self, rows: int, K: int) -> SimpleNamespace:
        """A speculative loop's device state: the token context and the
        output (``ctx``, ``out``), the position of the last emitted token,
        the tokens emitted, the budget, the windows and accepted drafts
        counted."""
        st = SimpleNamespace(**{
            n: torch.zeros(1, dtype=torch.long, device=self.device)
            for n in ("pos", "out_n", "max_new", "wins", "acc")})
        st.ctx = torch.zeros((1, rows), dtype=torch.long, device=self.device)
        st.out = torch.zeros((1, rows + K + 1), dtype=torch.long,
                             device=self.device)
        return st

    def _spec_start(self, st, prompt, first, max_new_tokens) -> None:
        s = prompt.shape[1]
        st.ctx.zero_()
        st.ctx[:, :s] = prompt
        st.ctx[0, s] = first
        st.out.zero_()
        st.out[0, 0] = first
        st.pos.fill_(s)
        st.out_n.fill_(1)
        st.max_new.fill_(max_new_tokens)
        st.wins.zero_()
        st.acc.zero_()

    def _spec_run(self, window, st, prompt, max_new_tokens: int,
                  K: int) -> np.ndarray:
        """Replay `window` until every token is emitted: a live window
        emits 1 to K + 1 tokens, so at least ceil(left / (K + 1)) windows
        remain, and those replay between two reads of ``out_n``."""
        done = 1
        while done < max_new_tokens:
            for _ in range(-(-(max_new_tokens - done) // (K + 1))):
                window()
            done = int(st.out_n)
        wins = int(st.wins)
        self.spec_stats = {"windows": wins, "drafted": wins * K,
                           "accepted": int(st.acc)}
        out = st.out[0, :max_new_tokens].cpu().numpy()
        return np.concatenate([prompt.cpu().numpy()[0], out])[None]

    def _lookup_state(self, rows: int, K: int, ngram: int):
        st = self._spec_buffers(rows, K)
        st.cache = self.new_cache(1, rows)
        model, kw = self.model, self._verify()

        def window():
            """One window of ``_spec_loop``: the n-gram draft from ctx, the
            (K + 1)-token verify at the device position, acceptance."""
            draft = serving._prompt_lookup_draft(st.ctx, st.pos, K, ngram)
            cur = st.ctx.gather(1, st.pos[:, None])
            logits = model.prefill(torch.cat([cur, draft], dim=1), st.cache,
                                   start=st.pos, **kw)
            _accept(st, draft, logits)

        return st, {"window": window}

    @torch.no_grad()
    def generate_speculative(self, prompt_tokens, max_new_tokens: int,
                             draft_len: int = 8, ngram: int = 2,
                             max_seq: Optional[int] = None,
                             host_loop: bool = False) -> np.ndarray:
        """Greedy generation accelerated by prompt-lookup speculation: each
        window drafts up to `draft_len` tokens from the latest earlier
        occurrence of the last `ngram` tokens and verifies them in one
        (draft_len + 1)-token forward; the tokens are those of greedy
        :meth:`generate`. Stats of the last call in ``self.spec_stats``
        (windows, drafted, accepted).

        By default one step program is one window of the JAX package's
        ``_spec_loop`` (draft, verify with K3 at a device offset,
        acceptance, bookkeeping), replayed in batches between reads of the
        tokens emitted: a few host syncs a call. host_loop=True runs the
        readable reference loop eagerly (the same tokens; ``drafted``
        counts the drafts' real lengths, as the JAX host loop does).

        prompt_tokens: (1, S). Returns (1, S + max_new_tokens) int64."""
        prompt = self._tensor(prompt_tokens)
        s, cache_len = self._check_spec(prompt, max_new_tokens, draft_len,
                                        max_seq)
        kw = self._run()
        if host_loop:
            cache = self.new_cache(1, cache_len)
            logits = self.model.prefill(prompt, cache, **kw)
            ctx = prompt[0].tolist()
            tok = int(torch.argmax(logits[0, -1]))
            out = [tok]
            ctx.append(tok)
            pos = s  # position of the next token to be fed/written
            self.spec_stats = {"windows": 0, "drafted": 0, "accepted": 0}
            while len(out) < max_new_tokens:
                draft = _lookup_draft(ctx, ngram, draft_len)
                window = np.zeros((1, draft_len + 1), np.int64)
                window[0, 0] = tok
                window[0, 1: 1 + len(draft)] = draft
                logits = self.model.prefill(self._tensor(window), cache,
                                            start=pos, **self._verify())
                greedy = torch.argmax(logits[0], dim=-1).tolist()
                n_acc = 0
                while n_acc < len(draft) and draft[n_acc] == greedy[n_acc]:
                    n_acc += 1
                emitted = draft[:n_acc] + [greedy[n_acc]]
                emitted = emitted[: max_new_tokens - len(out)]
                out.extend(emitted)
                ctx.extend(emitted)
                pos += len(emitted)
                tok = emitted[-1]
                self.spec_stats["windows"] += 1
                self.spec_stats["drafted"] += len(draft)
                self.spec_stats["accepted"] += n_acc
            return np.asarray([ctx[: s + max_new_tokens]], np.int64)
        rows = self._rows(cache_len)
        st, steps = self._persistent(
            ("lookup", rows, draft_len, ngram),
            lambda: self._lookup_state(rows, draft_len, ngram))
        logits = self.model.prefill(prompt, st.cache, **kw)
        self._spec_start(st, prompt, torch.argmax(logits[0, -1]),
                         max_new_tokens)
        return self._spec_run(steps["window"], st, prompt, max_new_tokens,
                              draft_len)

    # ------------------------------------------------------------------
    # draft-model speculation
    # ------------------------------------------------------------------

    def _draft_state(self, draft: "Engine", rows: int, K: int):
        st = self._spec_buffers(rows, K)
        st.cache = self.new_cache(1, rows)
        st.dcache = draft.new_cache(1, rows)
        tmodel, tkw = self.model, self._verify()
        dmodel, dkw = draft.model, draft._run()

        def window():
            """One window of ``_build_draft_loop``'s body: K greedy decode
            steps of the draft from ctx[pos] at row pos on, the target's
            verify of the (K + 1)-token window at pos, acceptance."""
            cur = st.ctx.gather(1, st.pos[:, None])
            tok, p, toks = cur, st.pos, []
            for _ in range(K):
                lg = dmodel.decode_step(tok, p, st.dcache, **dkw)
                tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
                toks.append(tok)
                p = p + 1
            draft_toks = torch.cat(toks, dim=1)
            logits = tmodel.prefill(torch.cat([cur, draft_toks], dim=1),
                                    st.cache, start=st.pos, **tkw)
            _accept(st, draft_toks, logits)

        return st, {"window": window}

    @torch.no_grad()
    def generate_draft_speculative(self, prompt_tokens, max_new_tokens: int,
                                   draft: "Engine", draft_len: int = 8,
                                   max_seq: Optional[int] = None,
                                   host_loop: bool = False) -> np.ndarray:
        """Greedy generation accelerated by a draft model: `draft` (an
        Engine over a model of the same vocabulary, e.g.
        :func:`truncate_for_draft` of this one) proposes `draft_len` tokens
        by greedy decode steps, this engine verifies the window in one
        forward; the tokens are those of greedy :meth:`generate`. Stats in
        ``self.spec_stats`` (windows, drafted, accepted).

        By default one step program is one window (the draft's K decode
        steps on its own persistent cache, the verify, the acceptance),
        replayed as :meth:`generate_speculative` replays its windows;
        host_loop=True runs the reference loop eagerly.

        prompt_tokens: (1, S). Returns (1, S + max_new_tokens) int64."""
        prompt = self._tensor(prompt_tokens)
        if self.config.vocab_size != draft.config.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        s, cache_len = self._check_spec(prompt, max_new_tokens, draft_len,
                                        max_seq)
        kw, dkw = self._run(), draft._run()
        if host_loop:
            tcache = self.new_cache(1, cache_len)
            dcache = draft.new_cache(1, cache_len)
            logits = self.model.prefill(prompt, tcache, **kw)
            draft.model.prefill(prompt, dcache, **dkw)
            tok = int(torch.argmax(logits[0, -1]))
            out = [tok]
            pos = s
            self.spec_stats = {"windows": 0, "drafted": 0, "accepted": 0}
            while len(out) < max_new_tokens:
                cur, draft_toks, p = tok, [], pos
                dtok = self._tensor([[cur]])
                for _ in range(draft_len):
                    lg = draft.model.decode_step(dtok, p, dcache, **dkw)
                    nxt = int(torch.argmax(lg[0, -1]))
                    draft_toks.append(nxt)
                    dtok = self._tensor([[nxt]])
                    p += 1
                logits = self.model.prefill(
                    self._tensor([[cur] + draft_toks]), tcache, start=pos,
                    **self._verify())
                greedy = torch.argmax(logits[0], dim=-1).tolist()
                n_acc = 0
                while (n_acc < draft_len
                       and draft_toks[n_acc] == greedy[n_acc]):
                    n_acc += 1
                emitted = draft_toks[:n_acc] + [greedy[n_acc]]
                emitted = emitted[: max_new_tokens - len(out)]
                out.extend(emitted)
                pos += len(emitted)
                tok = emitted[-1]
                self.spec_stats["windows"] += 1
                self.spec_stats["drafted"] += draft_len
                self.spec_stats["accepted"] += n_acc
            return np.concatenate([prompt.cpu().numpy()[0],
                                   np.asarray(out, np.int64)])[None]
        rows = self._rows(cache_len)
        st, steps = self._persistent(
            ("draft", id(draft), rows, draft_len),
            lambda: self._draft_state(draft, rows, draft_len))
        logits = self.model.prefill(prompt, st.cache, **kw)
        draft.model.prefill(prompt, st.dcache, **dkw)
        self._spec_start(st, prompt, torch.argmax(logits[0, -1]),
                         max_new_tokens)
        return self._spec_run(steps["window"], st, prompt, max_new_tokens,
                              draft_len)

    # ------------------------------------------------------------------
    # measurement
    # ------------------------------------------------------------------

    @torch.no_grad()
    def teacher_forced_logits(self, input_ids,
                              max_seq: Optional[int] = None) -> torch.Tensor:
        """Feed (1, T) tokens one decode step at a time from an empty cache;
        returns the (T, V) f32 logits of every step (eager)."""
        ids = self._tensor(np.asarray(input_ids).reshape(1, -1))
        cache = self.new_cache(1, max_seq)
        rows = []
        pos = torch.zeros(1, dtype=torch.long, device=self.device)
        for i in range(ids.shape[1]):
            rows.append(self.model.decode_step(ids[:, i: i + 1], pos, cache,
                                               **self._run())[0, -1])
            pos = pos + 1
        return torch.stack(rows)

    def _bench_state(self, T: int, rows: int, check: bool):
        st = SimpleNamespace(
            cache=self.new_cache(1, rows),
            ids=torch.zeros((1, T), dtype=torch.long, device=self.device),
            pos=torch.zeros(1, dtype=torch.long, device=self.device),
            nll=torch.zeros((), dtype=torch.float32, device=self.device))
        model, kw = self.model, self._run()

        def step():
            """``_bench_step``: the token at pos from the device ids, one
            decode step, the optional next-token nll, the advance."""
            logits = model.decode_step(st.ids.gather(1, st.pos[:, None]),
                                       st.pos, st.cache, **kw)
            if check:
                at = (st.pos + 1).clamp(max=T - 1)
                nxt = st.ids.gather(1, at[:, None])
                logp = torch.log_softmax(logits[0, -1].float(), dim=-1)
                part = logp.gather(0, nxt[0])[0]
                st.nll.sub_(torch.where(st.pos[0] < T - 1, part,
                                        torch.zeros_like(part)))
            st.pos.add_(1)

        return st, {"step": step}

    def bench_program(self, input_ids, max_seq: Optional[int] = None,
                      check: bool = False):
        """The benchmark's step program over its persistent buffers, the
        ids (1, T) copied in: (buffers, step). ``buffers.pos`` is the
        position that the next call of ``step`` decodes (the token
        ``ids[pos]``); ``buffers.cache`` the cache. For measurement: a
        caller may set ``pos`` and time or trace the calls."""
        ids = np.asarray(input_ids).reshape(1, -1)
        T = ids.shape[1]
        rows = self._rows(max_seq)
        st, steps = self._persistent(
            ("benchmark", T, rows, check),
            lambda: self._bench_state(T, rows, check))
        st.ids.copy_(self._tensor(ids))
        return st, steps["step"]

    @torch.no_grad()
    def benchmark(self, input_ids, max_seq: Optional[int] = None,
                  check: bool = False, warmup: int = WARMUP_STEPS,
                  window: Optional[int] = None) -> Dict[str, Any]:
        """Decode benchmark with the JAX package's protocol: the ids live
        on the device, one step program a token (``_bench_step``) from an
        empty cache; the first call and `warmup` more at position 0, then
        the cache is emptied; host-clock windows of `window` steps (one,
        the whole run, by default), each ended by one fence; median, mean
        and worst per-token latency of the windows. check: also accumulate
        the fed sequence's next-token perplexity (``check_ppl``) inside
        the timed loop; without it the loop runs the decode steps alone."""
        ids = np.asarray(input_ids).reshape(1, -1)
        T = ids.shape[1]
        window = window or T
        on_cuda = self.device.type == "cuda"

        def fence():
            if on_cuda:
                torch.cuda.synchronize(self.device)

        st, step = self.bench_program(ids, max_seq, check)
        for _ in range(1 + warmup):  # first call (the capture), warmup
            st.pos.zero_()
            step()
        fence()
        for layer in st.cache:  # the cache emptied in place
            for t in layer.values():
                t.zero_()
        st.pos.zero_()
        st.nll.zero_()
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        fence()

        window_times: List[float] = []
        done = 0
        tick = time.perf_counter()
        for i in range(T):
            step()
            if (i + 1) % window == 0 or i == T - 1:
                fence()  # the host waits: the window ends
                now = time.perf_counter()
                window_times.append((now - tick) / (i + 1 - done))
                done = i + 1
                tick = now
        med = float(np.median(window_times))
        name = torch.cuda.get_device_name(self.device) if on_cuda else "cpu"
        stats: Dict[str, Any] = {
            "tokens": T,
            "median_latency_s": med,
            "mean_latency_s": float(np.mean(window_times)),
            "max_window_latency_s": float(np.max(window_times)),
            "tokens_per_s": 1.0 / med,
            "device": name,
            "graphs": step.capture,
        }
        if check:
            stats["check_ppl"] = float(torch.exp(st.nll / (T - 1)))
        if on_cuda:
            stats["peak_memory_mib"] = (
                torch.cuda.max_memory_allocated(self.device) / 2**20)
        pbytes = self.param_bytes()
        stats["param_bytes"] = pbytes
        stats["achieved_gb_s"] = pbytes / med / 1e9
        hbm = HBM_GB_S.get(name)
        if hbm:
            stats["hbm_roofline_util"] = round(pbytes / med / 1e9 / hbm, 4)
        return stats

    def param_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in self.model.buffers()))


def truncate_for_draft(model: nn.Module, n_layers: int) -> nn.Module:
    """Early-exit draft: a model of the first ``n_layers`` decoder layers
    of `model` with its embedding, final norm and lm_head, every tensor
    SHARED with it (no weight memory of its own; an engine over it only
    adds its KV cache). The draft of :meth:`Engine.
    generate_draft_speculative` without a second checkpoint."""
    L = model.config.n_layers
    if not 0 < n_layers <= L:
        raise ValueError(
            f"draft layer count must be in [1, {L}] (model has {L} "
            f"layers), got {n_layers}")
    draft = copy.copy(model)
    draft._modules = dict(model._modules)
    draft._buffers = dict(model._buffers)
    draft._parameters = dict(model._parameters)
    draft.layers = nn.ModuleList(list(model.layers)[:n_layers])
    draft.config = dataclasses.replace(model.config, n_layers=n_layers)
    return draft


def _lookup_draft(ctx, ngram: int, k: int) -> List[int]:
    """Prompt-lookup draft: continuation of the most recent PRIOR
    occurrence of the last `ngram` tokens (vectorized window match)."""
    n = len(ctx)
    if k < 1 or n < ngram + 1:
        return []
    a = np.asarray(ctx, np.int64)
    key = a[n - ngram:]
    # windows a[i:i+ngram] for i in [0, n-ngram-1) — exclude the key itself
    if n - ngram < 1:
        return []
    win = np.lib.stride_tricks.sliding_window_view(a[: n - 1], ngram)
    hits = np.nonzero((win == key).all(axis=1))[0]
    if len(hits) == 0:
        return []
    i = int(hits[-1])  # most recent prior occurrence
    return [int(t) for t in a[i + ngram: i + ngram + k]]
