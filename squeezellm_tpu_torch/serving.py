"""Continuous-batching serving loops: dense slots and a paged pool.

The counterparts of the JAX package's ``serving.py``
``ContinuousBatchEngine`` and ``PagedContinuousBatchEngine``: a fixed pool
of decode slots stepped by one batched decode per token, with requests
joining (a prefill, whose rows then move into the slot's cache) and leaving
independently; per-request sampling; prompt-lookup speculation verified in
one slot-batched window; cohort admission (one batched prefill for prompts
of one length); chunked admission (``prefill_chunk`` tokens of a long
prompt per engine step, interleaved with decode).

* :class:`ContinuousBatchEngine` keeps one dense token-major cache row
  block per slot, f32, bf16 or int8. Decode attention runs K2 (K5 over an
  int8 cache) with per-slot lengths, an admission prefill K3; a
  speculative verify window writes its rows with
  ``common.update_kv_window`` and attends in plain PyTorch, as the JAX
  package does (it runs no Pallas kernel there either).
* :class:`PagedContinuousBatchEngine` keeps a shared KV page pool (a
  prefill on a dense temporary cache, scattered into the slot's pages);
  prompts that share full-page prefixes reuse the pages and skip
  recomputing them. Decode attention runs K6/K7, a speculative verify
  window K8/K9 (``ops/paged_attn``), the admission prefill K3.
* :class:`TPContinuousBatchEngine` and :class:`TPPagedContinuousBatchEngine`
  are the two over one rank's tensor-parallel shards
  (``parallel.tp.shard_model``), run SPMD: every rank of the group makes
  the same calls, its cache or pool over its n_kv_heads / tp heads. They
  differ from the single-device engines only in the model they are given
  and the kv heads they size for; the collectives live in the model.

Caches are updated in place. The per-token decode step (greedy and sampled
are two programs) and the speculative window are step programs
(``graphs.StepGraph``): captured once as CUDA graphs over persistent device
buffers and replayed, the counterparts of the JAX engines' jitted decode
and spec-window steps. The positions, the current tokens, the four sampler
arrays (and the paged engine's page table) live in those buffers; the host
keeps its own copies and uploads one only when admission, release or
``_collect`` changed it in a way the device did not. A decode window
replays its step k times and waits for the host once, for the window's
tokens; a speculative window waits once. Admission stays eager: its
prefill is shaped by the prompt. What both engines share (slot
bookkeeping, sampler state, the step programs, the windows, ``run``) is
:class:`_SlotEngine`.

An inactive slot carries position -1: its kernels' length is 0, so it
writes nothing and reads nothing (K2/K5/K6/K7), and a verify window writes
none of its rows. The JAX dense engine instead decodes garbage in inactive
slots and never emits it; the tokens come out the same either way. Over a
page pool a stale position would write through the freed page table into
pages that may already belong to another slot, so there it is required.

What the JAX engines do only to keep XLA from recompiling is not carried
over, since eager PyTorch has no trace to protect: the 16-token bucket
padding of a prompt (or of its suffix), and the power-of-two padding of
page-id lists, of a cohort and of a decode window's length. Rows of a
prompt's last page beyond its length therefore hold zeros here (the JAX
pool holds the padding tokens' k/v there); they are masked until decode
overwrites them. A prompt prefills into a staging cache of its own length
(the paged engine's: its pages), not ``max_seq``. A cohort's single
batched prefill of same-length prompts stays: the weights stream once.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from squeezellm_tpu_torch import graphs as graphs_mod
from squeezellm_tpu_torch import sampling as sampling_mod
from squeezellm_tpu_torch.models import common
from squeezellm_tpu_torch.ops import kv_quant, paged_attn
from squeezellm_tpu_torch.sampling import SamplingParams


@dataclasses.dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    pos: int = 0  # position of the NEXT token to be written
    max_new: int = 0
    generated: int = 0
    tokens: Optional[List[int]] = None
    stop: Tuple[int, ...] = ()  # stop-token ids (host-side truncation)
    # chunked prefill in flight: the slot occupies the pool but is not
    # decoding yet; step() advances its staging prefill one chunk at a time
    prefilling: bool = False


def _init_sampler_state(eng, slots: int, seed: int) -> None:
    """Per-slot sampling parameter arrays; greedy defaults."""
    eng.seed = seed
    eng._temp = np.zeros(slots, np.float32)
    eng._topk = np.zeros(slots, np.int64)
    eng._topp = np.ones(slots, np.float32)
    eng._rids = np.zeros(slots, np.int64)


def _set_slot_sampling(eng, idx: int, rid: int,
                       sampling: Optional[SamplingParams]) -> None:
    sp = sampling or sampling_mod.GREEDY
    eng._temp[idx] = sp.temperature
    eng._topk[idx] = sp.top_k
    eng._topp[idx] = sp.top_p
    eng._rids[idx] = rid


def _clear_slot_sampling(eng, idx: int) -> None:
    eng._temp[idx] = 0.0
    eng._topk[idx] = 0
    eng._topp[idx] = 1.0
    eng._rids[idx] = 0


def _prompt_lookup_draft(ctx: torch.Tensor, pos: torch.Tensor, K: int,
                         ngram: int) -> torch.Tensor:
    """Per-slot prompt-lookup drafts: find the latest earlier occurrence of
    each slot's trailing ``ngram`` in its device context buffer ctx
    (B, max_ctx) and propose the K tokens that followed it. Garbage drafts
    are safe: acceptance is greedy-exact (see _accept_drafts)."""
    max_ctx = ctx.shape[1]
    iota = torch.arange(max_ctx, device=ctx.device)
    j = torch.arange(ngram, device=ctx.device)
    kstart = (pos - ngram + 1).clamp(0, max_ctx - ngram)
    key = torch.gather(ctx, 1, kstart[:, None] + j)  # (B, ngram)
    # stacked[b, i, j] = ctx[b, (i + j) % max_ctx]
    stacked = ctx[:, (iota[:, None] + j) % max_ctx]  # (B, max_ctx, ngram)
    hits = (stacked == key[:, None, :]).all(dim=2) & (
        iota[None, :] <= (pos - ngram)[:, None])
    istar = torch.where(hits, iota[None, :], torch.full_like(iota, -1)[None]
                        ).amax(dim=1)
    dstart = (istar + ngram).clamp(0, max_ctx - K)
    return torch.gather(
        ctx, 1, dstart[:, None] + torch.arange(K, device=ctx.device))


def _accept_drafts(logits: torch.Tensor, draft: torch.Tensor,
                   ctx: torch.Tensor, pos: torch.Tensor):
    """Greedy acceptance over a verify window's logits (B, K+1, V): keep
    draft tokens while they EQUAL the greedy token, append the greedy bonus
    token, write the emitted run into the context buffer (in place).
    Returns (emit (B, K+1), n_acc (B,), cur2 (B, 1), ctx)."""
    K, max_ctx = draft.shape[1], ctx.shape[1]
    greedy = torch.argmax(logits, dim=-1)
    match = (draft == greedy[:, :K]).long()
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)  # (B,)
    cand = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
    bonus = torch.gather(greedy, 1, n_acc[:, None])
    ar = torch.arange(K + 1, device=draft.device)
    emit = torch.where(ar[None, :] < n_acc[:, None], cand, bonus)
    wstart = (pos + 1).clamp(0, max_ctx - (K + 1))
    ctx.scatter_(1, wstart[:, None] + ar, emit)
    cur2 = torch.gather(emit, 1, n_acc[:, None])
    return emit, n_acc, cur2, ctx


def _emit_tokens(s: _Slot, toks) -> Tuple[List[int], bool]:
    """Append a window's candidate tokens to an active slot, stopping at a
    stop token or the max_new budget. Returns (emitted, done)."""
    new: List[int] = []
    done = False
    for tok in toks:
        tok = int(tok)
        s.tokens.append(tok)
        new.append(tok)
        s.generated += 1
        s.pos += 1
        done = _slot_finished(s, tok)
        if done:
            break
    return new, done


def _slot_finished(s: _Slot, tok: int) -> bool:
    return s.generated >= s.max_new or tok in s.stop


def _admit_cohort(eng, requests, max_new_tokens, sampling, stop_tokens):
    """The add_requests core: validate every prompt, then partition the
    cohort into batched same-length admission groups and single-request
    admissions, assigning request ids in input order.

    Every prompt is validated before any id is reserved or any page
    allocated, so a bad prompt leaves the engine as it was.
    eng._cohort_key(prompt) returns a hashable group key, or None to route
    the prompt through eng.add_request (chunked admissions, prefix-sharing
    hits). Groups of >= 2 admit via eng._admit_group in one batched
    prefill."""
    prompts = [np.asarray(p, np.int64).reshape(-1) for p in requests]
    if len(prompts) > eng.free_slots():
        raise RuntimeError("cohort exceeds free slots")
    for prompt in prompts:
        eng._validate(prompt, max_new_tokens)
    groups: Dict[Any, List[int]] = {}
    single: List[int] = []
    for j, prompt in enumerate(prompts):
        key = eng._cohort_key(prompt)
        if key is None:
            single.append(j)
        else:
            groups.setdefault(key, []).append(j)
    for key in [k for k, js in groups.items() if len(js) < 2]:
        single.extend(groups.pop(key))
    base = eng._next_id
    eng._next_id += len(prompts)
    rids = [base + j for j in range(len(prompts))]
    for j in sorted(single):
        eng.add_request(prompts[j], max_new_tokens, sampling=sampling,
                        stop_tokens=stop_tokens, _rid=rids[j])
    for key, js in groups.items():
        eng._admit_group([prompts[j] for j in js], [rids[j] for j in js],
                         max_new_tokens, sampling, stop_tokens)
    return rids


# ---------------------------------------------------------------------------
# Shared KV page pool + prefix sharing
# ---------------------------------------------------------------------------


def _prime_dense_impl(pools, dense, pids: List[int], *, ps: int,
                      n_kv_heads: int) -> None:
    """Prime a fresh dense temp cache (batch 1) with the shared pages of
    every layer: rows [0, len(pids) * ps), in place. An int8 pool
    dequantizes into the dense cache."""
    idx = torch.as_tensor(pids, dtype=torch.long, device=dense[0]["k"].device)
    rows = len(pids) * ps
    for pool_kv, d in zip(pools, dense):
        for name in ("k", "v"):
            pages = pool_kv["p" + name][idx]  # (m, ps, Hkv*hd)
            if "sk" in pool_kv:
                sc = kv_quant.pool_unpack_scales(pool_kv["s" + name][idx])
                pages = kv_quant.dequantize_rows(
                    pages.view(len(pids), ps, n_kv_heads, -1), sc)
            d[name][0, :rows] = pages.reshape(rows, -1).to(d[name].dtype)


def _scatter_all_impl(pools, dense, slot: int, pids: List[int],
                      first_page: int, *, ps: int, n_kv_heads: int) -> None:
    """Write the new (non-shared) prompt pages of every layer from row
    ``slot`` of the dense temp cache back into the pool, in place: dense
    rows [first_page * ps, (first_page + len(pids)) * ps) to pages ``pids``.
    An int8 pool quantizes the dense rows with ``quantize_rows``."""
    if not pids:
        return
    idx = torch.as_tensor(pids, dtype=torch.long, device=dense[0]["k"].device)
    lo, hi = first_page * ps, (first_page + len(pids)) * ps
    for pool_kv, d in zip(pools, dense):
        for name in ("k", "v"):
            src = d[name][slot, lo:hi].view(len(pids), ps, -1)
            if "sk" in pool_kv:
                codes, sc = kv_quant.quantize_rows(
                    src.view(len(pids), ps, n_kv_heads, -1))
                pool_kv["p" + name][idx] = codes.view(len(pids), ps, -1)
                pool_kv["s" + name][idx] = kv_quant.pool_pack_scales(sc)
            else:
                pool_kv["p" + name][idx] = src.to(pool_kv["p" + name].dtype)


class PagedKVPool:
    """Host-side page allocator + device page pools (one pid spans all
    layers: layer L's page data lives at pools[L]['pk'][pid]).

    Prefix sharing: full prompt pages are registered by their token-chunk
    chain; a later prompt with the same chain reuses the pages (refcount)
    and only prefill-computes its suffix. Zero-refcount shared pages stay
    cached until allocation pressure evicts them (LRU)."""

    def __init__(self, n_layers: int, n_pages: int, n_kv_heads: int,
                 page_size: int, head_dim: int, dtype=torch.bfloat16,
                 device="cuda"):
        self.ps = page_size
        self.n_pages = n_pages
        self.n_kv_heads = n_kv_heads
        # dtype "int8": pages store int8 codes plus one f32 scale per
        # (token row, kv head), (P, Hkv, ps) sidecars (ops/kv_quant.py);
        # the paged kernels quantize at the in-kernel pool write
        self.quantized = common.is_int8(dtype)
        self.pools = common.init_paged_pool(n_layers, n_pages, page_size,
                                            n_kv_heads, head_dim, dtype,
                                            device)
        self._free = list(range(n_pages - 1, -1, -1))
        self.allocated = 0  # pages handed out so far (a statistic)
        self._ref: Dict[int, int] = {}
        # chain key (parent_key, chunk tokens) -> page id; LRU order
        self._registry: Dict[tuple, int] = {}
        self._lru: List[tuple] = []

    def alloc(self) -> int:
        if not self._free:
            self._evict_one()
        pid = self._free.pop()
        self._ref[pid] = 1
        self.allocated += 1
        return pid

    def _evict_one(self) -> None:
        for key in list(self._lru):
            pid = self._registry[key]
            if self._ref.get(pid, 0) == 0:
                del self._registry[key]
                self._lru.remove(key)
                self._ref.pop(pid, None)
                self._free.append(pid)
                return
        raise RuntimeError("page pool exhausted (all pages referenced)")

    def retain(self, pid: int) -> None:
        self._ref[pid] = self._ref.get(pid, 0) + 1

    def release(self, pid: int, registered: bool) -> None:
        self._ref[pid] -= 1
        if self._ref[pid] == 0 and not registered:
            del self._ref[pid]
            self._free.append(pid)
        # registered pages linger for reuse (evicted under pressure)

    def release_all(self, pids: Sequence[int]) -> None:
        """Release one reference of each page; those a prefix chain
        registers stay cached."""
        registered = set(self._registry.values())
        for pid in pids:
            self.release(pid, registered=pid in registered)

    def pages_in_use(self) -> int:
        """Pages that some slot references."""
        return sum(1 for n in self._ref.values() if n > 0)

    def lookup_chain(self, prompt) -> Tuple[List[int], tuple]:
        """Longest registered full-page prefix (never the final page:
        decode rewrites the last prompt position in place, which must not
        touch shared storage). Returns (page ids, last chain key)."""
        shared: List[int] = []
        key: tuple = ()
        max_full = max(0, (len(prompt) - 1) // self.ps)
        for p in range(max_full):
            chunk = tuple(prompt[p * self.ps:(p + 1) * self.ps])
            nkey = (key, chunk)
            pid = self._registry.get(nkey)
            if pid is None:
                break
            shared.append(pid)
            self._lru.remove(nkey)
            self._lru.append(nkey)
            key = nkey
        return shared, key

    def register_chain(self, key: tuple, prompt, start_page: int,
                       end_page: int, pids: List[int]) -> None:
        for p in range(start_page, end_page):
            chunk = tuple(prompt[p * self.ps:(p + 1) * self.ps])
            key = (key, chunk)
            if key not in self._registry:
                self._registry[key] = pids[p]
                self._lru.append(key)
            else:
                self._lru.remove(key)
                self._lru.append(key)


def _decode_body(model, kw, b, sampled: bool, seed: int):
    """The decode step (the JAX engines' ``_decode_adv``): every slot
    decodes its current token at its position (pos -1: inactive), the next
    token is chosen (greedy, or sampled by (seed, request id, position)),
    written into row ``widx`` of the window's tokens, and the position
    advances."""

    def step():
        pos = b.pos
        logits = model.decode_step(b.cur, pos, b.caches, **kw)[:, -1]
        if sampled:
            nxt = sampling_mod.sample_tokens(
                logits.float(), b.temp, b.topk, b.topp, b.rids,
                pos.clamp(min=0), seed)
        else:
            nxt = torch.argmax(logits, dim=-1)
        b.toks.index_copy_(0, b.widx, nxt[None])
        b.widx.add_(1)
        # inactive slots (pos < 0) must NOT advance: at pos 0 a paged slot
        # would write through its zeroed page table into page 0, which
        # likely belongs to an active slot
        pos.copy_(torch.where(pos < 0, pos, pos + 1))
        b.cur.copy_(nxt[:, None])

    return step


def _spec_body(model, kw, b, speculative):
    """One slot-batched speculative window (``_spec_window_fn``): the
    prompt-lookup drafts, the verify window (through the page table, or at
    the slots' rows of a dense cache), the greedy-exact acceptance; the
    emitted tokens and accepted counts into ``spec``, the current tokens
    and the positions advanced."""
    draft_len, ngram = speculative

    def window():
        pos = b.pos
        draft = _prompt_lookup_draft(b.ctx, pos, draft_len, ngram)
        logits = model.verify_window(torch.cat([b.cur, draft], dim=1), pos,
                                     b.caches, **kw)
        emit, n_acc, cur, _ = _accept_drafts(logits, draft, b.ctx, pos)
        b.spec[:, :-1] = emit
        b.spec[:, -1] = n_acc
        b.cur.copy_(cur)
        pos.copy_(torch.where(pos < 0, pos, pos + n_acc + 1))

    return window


class _SlotEngine:
    """What the dense and the paged engine share: the slots and their
    sampler state, the persistent buffers and step programs, validation,
    cohort and chunked admission, the decode and speculative windows,
    ``cancel`` and ``run``. A subclass makes its cache, then calls
    :meth:`_init_buffers` and sets ``self._bufs.caches`` (what the model
    calls take); it provides ``add_request``, ``_cohort_key``,
    ``_admit_group`` and ``_finish_admission``."""

    # the host slot arrays whose device copies the step programs read
    _uploaded = ("pos", "temp", "topk", "topp", "rids")
    # run()'s decode steps a host sync, as the JAX engine's run() has it
    default_window = 1

    def _init_slots(self, model, *, slots: int, dtype, mode: str,
                    max_seq: Optional[int], seed: int,
                    speculative: Optional[Tuple[int, int]],
                    prefill_chunk: Optional[int], plain: bool,
                    window_gemv: bool) -> None:
        config = model.config
        self.model = model
        self.config = config
        self.device = model.device
        # the kv heads whose cache this process holds (n_kv_heads / tp on
        # a tensor-parallel shard)
        self.n_kv_heads = common.kv_heads(model)
        self.n_slots = slots
        self.max_seq = max_seq or config.max_seq
        self.dtype = dtype
        self.mode = mode
        self.plain = plain
        self.window_gemv = window_gemv
        # chunked admission: a prompt longer than this prefills that many
        # tokens per engine step into a staging cache, interleaved with
        # decode windows; the slot joins decode when the last chunk is in
        self.prefill_chunk = prefill_chunk
        self._staging: Dict[int, list] = {}
        self.speculative = speculative
        _init_sampler_state(self, slots, seed)
        self._slots = [_Slot() for _ in range(slots)]
        self._next_id = 0
        self._pos = np.full(slots, -1, np.int64)  # -1: inactive

    def _init_buffers(self, graphs: bool) -> None:
        """The step programs' persistent device buffers: the host arrays'
        counterparts (uploaded by _upload), the current tokens, the token
        history for speculative drafting (stale rows only lower the accept
        rate), a window's tokens by step, the step index, and a
        speculative window's emitted tokens with their accepted counts."""
        dev, slots = self.device, self.n_slots
        self._sent = {n: getattr(self, "_" + n).copy()
                      for n in self._uploaded}
        b = self._bufs = SimpleNamespace(
            **{n: torch.from_numpy(getattr(self, "_" + n).copy()).to(dev)
               for n in self._uploaded})
        b.cur = self._cur = torch.zeros((slots, 1), dtype=torch.long,
                                        device=dev)
        b.ctx = self._ctx = (torch.zeros((slots, self.max_seq),
                                         dtype=torch.long, device=dev)
                             if self.speculative else None)
        b.toks = torch.zeros((self.max_seq, slots), dtype=torch.long,
                             device=dev)
        b.widx = torch.zeros(1, dtype=torch.long, device=dev)
        if self.speculative:
            b.spec = torch.zeros((slots, self.speculative[0] + 2),
                                 dtype=torch.long, device=dev)
        self._capture = graphs and not self.plain
        if self._capture:
            graphs_mod.check_capturable(self.model)
        self._pool = (torch.cuda.graph_pool_handle()
                      if self._capture and dev.type == "cuda" else None)
        self._steps = {}  # name -> graphs.StepGraph
        # what the engine has run so far: model calls by kind, and the
        # speculation's drafts proposed and accepted
        self.stats = {"prefills": 0, "decode_steps": 0, "spec_windows": 0,
                      "drafted": 0, "accepted": 0}

    def _run(self):
        return dict(dtype=self.dtype, mode=self.mode, plain=self.plain)

    def free_slots(self) -> int:
        return sum(not s.active for s in self._slots)

    def _upload(self) -> None:
        """Copy each host slot array to its device buffer where it differs
        from what the device holds (``_sent``)."""
        for name in self._uploaded:
            host, sent = getattr(self, "_" + name), self._sent[name]
            if not np.array_equal(host, sent):
                getattr(self._bufs, name).copy_(torch.from_numpy(host))
                sent[...] = host

    def _program(self, name: str):
        """The step program `name` ("greedy", "sampled" or "spec"), made at
        its first use."""
        if name not in self._steps:
            model, kw, b = self.model, self._run(), self._bufs
            body = (_spec_body(model, dict(kw, window_gemv=self.window_gemv),
                               b, self.speculative) if name == "spec"
                    else _decode_body(model, kw, b, name == "sampled",
                                      self.seed))
            self._steps[name] = graphs_mod.StepGraph(
                body, self.device, capture=self._capture, pool=self._pool)
        return self._steps[name]

    def _reserve(self) -> int:
        # speculative verify windows write draft_len+1 rows past the last
        # real token: those rows must stay inside the slot's cache
        return (self.speculative[0] + 1) if self.speculative else 0

    def _validate(self, prompt, max_new_tokens: int) -> None:
        plen = len(prompt)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if plen < 1:
            raise ValueError("empty prompt")
        if min(prompt) < 0 or max(prompt) >= self.config.vocab_size:
            raise ValueError(f"prompt token outside the vocabulary of "
                             f"{self.config.vocab_size}")
        reserve = self._reserve()
        if plen + max_new_tokens + reserve > self.max_seq:
            raise ValueError("prompt + max_new_tokens exceeds max_seq"
                             + (" (incl. speculative window reserve)"
                                if reserve else ""))

    def _free_slot(self) -> int:
        idx = next((i for i, s in enumerate(self._slots) if not s.active),
                   None)
        if idx is None:
            raise RuntimeError("no free slot")
        return idx

    def _take_id(self, rid: Optional[int]) -> int:
        if rid is None:
            rid = self._next_id
            self._next_id += 1
        return rid

    def _prefill(self, tokens, dense, start: int) -> None:
        self.model.prefill(tokens, dense, start=start, **self._run())
        self.stats["prefills"] += 1

    def _tokens(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    def _seed_slot(self, idx: int, prompt: List[int]) -> None:
        """Seed slot idx for decode at pos = plen - 1 with the prompt's
        last token, which the first step decodes again (its k/v rewritten,
        its logits the first token's)."""
        plen = len(prompt)
        self._cur[idx, 0] = int(prompt[-1])
        if self._ctx is not None:
            row_t = torch.zeros(self.max_seq, dtype=torch.long)
            row_t[:plen] = torch.as_tensor(prompt, dtype=torch.long)
            self._ctx[idx] = row_t.to(self.device)
        self._pos[idx] = plen - 1

    def add_requests(self, requests, max_new_tokens: int,
                     sampling: Optional[SamplingParams] = None,
                     stop_tokens: Sequence[int] = ()) -> List[int]:
        """Admit a cohort; returns request ids in input order. Prompts of
        one length (and, in the paged engine, no shared-prefix hit) admit
        through ONE batched prefill; chunked admissions, prefix-sharing
        hits and singleton groups go through add_request. Every prompt is
        validated before anything is admitted."""
        return _admit_cohort(self, requests, max_new_tokens, sampling,
                             stop_tokens)

    @torch.no_grad()
    def _advance_prefill(self) -> None:
        """One chunk per mid-prefill slot into its staging cache (a
        continuation prefill from the rows already in); the final chunk
        hands the staging cache to _finish_admission, which moves its rows
        into the slot's cache and seeds the slot for decode."""
        if not self._staging:
            return
        for i, s in enumerate(self._slots):
            if not (s.active and s.prefilling):
                continue
            entry = self._staging[i]  # [staging, prompt, offset, ...]
            staging, prompt, off = entry[:3]
            r = min(self.prefill_chunk, len(prompt) - off)
            self._prefill(self._tokens([prompt[off:off + r]]), staging, off)
            off += r
            if off < len(prompt):
                entry[2] = off
                continue
            self._finish_admission(i, prompt, staging, 0, *entry[3:])
            s.prefilling = False
            del self._staging[i]

    def _decoding(self) -> List[_Slot]:
        return [s for s in self._slots if s.active and not s.prefilling]

    def _collect(self, toks_of) -> Dict[int, Any]:
        """Host bookkeeping after a window: ``toks_of(i)`` are slot i's
        candidate tokens."""
        out: Dict[int, Any] = {}
        for i, s in enumerate(self._slots):
            if not s.active or s.prefilling:
                continue
            new, done = _emit_tokens(s, toks_of(i))
            self._pos[i] = s.pos
            out[s.request_id] = {"token": new[-1], "new_tokens": new,
                                 "done": done}
            if done:
                out[s.request_id]["tokens"] = s.tokens
                self._release(i)
        return out

    def step(self) -> Dict[int, Any]:
        """One decode step of every decoding slot (after advancing chunked
        prefills by one chunk). Returns {request_id: {'token',
        'new_tokens', 'done', 'tokens'?}} and releases finished slots."""
        self._advance_prefill()
        return self._decode_window(1)

    def step_window(self, max_window: int = 8) -> Dict[int, Any]:
        """Up to max_window decode steps with ONE host sync: the window
        enqueues its steps back to back, token and positions advance on the
        device, the cache is written in place, and only the stacked window
        tokens are fetched. A slot that stops mid-window discards the
        window's tail."""
        self._advance_prefill()
        active = self._decoding()
        if not active:
            return {}
        remaining = min(s.max_new - s.generated for s in active)
        return self._decode_window(min(max_window, remaining))

    @torch.no_grad()
    def _decode_window(self, k: int) -> Dict[int, Any]:
        if not self._decoding():
            return {}
        self._upload()
        sampled = bool((self._temp > 0).any())
        step = self._program("sampled" if sampled else "greedy")
        self._bufs.widx.zero_()
        for _ in range(k):
            step()
            self.stats["decode_steps"] += 1
        # the window's one sync
        toks_host = self._bufs.toks[:k].cpu().numpy()
        sent = self._sent["pos"]
        sent[sent >= 0] += k  # as the device advanced them
        return self._collect(lambda i: toks_host[:, i])

    @torch.no_grad()
    def step_spec_window(self) -> Dict[int, Any]:
        """One slot-batched speculative window (engine constructed with
        ``speculative=(draft_len, ngram)``): prompt-lookup drafts from each
        slot's device token history, one W = draft_len + 1 verify forward
        for every slot, greedy-exact acceptance, so one weight pass can
        yield several tokens a slot. Greedy only: run() steps decode
        windows instead while any active slot samples. Inactive slots
        (pos < 0) write nothing; their emitted rows are skipped on the
        host."""
        if not self.speculative:
            raise RuntimeError("engine not constructed with speculative=")
        self._advance_prefill()
        if not self._decoding():
            return {}
        draft_len = self.speculative[0]
        self._upload()
        self._program("spec")()
        self.stats["spec_windows"] += 1
        spec = self._bufs.spec.cpu().numpy()  # the window's one sync
        emit_h, nacc_h = spec[:, :-1], spec[:, -1]
        sent = self._sent["pos"]
        sent[sent >= 0] += nacc_h[sent >= 0] + 1  # as the device did
        for i, s in enumerate(self._slots):
            if s.active and not s.prefilling:
                self.stats["drafted"] += draft_len
                self.stats["accepted"] += int(nacc_h[i])
        return self._collect(lambda i: emit_h[i, : int(nacc_h[i]) + 1])

    def cancel(self, request_id: int) -> bool:
        """Abort an in-flight request (e.g. the HTTP client went away) and
        free its slot. Returns False if the id is not active."""
        for i, s in enumerate(self._slots):
            if s.active and s.request_id == request_id:
                self._release(i)
                return True
        return False

    def _release(self, idx: int) -> None:
        self._staging.pop(idx, None)
        self._slots[idx] = _Slot()
        _clear_slot_sampling(self, idx)
        self._pos[idx] = -1  # length 0: the slot writes nothing again

    def step_any(self, window: int) -> Dict[int, Any]:
        """What run() and the HTTP server's loop step: a speculative
        window when the engine has them and no active slot samples, else
        `window` decode steps a host sync (:meth:`step` for 1)."""
        if self.speculative and not bool((self._temp > 0).any()):
            return self.step_spec_window()
        return self.step_window(window) if window > 1 else self.step()

    def run(self, requests, max_new_tokens: int = 16,
            window: Optional[int] = None,
            sampling: Optional[SamplingParams] = None,
            stop_tokens: Sequence[int] = (),
            on_token=None) -> Dict[int, List[int]]:
        """Serve ``requests`` (token lists) to completion: admit as slots
        free up, step until every request is done; returns the generated
        tokens by request id. window: decode steps a host sync
        (``default_window`` when None). An engine made with
        ``speculative=`` takes speculative windows while no active slot
        samples. on_token(rid, new_tokens, done) streams each window's
        tokens as they are fetched."""
        window = self.default_window if window is None else window
        pending = list(requests)
        results: Dict[int, List[int]] = {}
        while pending or any(s.active for s in self._slots):
            n = min(len(pending), self.free_slots())
            if n:  # cohort admission: one batched prefill per length group
                self.add_requests(pending[:n], max_new_tokens,
                                  sampling=sampling, stop_tokens=stop_tokens)
                del pending[:n]
            for rid, r in self.step_any(window).items():
                if on_token is not None:
                    on_token(rid, r["new_tokens"], r["done"])
                if r["done"]:
                    results[rid] = r["tokens"]
        return results


class ContinuousBatchEngine(_SlotEngine):
    """Continuous batching over fixed slots of one dense token-major KV
    cache (B = slots rows of ``max_seq`` rounded up to 16, or to 128 for an
    int8 cache, as the JAX engine rounds them).

    model: the port's Llama or OPT; the engine runs on the model's device.
    dtype: activation dtype; cache_dtype: the cache's dtype, or "int8";
    mode: 'exact' or 'bf16' (the quantized linears' regime); plain: run
    each kernel's plain PyTorch version whatever the device, eagerly.
    speculative: (draft_len, ngram) turns on prompt-lookup speculation;
    prefill_chunk: admit a long prompt that many tokens per engine step;
    graphs: capture the decode step and the speculative window as CUDA
    graphs on a CUDA device (False runs the same steps eagerly);
    window_gemv: a speculative window of at most 16 rows runs its linears
    as a decode step (``models.llama.Step.lin``; False: the mode's kernel).

    A prompt prefills into a staging cache of its own length (one batched
    prefill for a cohort of one length), whose rows then move into the
    slot's; rows a slot's earlier request left beyond its position stay,
    masked until decode overwrites them."""

    default_window = 8

    def __init__(self, model, *, slots: int = 8, dtype=torch.float32,
                 cache_dtype=torch.float32, mode: str = "exact",
                 max_seq: Optional[int] = None, seed: int = 0,
                 speculative: Optional[Tuple[int, int]] = None,
                 prefill_chunk: Optional[int] = None, plain: bool = False,
                 graphs: bool = True, window_gemv: bool = True):
        self._init_slots(model, slots=slots, dtype=dtype, mode=mode,
                         max_seq=max_seq, seed=seed, speculative=speculative,
                         prefill_chunk=prefill_chunk, plain=plain,
                         window_gemv=window_gemv)
        c = self.config
        self.cache_dtype = cache_dtype
        # the token axis rounds to 16 rows, to 128 for int8 (the JAX
        # engine's tile alignment; the kernels take any row count)
        align = 128 if common.is_int8(cache_dtype) else 16
        self.cache = common.init_kv_cache(
            slots, -(-self.max_seq // align) * align, c.n_layers,
            self.n_kv_heads, c.head_dim, cache_dtype, self.device)
        self._init_buffers(graphs)
        self._bufs.caches = self.cache

    def _staging_cache(self, batch: int, rows: int):
        c = self.config
        return common.init_kv_cache(batch, rows, c.n_layers, self.n_kv_heads,
                                    c.head_dim, self.cache_dtype,
                                    self.device)

    @torch.no_grad()
    def add_request(self, prompt_tokens, max_new_tokens: int,
                    sampling: Optional[SamplingParams] = None,
                    stop_tokens: Sequence[int] = (),
                    _rid: Optional[int] = None) -> int:
        """Prefill the prompt and occupy a slot; returns the request id.

        sampling: per-request temperature/top-k/top-p (None: greedy),
        drawn on the device in the decode step. stop_tokens: generation
        ends when one is emitted (it is kept in the output). The first
        token comes from the next step. _rid: a request id reserved by
        add_requests."""
        prompt = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        plen = len(prompt)
        self._validate(prompt, max_new_tokens)
        idx = self._free_slot()
        rid = self._take_id(_rid)
        _set_slot_sampling(self, idx, rid, sampling)
        staging = self._staging_cache(1, plen)
        chunked = bool(self.prefill_chunk and plen > self.prefill_chunk)
        if chunked:  # the slot stays at pos -1 until its last chunk is in
            self._staging[idx] = [staging, prompt, 0]
        else:
            self._prefill(self._tokens([prompt]), staging, 0)
            self._finish_admission(idx, prompt, staging, 0)
        self._slots[idx] = _Slot(active=True, request_id=rid, pos=plen - 1,
                                 max_new=max_new_tokens, generated=0,
                                 tokens=[], stop=tuple(stop_tokens),
                                 prefilling=chunked)
        return rid

    def _cohort_key(self, prompt):
        plen = len(prompt)
        if self.prefill_chunk and plen > self.prefill_chunk:
            return None
        return plen

    @torch.no_grad()
    def _admit_group(self, prompts, rids, max_new_tokens: int, sampling,
                     stop_tokens) -> None:
        """Admit same-length prompts through one batched prefill."""
        plen = len(prompts[0])
        idxs = [i for i, s in enumerate(self._slots) if not s.active]
        staging = self._staging_cache(len(prompts), plen)
        self._prefill(self._tokens(np.stack(prompts)), staging, 0)
        for r, p in enumerate(prompts):
            idx = idxs[r]
            _set_slot_sampling(self, idx, rids[r], sampling)
            self._finish_admission(idx, [int(t) for t in p], staging, r)
            self._slots[idx] = _Slot(active=True, request_id=rids[r],
                                     pos=plen - 1, max_new=max_new_tokens,
                                     generated=0, tokens=[],
                                     stop=tuple(stop_tokens))

    def _finish_admission(self, idx, prompt, staging, row) -> None:
        """Move row ``row`` of the prefilled staging cache (the prompt's
        rows; for an int8 cache its codes and scales) into slot idx's
        rows, and seed the slot for decode."""
        plen = len(prompt)
        for c, s in zip(self.cache, staging):
            for name, t in c.items():
                if name in ("ks", "vs"):  # (B, H_kv, S)
                    t[idx, :, :plen] = s[name][row]
                else:
                    t[idx, :plen] = s[name][row]
        self._seed_slot(idx, prompt)


class PagedContinuousBatchEngine(_SlotEngine):
    """Continuous batching over a shared KV page pool. Prompts sharing
    full-page prefixes reuse pages AND skip recomputing them: admission
    runs a continuation prefill on the suffix only.

    model: the port's Llama or OPT; the engine runs on the model's device.
    dtype: activation dtype; cache_dtype: the pool's dtype, or "int8";
    mode: 'exact' or 'bf16' (the quantized linears' regime); plain: run
    each kernel's plain PyTorch version whatever the device, eagerly.
    speculative: (draft_len, ngram) turns on prompt-lookup speculation;
    prefill_chunk: admit a long suffix that many tokens per engine step
    (the staging dense cache scatters into the pool only when complete);
    graphs: capture the decode step and the speculative window as CUDA
    graphs on a CUDA device (False runs the same steps eagerly);
    window_gemv: a speculative window of at most 16 rows runs its linears
    as a decode step (``models.llama.Step.lin``; False: the mode's kernel)."""

    _uploaded = ("pos", "pt", "temp", "topk", "topp", "rids")

    def __init__(self, model, *, slots: int = 8, n_pages: int = 256,
                 page_size: int = 128, dtype=torch.float32,
                 cache_dtype=torch.bfloat16, mode: str = "exact",
                 max_seq: Optional[int] = None, seed: int = 0,
                 speculative: Optional[Tuple[int, int]] = None,
                 prefill_chunk: Optional[int] = None, plain: bool = False,
                 graphs: bool = True, window_gemv: bool = True):
        if speculative and speculative[0] + 1 > paged_attn.MAX_WINDOW_TOKENS:
            raise ValueError(
                f"speculative draft_len {speculative[0]} exceeds the verify "
                f"kernels' window of {paged_attn.MAX_WINDOW_TOKENS} tokens")
        self._init_slots(model, slots=slots, dtype=dtype, mode=mode,
                         max_seq=max_seq, seed=seed, speculative=speculative,
                         prefill_chunk=prefill_chunk, plain=plain,
                         window_gemv=window_gemv)
        config = self.config
        self.ps = page_size
        self.maxp = -(-self.max_seq // page_size)
        self.pool = PagedKVPool(config.n_layers, n_pages, self.n_kv_heads,
                                page_size, config.head_dim, cache_dtype,
                                self.device)
        # an int8 pool's prefill temp cache stays full precision; rows
        # quantize at the pool scatter
        self._dense_dtype = (torch.bfloat16 if self.pool.quantized
                             else self.pool.pools[0]["pk"].dtype)
        self._slot_pages: List[List[int]] = [[] for _ in range(slots)]
        self._slot_shared: List[int] = [0] * slots
        # inactive slots carry pos = -1 and a zeroed page table
        self._pt = np.zeros((slots, self.maxp), np.int32)
        self._init_buffers(graphs)
        self._bufs.caches = [dict(c, pt=self._bufs.pt)
                             for c in self.pool.pools]

    def _alloc_pages(self, n: int, held: List[int]) -> List[int]:
        """Allocate n pages one at a time. If the pool runs out, the pages
        allocated so far and every page in ``held`` are released before the
        error goes on."""
        new_pids: List[int] = []
        try:
            for _ in range(n):
                new_pids.append(self.pool.alloc())
        except RuntimeError:
            self.pool.release_all(new_pids + held)
            raise
        return new_pids

    def _fresh_dense(self, batch: int, pages: int):
        return common.init_kv_cache(
            batch, pages * self.ps, self.config.n_layers, self.n_kv_heads,
            self.config.head_dim, self._dense_dtype, self.device)

    @torch.no_grad()
    def add_request(self, prompt_tokens, max_new_tokens: int,
                    sampling: Optional[SamplingParams] = None,
                    stop_tokens: Sequence[int] = (),
                    _rid: Optional[int] = None) -> int:
        prompt = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        plen = len(prompt)
        self._validate(prompt, max_new_tokens)
        idx = self._free_slot()

        shared_pids, chain_key = self.pool.lookup_chain(prompt)
        n_shared = len(shared_pids)
        start = n_shared * self.ps
        for pid in shared_pids:
            self.pool.retain(pid)
        # pages covering [start, plen + max_new_tokens + reserve); every
        # refcount rolls back if the pool runs out mid-allocation
        total_pages = -(-(plen + max_new_tokens + self._reserve()) // self.ps)
        new_pids = self._alloc_pages(total_pages - n_shared, shared_pids)
        pids = shared_pids + new_pids
        self._slot_pages[idx] = pids
        self._slot_shared[idx] = n_shared

        # continuation prefill of the suffix on a dense temp cache primed
        # with the shared pages
        suffix = prompt[start:]
        covered = -(-plen // self.ps)  # pages with any prompt content
        dense = self._fresh_dense(1, covered)
        if n_shared:
            _prime_dense_impl(self.pool.pools, dense, shared_pids, ps=self.ps,
                              n_kv_heads=self.n_kv_heads)
        rid = self._take_id(_rid)
        _set_slot_sampling(self, idx, rid, sampling)
        chunked = bool(self.prefill_chunk
                       and len(suffix) > self.prefill_chunk)
        if chunked:
            # the page table stays zeroed and pos -1 (inactive to every
            # kernel) until the staging cache is complete and scattered;
            # page REGISTRATION also waits: registering now would let
            # another request share pages that hold no content yet
            self._staging[idx] = [dense, prompt, start, pids, n_shared,
                                  chain_key]
            self._pt[idx] = 0
            self._pos[idx] = -1
        else:
            self._prefill(self._tokens([suffix]), dense, start)
            self._finish_admission(idx, prompt, dense, 0, pids, n_shared,
                                   chain_key)
        self._slots[idx] = _Slot(active=True, request_id=rid, pos=plen - 1,
                                 max_new=max_new_tokens, generated=0,
                                 tokens=[], stop=tuple(stop_tokens),
                                 prefilling=chunked)
        return rid

    def _cohort_key(self, prompt):
        plen = len(prompt)
        if self.prefill_chunk and plen > self.prefill_chunk:
            return None
        shared, _ = self.pool.lookup_chain([int(t) for t in prompt])
        if shared:  # prefix hit: the single path primes + suffix-prefills
            return None
        return plen

    @torch.no_grad()
    def _admit_group(self, prompts, rids, max_new_tokens: int, sampling,
                     stop_tokens) -> None:
        """Admit same-length prompts through one batched prefill."""
        plen = len(prompts[0])
        idxs = [i for i, s in enumerate(self._slots) if not s.active]
        idxs = idxs[:len(prompts)]
        total = -(-(plen + max_new_tokens + self._reserve()) // self.ps)
        allocs: List[List[int]] = []
        for _ in prompts:
            # page by page into a list the rollback sees: a request that
            # the pool cannot finish leaks nothing
            held = [pid for pids in allocs for pid in pids]
            allocs.append(self._alloc_pages(total, held))
        covered = -(-plen // self.ps)
        dense = self._fresh_dense(len(prompts), covered)
        self._prefill(self._tokens(np.stack(prompts)), dense, 0)
        for r, p in enumerate(prompts):
            idx = idxs[r]
            self._slot_pages[idx] = allocs[r]
            self._slot_shared[idx] = 0
            _set_slot_sampling(self, idx, rids[r], sampling)
            self._finish_admission(idx, [int(t) for t in p], dense, r,
                                   allocs[r], 0, ())
            self._slots[idx] = _Slot(active=True, request_id=rids[r],
                                     pos=plen - 1, max_new=max_new_tokens,
                                     generated=0, tokens=[],
                                     stop=tuple(stop_tokens))

    def _finish_admission(self, idx, prompt, dense, row, pids, n_shared,
                          chain_key) -> None:
        """Scatter row ``row`` of the prefilled dense temp cache into the
        pool, register the prompt's shareable pages, and seed the slot for
        decode: the admission tail shared by whole-suffix, cohort and
        chunked prefill."""
        plen = len(prompt)
        covered = -(-plen // self.ps)
        _scatter_all_impl(self.pool.pools, dense, row,
                          pids[n_shared:covered], n_shared, ps=self.ps,
                          n_kv_heads=self.n_kv_heads)
        # register the prompt's full pages (excl. the final page) for reuse
        self.pool.register_chain(chain_key, prompt, n_shared,
                                 max(n_shared, (plen - 1) // self.ps), pids)
        self._pt[idx] = 0
        self._pt[idx, : len(pids)] = pids
        self._seed_slot(idx, prompt)

    def _release(self, idx: int) -> None:
        """Free the slot AND its pages (refcounts released; registered
        prefix pages stay cached); its page table is zeroed, so the freed
        page ids are never written again through this slot."""
        self.pool.release_all(self._slot_pages[idx])
        self._slot_pages[idx] = []
        self._pt[idx] = 0
        super()._release(idx)


# ---------------------------------------------------------------------------
# Tensor-parallel serving: the same engines on every rank's shards
# ---------------------------------------------------------------------------


def _shard_for_engine(model, tp: int, group, fuse: bool):
    """This rank's shards of the full, unfused ``model`` on ``group`` (None:
    the default group), which must hold ``tp`` ranks; fused after when
    asked."""
    import torch.distributed as dist

    from squeezellm_tpu_torch.parallel import tp as tp_mod

    size = dist.get_world_size(group)
    if size != tp:
        raise ValueError(f"tp={tp} on a process group of {size} ranks")
    return tp_mod.shard_model(model, group=group, fuse=fuse)


class TPContinuousBatchEngine(ContinuousBatchEngine):
    """Tensor-parallel continuous batching over dense slots: the JAX
    package's ``TPContinuousBatchEngine``, run SPMD. Every rank of a
    ``tp``-rank process group constructs it over the same full, unfused
    model and calls it identically; it serves the rank's shards
    (``parallel.tp.shard_model``: Megatron column/row-parallel linears, KV
    heads split, two all-reduces a layer and the lm_head's gather), with a
    cache over the rank's n_kv_heads / tp heads. Every rank ends each step
    with the same full logits, so its host bookkeeping (slots, sampler
    state, ids) stays identical to the others'. Speculation, chunked
    admission, windows, sampling, stop tokens and cancellation are the
    dense engine's.

    tp: the group's size; group: the process group (None: the default);
    fuse: fuse the local q|k|v and gate|up (``models.fuse``). graphs: on a
    CUDA device the steps are captured only over NCCL; asked for graphs on
    a gloo group (ranks sharing one card) the engine raises
    (``graphs.check_capturable``). The other arguments are the dense
    engine's."""

    def __init__(self, model, *, tp: int, group=None, fuse: bool = False,
                 **kw):
        super().__init__(_shard_for_engine(model, tp, group, fuse), **kw)


class TPPagedContinuousBatchEngine(PagedContinuousBatchEngine):
    """Tensor-parallel paged serving: the JAX package's
    ``TPPagedContinuousBatchEngine``, run SPMD as
    :class:`TPContinuousBatchEngine`. Each rank's page pool (and its
    admission's dense temporary cache) holds the rank's kv heads, so every
    paged operation (prime, scatter, K6-K9) stays on the rank; page ids,
    refcounts and the prefix registry are identical on every rank, since
    a page id spans all heads. An int8 pool's scale sidecars are
    (pages, n_kv_heads / tp, page_size): the JAX package pads the head
    rows to 8 a shard (``ops/kv_quant.head_rows``), a TPU tile rule that
    is not ported. Arguments: :class:`TPContinuousBatchEngine`'s tp,
    group and fuse, and the paged engine's."""

    def __init__(self, model, *, tp: int, group=None, fuse: bool = False,
                 **kw):
        super().__init__(_shard_for_engine(model, tp, group, fuse), **kw)
