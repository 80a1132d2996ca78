"""XGen's tokenizer: a byte-level BPE equal to tiktoken's, the port's own
copy of the JAX package's ``utils/xgen_tokenizer.py``.

The reference loads Salesforce's tiktoken-backed tokenizer with
``trust_remote_code=True`` (reference
models/xgen-7b-8k-base/tokenization_xgen.py). This implements the same
behaviour with neither tiktoken nor remote code:

  * a byte-level BPE engine equal to tiktoken's: split text with the GPT-2
    regex, then greedily merge adjacent byte-pair fragments by ascending
    rank; token id == rank (tests hold it to an offline
    ``tiktoken.Encoding`` built from the same ranks).
  * the XGen vocabulary on top of the GPT-2 base ranks, in the reference's
    id order (tokenization_xgen.py:28-104): whitespace runs of 31..2
    spaces, tab runs of 9..2, 18 FIM/special tokens, then the optional pad
    token.

The GPT-2 base ranks ship with an XGen checkpoint; loaders take either the
tiktoken format (base64 token and rank a line) or the classic
``encoder.json`` + ``vocab.bpe`` pair. The ``regex`` package (for the
GPT-2 pattern's ``\\p{L}`` classes) is imported when a tokenizer is made,
so the module loads without it.
"""

from __future__ import annotations

import base64
import json
import os
from functools import lru_cache
from typing import Dict, List, Optional

# GPT-2 / r50k_base pre-tokenization pattern (public, openai_public.py)
_GPT2_PAT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
    r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

_EOT = "<|endoftext|>"

_FIM_TOKENS = [
    "<fim_prefix>", "<fim_middle>", "<fim_suffix>", "<fim_pad>",
    "<filename>", "<gh_stars>", "<issue_start>", "<issue_comment>",
    "<issue_closed>", "<jupyter_start>", "<jupyter_text>", "<jupyter_code>",
    "<jupyter_output>", "<empty_output>", "<commit_before>", "<commit_msg>",
    "<commit_after>", "<reponame>",
]


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode map (needed to read
    the classic vocab.bpe/encoder.json asset format)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def load_ranks_tiktoken(path: str) -> Dict[bytes, int]:
    """tiktoken file format: one 'base64(token) rank' pair per line."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tok_b64, rank = line.split()
            ranks[base64.b64decode(tok_b64)] = int(rank)
    return ranks


def load_ranks_gpt2(encoder_json: str, vocab_bpe: str) -> Dict[bytes, int]:
    """Classic GPT-2 asset pair: encoder.json maps printable-unicode token
    strings to ids; decode them back to raw bytes."""
    with open(encoder_json, encoding="utf-8") as f:
        enc = json.load(f)
    del vocab_bpe  # merge order is implied by the ids in encoder.json
    u2b = {u: bytes([b]) for b, u in _bytes_to_unicode().items()}
    ranks: Dict[bytes, int] = {}
    for tok, idx in enc.items():
        if tok == _EOT:
            continue  # special token, not a mergeable rank
        ranks[b"".join(u2b[ch] for ch in tok)] = int(idx)
    return ranks


def xgen_augment(base_ranks: Dict[bytes, int],
                 pad_token: Optional[str] = None):
    """Reference vocabulary augmentation (tokenization_xgen.py:28-104).

    Returns (mergeable_ranks, special_tokens). Base vocab is assumed to be
    GPT-2's (ids 0..50256 with <|endoftext|> = 50257th)."""
    ranks = dict(base_ranks)
    specials = {_EOT: len(base_ranks)}  # gpt2: eot sits right after ranks
    idx = len(base_ranks) + 1
    for n in reversed(range(2, 32)):  # 31..2 spaces
        ranks[b" " * n] = idx
        idx += 1
    for n in reversed(range(2, 10)):  # 9..2 tabs
        ranks[b"\t" * n] = idx
        idx += 1
    for sp in _FIM_TOKENS:
        specials[sp] = idx
        idx += 1
    if pad_token and pad_token not in specials:
        specials[pad_token] = idx
        idx += 1
    return ranks, specials


def bpe_encode_piece(ranks: Dict[bytes, int], piece: bytes) -> List[int]:
    """tiktoken-equivalent greedy merge: repeatedly merge the adjacent
    pair whose concatenation has the LOWEST rank (ties: leftmost)."""
    if piece in ranks:  # whole-piece fast path (also the augmented runs)
        return [ranks[piece]]
    parts = [piece[i : i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best_rank = None
        best_i = -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_rank = r
                best_i = i
        if best_rank is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return [ranks[p] for p in parts]


class XgenTokenizer:
    """Minimal HF-shaped interface: __call__/encode/decode.

    Construct via :func:`from_assets` (checkpoint dir) or directly from a
    ranks dict (tests)."""

    def __init__(self, base_ranks: Dict[bytes, int],
                 pad_token: Optional[str] = None, add_eos_token: bool = False):
        import regex

        self.ranks, self.special_tokens = xgen_augment(base_ranks, pad_token)
        self.add_eos_token = add_eos_token
        self.eos_token_id = self.special_tokens[_EOT]
        self.pad_token_id = (self.special_tokens.get(pad_token)
                             if pad_token else None)
        self._pat = regex.compile(_GPT2_PAT)
        self._decoder = {v: k for k, v in self.ranks.items()}
        for sp, idx in self.special_tokens.items():
            self._decoder[idx] = sp.encode("utf-8")
        # longest-first special splitting
        self._special_pat = regex.compile(
            "|".join(regex.escape(s) for s in
                     sorted(self.special_tokens, key=len, reverse=True))
        )

    @property
    def vocab_size(self) -> int:
        return len(self.ranks) + len(self.special_tokens)

    def __len__(self) -> int:
        return self.vocab_size

    @classmethod
    def from_assets(cls, model_dir: str, **kw) -> "XgenTokenizer":
        tk = os.path.join(model_dir, "gpt2.tiktoken")
        if os.path.exists(tk):
            return cls(load_ranks_tiktoken(tk), **kw)
        ej = os.path.join(model_dir, "encoder.json")
        vb = os.path.join(model_dir, "vocab.bpe")
        if os.path.exists(ej):
            return cls(load_ranks_gpt2(ej, vb), **kw)
        raise FileNotFoundError(
            "no tokenizer assets (gpt2.tiktoken or encoder.json) in "
            f"{model_dir}"
        )

    def _encode_ordinary(self, text: str) -> List[int]:
        out: List[int] = []
        for m in self._pat.finditer(text):
            out.extend(bpe_encode_piece(self.ranks, m.group().encode("utf-8")))
        return out

    def encode(self, text: str, allowed_special: bool = True) -> List[int]:
        out: List[int] = []
        pos = 0
        if allowed_special and self.special_tokens:
            for m in self._special_pat.finditer(text):
                out.extend(self._encode_ordinary(text[pos : m.start()]))
                out.append(self.special_tokens[m.group()])
                pos = m.end()
        out.extend(self._encode_ordinary(text[pos:]))
        if self.add_eos_token:
            out.append(self.eos_token_id)
        return out

    def decode(self, ids) -> str:
        return b"".join(self._decoder[int(i)] for i in ids).decode(
            "utf-8", errors="replace")

    def __call__(self, text: str, return_tensors: Optional[str] = None):
        import numpy as np

        ids = self.encode(text)
        arr = np.asarray([ids], dtype=np.int64)
        return {"input_ids": arr,
                "attention_mask": np.ones_like(arr)}
