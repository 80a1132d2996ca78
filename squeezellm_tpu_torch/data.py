"""Dataset loaders for calibration and perplexity evaluation.

The port's own copy of the JAX package's ``data.py`` (numpy only; the two
must give the same arrays for the same arguments, which
``tests/test_torch_eval.py`` holds). Each dataset reproduces the reference
loaders' corpus construction, split choice, joining convention and RNG
consumption order (reference squeezellm/datautils.py):

  wikitext2   train/test splits, "\n\n".join          (datautils.py:10-35)
  ptb         train/VALIDATION splits, "\n\n".join    (datautils.py:38-63)
  c4          calib: per-document random windows (docs re-drawn until
              len >= seqlen); eval: 256 random seed-0 windows drawn the
              same way from validation, hstacked      (datautils.py:66-124)
  ptb_new     train/TEST splits, " ".join             (datautils.py:127-151)
  c4_new      calib as c4; eval: " ".join of the first 1100 validation
              docs, truncated to 256*seqlen           (datautils.py:154-201)

The HF ``datasets`` loaders are lazy imports and need a warm cache; two
offline sources need neither:
  * ``synthetic``: deterministic random tokens (tests/benchmarks),
  * a path to a ``.npy`` int token array (pre-tokenized corpus).
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np


def set_seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)


def _sample_windows(token_ids: np.ndarray, nsamples: int, seed: int,
                    seqlen: int) -> np.ndarray:
    """Reference sampling: random.seed(seed); nsamples windows of seqlen
    (datautils.py:26-34). Returns (nsamples, seqlen)."""
    rnd = random.Random(seed)
    n = token_ids.shape[-1]
    out = np.empty((nsamples, seqlen), dtype=np.int32)
    for s in range(nsamples):
        i = rnd.randint(0, n - seqlen - 1)
        out[s] = token_ids[..., i : i + seqlen]
    return out


def _doc_windows(docs, nsamples: int, rnd: "random.Random", seqlen: int,
                 tokenizer) -> np.ndarray:
    """Reference C4 sampling (datautils.py:89-99,109-117): draw a random
    document until its tokenization is >= seqlen, then a random window.
    RNG consumption order matches the reference exactly (one randint per
    document try, one per window)."""
    out = np.empty((nsamples, seqlen), dtype=np.int32)
    for s in range(nsamples):
        while True:
            i = rnd.randint(0, len(docs) - 1)
            enc = _encode(tokenizer, docs[i])
            if enc.shape[-1] >= seqlen:
                break
        # reference: randint(0, len - seqlen - 1) — same here, incl. the
        # (len == seqlen) edge where randint(0, -1) would raise; the
        # reference requires len >= seqlen AND a valid randint, i.e. the
        # while-loop only exits on len >= seqlen; len == seqlen raises in
        # the reference too, so keep identical behavior.
        j = rnd.randint(0, enc.shape[-1] - seqlen - 1)
        out[s] = enc[..., j : j + seqlen]
    return out


def synthetic_tokens(vocab_size: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-corpus: (1, n_tokens) int32."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, size=(1, n_tokens), dtype=np.int32)


def _encode(tokenizer, text: str) -> np.ndarray:
    enc = tokenizer(text, return_tensors="np")
    return np.asarray(enc["input_ids"], dtype=np.int32)


# --------------------------------------------------------------------------
# Per-dataset loaders (reference datautils.py structure)
# --------------------------------------------------------------------------


def _load_wikitext2():
    from datasets import load_dataset

    train = load_dataset("wikitext", "wikitext-2-raw-v1", split="train")
    test = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
    return train["text"], test["text"]


def _load_ptb(eval_split: str):
    from datasets import load_dataset

    train = load_dataset("ptb_text_only", "penn_treebank", split="train")
    ev = load_dataset("ptb_text_only", "penn_treebank", split=eval_split)
    return train["sentence"], ev["sentence"]


def _load_c4():
    from datasets import load_dataset

    train = load_dataset(
        "allenai/c4",
        data_files={"train": "en/c4-train.00000-of-01024.json.gz"},
        split="train",
    )
    val = load_dataset(
        "allenai/c4",
        data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
        split="validation",
    )
    return train["text"], val["text"]


def get_wikitext2(nsamples, seed, seqlen, tokenizer):
    """datautils.py:10-35: "\n\n".join, train calib windows, test eval."""
    train_txt, test_txt = _load_wikitext2()
    trainenc = _encode(tokenizer, "\n\n".join(train_txt))
    testenc = _encode(tokenizer, "\n\n".join(test_txt))
    return _sample_windows(trainenc, nsamples, seed, seqlen), testenc


def get_ptb(nsamples, seed, seqlen, tokenizer):
    """datautils.py:38-63: the reference evaluates the VALIDATION split."""
    train_txt, val_txt = _load_ptb("validation")
    trainenc = _encode(tokenizer, "\n\n".join(train_txt))
    testenc = _encode(tokenizer, "\n\n".join(val_txt))
    return _sample_windows(trainenc, nsamples, seed, seqlen), testenc


def get_ptb_new(nsamples, seed, seqlen, tokenizer):
    """datautils.py:127-151: TEST split, " ".join (NOT an alias of ptb:
    different split and joiner)."""
    train_txt, test_txt = _load_ptb("test")
    trainenc = _encode(tokenizer, " ".join(train_txt))
    testenc = _encode(tokenizer, " ".join(test_txt))
    return _sample_windows(trainenc, nsamples, seed, seqlen), testenc


def get_c4(nsamples, seed, seqlen, tokenizer):
    """datautils.py:66-124: per-document calib windows (seeded `seed`);
    eval = 256 seed-0 per-document windows from validation, hstacked."""
    train_docs, val_docs = _load_c4()
    calib = _doc_windows(train_docs, nsamples, random.Random(seed), seqlen,
                         tokenizer)
    ev = _doc_windows(val_docs, 256, random.Random(0), seqlen, tokenizer)
    return calib, ev.reshape(1, -1)


def get_c4_new(nsamples, seed, seqlen, tokenizer):
    """datautils.py:154-201: calib as c4; eval = " ".join of the first
    1100 validation docs truncated to 256*seqlen."""
    train_docs, val_docs = _load_c4()
    calib = _doc_windows(train_docs, nsamples, random.Random(seed), seqlen,
                         tokenizer)
    valenc = _encode(tokenizer, " ".join(val_docs[:1100]))
    return calib, valenc[:, : 256 * seqlen]


def get_loaders(
    name: str,
    nsamples: int = 128,
    seed: int = 0,
    seqlen: int = 2048,
    tokenizer=None,
    vocab_size: int = 32000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (calibration (nsamples, seqlen) int32, eval tokens (1, N) int32).

    `name` may be: 'synthetic', a `.npy` path, or any of
    wikitext2 / ptb / ptb_new / c4 / c4_new (reference datautils.py:219-226
    dispatch, incl. the substring matching)."""
    if name == "synthetic":
        corpus = synthetic_tokens(vocab_size, max(seqlen * (nsamples + 8), 4 * seqlen), seed)
        return _sample_windows(corpus, nsamples, seed, seqlen), corpus
    if name.endswith(".npy"):
        corpus = np.load(name).reshape(1, -1).astype(np.int32)
        return _sample_windows(corpus, nsamples, seed, seqlen), corpus
    if tokenizer is None:
        raise ValueError(f"dataset {name!r} needs a tokenizer")
    # reference dispatch (datautils.py:219-226): substring match, "new"
    # selects the _new protocol variants
    if "wikitext2" in name:
        return get_wikitext2(nsamples, seed, seqlen, tokenizer)
    if "ptb" in name:
        if "new" in name:
            return get_ptb_new(nsamples, seed, seqlen, tokenizer)
        return get_ptb(nsamples, seed, seqlen, tokenizer)
    if "c4" in name:
        if "new" in name:
            return get_c4_new(nsamples, seed, seqlen, tokenizer)
        return get_c4(nsamples, seed, seqlen, tokenizer)
    raise ValueError(f"unknown dataset {name!r}")
