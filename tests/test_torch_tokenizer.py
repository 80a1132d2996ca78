"""The port's tokenizers against the JAX package's, on the CPU, with
synthetic ranks in both XGen asset formats (as
``tests/test_xgen_tokenizer.py`` builds them; no tokenizer file is in the
repository and none is fetched):

* the port's ``XgenTokenizer`` encodes seeded strings as the JAX one and as
  a ``tiktoken`` oracle built from the same ranks; specials and round
  trips;
* ``utils.hf.load_tokenizer`` / ``has_tokenizer`` pick the class the JAX
  functions pick (XGen assets, GPT-2 ``vocab.json`` + ``merges.txt``
  through ``transformers.AutoTokenizer``) and raise the same error without
  assets;
* the ``eval`` command on a text dataset (HF ``datasets`` stubbed, as
  ``tests/test_data_protocol.py`` stubs it) tokenizes the ids the JAX
  package's ``_eval_tokens`` gives, and ``fisher`` calibrates on the ids the
  JAX command does.
"""

import argparse
import base64
import json
import random
import sys
import types

import numpy as np
import pytest

tiktoken = pytest.importorskip("tiktoken")

from squeezellm_tpu import cli as jcli  # noqa: E402
from squeezellm_tpu.utils import hf as jhf  # noqa: E402
from squeezellm_tpu.utils import xgen_tokenizer as jxt  # noqa: E402
from squeezellm_tpu_torch import cli  # noqa: E402
from squeezellm_tpu_torch.utils import hf  # noqa: E402
from squeezellm_tpu_torch.utils import xgen_tokenizer as xt  # noqa: E402

GPT2_PAT = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
            r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
MERGES = (b"th", b"he", b"the", b" t", b" th", b" the", b"in", b"ing", b"  ",
          b"er", b"ll", b"hello", b" w", b" wo", b"or", b"ld", b"to", b"ok")
ALPHABET = list("the quick brown fox jumps over ing hello world TOKEN 0123")
ALPHABET += [" ", "  ", "\t", "\n", "\t\t", "'ll", "'s", "!", "?", "é", "日本",
             "—"]
# a tiny LLaMA whose vocabulary holds every id of the synthetic ranks
LLAMA_CONFIG = {"model_type": "llama", "vocab_size": 384, "hidden_size": 32,
                "intermediate_size": 64, "num_hidden_layers": 1,
                "num_attention_heads": 2, "num_key_value_heads": 2,
                "max_position_embeddings": 64}


def base_ranks():
    ranks = {bytes([b]): b for b in range(256)}
    for tok in MERGES:
        ranks[tok] = len(ranks)
    return ranks


def oracle(base, pad_token=None):
    """The reference's XGen vocabulary (tokenization_xgen.py:28-104) over
    the synthetic base, in a real tiktoken.Encoding."""
    ranks = dict(base)
    idx = len(base) + 1
    for n in list(reversed(range(2, 32))):
        ranks[b" " * n] = idx
        idx += 1
    for n in reversed(range(2, 10)):
        ranks[b"\t" * n] = idx
        idx += 1
    specials = {"<|endoftext|>": len(base)}
    for sp in jxt._FIM_TOKENS + ([pad_token] if pad_token else []):
        specials[sp] = idx
        idx += 1
    return tiktoken.Encoding(name="xgen-test", pat_str=GPT2_PAT,
                             mergeable_ranks=ranks, special_tokens=specials)


def seeded_text(seed, n=60):
    rng = random.Random(seed)
    return "".join(rng.choice(ALPHABET) for _ in range(n))


def write_tiktoken(d):
    (d / "gpt2.tiktoken").write_text("\n".join(
        f"{base64.b64encode(t).decode()} {r}"
        for t, r in base_ranks().items()))


def write_encoder_json(d):
    b2u = xt._bytes_to_unicode()
    enc = {"".join(b2u[b] for b in t): r for t, r in base_ranks().items()}
    enc["<|endoftext|>"] = len(enc)
    (d / "encoder.json").write_text(json.dumps(enc))
    (d / "vocab.bpe").write_text("#version: 0.2\n")


def write_gpt2_pair(d):
    """GPT-2's classic slow-tokenizer files (OPT ships these)."""
    b2u = xt._bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = [("t", "h"), ("th", "e"), ("Ġ", "t"), ("Ġt", "he")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


@pytest.mark.parametrize("seed", range(6))
def test_xgen_encodes_as_the_jax_package_and_tiktoken(seed):
    text = seeded_text(seed)
    base = base_ranks()
    got = xt.XgenTokenizer(base).encode(text)
    assert got == jxt.XgenTokenizer(base).encode(text)
    assert got == oracle(base).encode_ordinary(text)
    assert xt.XgenTokenizer(base).decode(got) == text


def test_xgen_specials_and_round_trip():
    base = base_ranks()
    ours = xt.XgenTokenizer(base, pad_token="<pad>")
    enc = oracle(base, pad_token="<pad>")
    text = ("<fim_prefix>hello<fim_suffix> world\t\t<fim_middle>the"
            "<|endoftext|>" + " " * 33 + "<pad>")
    got = ours.encode(text)
    assert got == enc.encode(text, allowed_special="all")
    assert got == jxt.XgenTokenizer(base, pad_token="<pad>").encode(text)
    assert ours.decode(got) == text
    assert ours.eos_token_id == enc._special_tokens["<|endoftext|>"]
    assert ours.pad_token_id == enc._special_tokens["<pad>"]
    assert len(ours) == len(jxt.XgenTokenizer(base, pad_token="<pad>"))
    eos = xt.XgenTokenizer(base, add_eos_token=True)("the the")["input_ids"]
    assert eos.shape[0] == 1 and eos[0, -1] == ours.eos_token_id


@pytest.mark.parametrize("assets", ["tiktoken", "encoder.json", "gpt2 pair",
                                    "none"])
def test_load_tokenizer_picks_the_jax_package_class(assets, tmp_path):
    {"tiktoken": write_tiktoken, "encoder.json": write_encoder_json,
     "gpt2 pair": write_gpt2_pair, "none": lambda d: None}[assets](tmp_path)
    (tmp_path / "config.json").write_text(json.dumps(
        dict(LLAMA_CONFIG, model_type="opt")))
    d = str(tmp_path)
    assert hf.has_tokenizer(d) == jhf.has_tokenizer(d) == (assets != "none")
    if assets == "none":
        with pytest.raises(FileNotFoundError) as got:
            hf.load_tokenizer(d)
        with pytest.raises(FileNotFoundError) as want:
            jhf.load_tokenizer(d)
        assert str(got.value) == str(want.value)
        assert "tokenizer.model" in str(got.value)
        return
    got, want = hf.load_tokenizer(d), jhf.load_tokenizer(d)
    assert type(got).__name__ == type(want).__name__
    if assets == "gpt2 pair":
        assert type(got).__module__.startswith("transformers.")
    else:
        assert isinstance(got, xt.XgenTokenizer)
    text = seeded_text(11)
    np.testing.assert_array_equal(got(text)["input_ids"],
                                  want(text)["input_ids"])


@pytest.fixture()
def stub_datasets(monkeypatch):
    rng = random.Random(3)

    def docs(n):
        return [" ".join(rng.choice(["the", "hello", "world", "token",
                                     "ing", "ok"])
                         for _ in range(rng.randint(5, 30)))
                for _ in range(n)]

    corpora = {"train": {"text": docs(30)}, "test": {"text": docs(20)}}

    def load_dataset(name, *args, **kwargs):
        assert "wikitext" in name
        return corpora[kwargs["split"]]

    mod = types.ModuleType("datasets")
    mod.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", mod)
    return corpora


@pytest.fixture()
def xgen_dir(tmp_path):
    write_tiktoken(tmp_path)
    (tmp_path / "config.json").write_text(json.dumps(LLAMA_CONFIG))
    return tmp_path


def test_eval_command_tokenizes_as_the_jax_package(xgen_dir, stub_datasets,
                                                   monkeypatch, capsys):
    from squeezellm_tpu_torch import eval as eval_mod
    from squeezellm_tpu_torch.models import registry

    seen = []
    real = eval_mod.perplexity

    def recording(model, tokens, **kw):
        seen.append(np.asarray(tokens))
        return real(model, tokens, **kw)

    monkeypatch.setattr(eval_mod, "perplexity", recording)
    cli.main(["eval", "--synthetic", str(xgen_dir / "config.json"),
              "--dataset", "wikitext2", "--seqlen", "16", "--nsamples", "2",
              "--group", "1", "--device", "cpu"])
    assert np.isfinite(json.loads(capsys.readouterr().out.splitlines()[-1])[
        "ppl"])
    _, config = registry.load_config(str(xgen_dir))
    want = jcli._eval_tokens(argparse.Namespace(
        dataset="wikitext2", nsamples=128, seed=0, seqlen=16), config,
        str(xgen_dir))
    assert len(seen) == 1 and seen[0].size > 100
    np.testing.assert_array_equal(seen[0], want)


class _Calibrated(Exception):
    """Raised in place of the Fisher pass: the tokens are what is held."""


def test_fisher_command_calibrates_as_the_jax_package(xgen_dir,
                                                      stub_datasets,
                                                      monkeypatch):
    import torch

    from squeezellm_tpu.quantize import gradients as jgradients
    from squeezellm_tpu_torch.quantize import gradients

    gen = torch.Generator().manual_seed(0)
    h, f, v = (LLAMA_CONFIG[k] for k in ("hidden_size", "intermediate_size",
                                         "vocab_size"))
    shapes = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h),
              "self_attn.v_proj": (h, h), "self_attn.o_proj": (h, h),
              "mlp.gate_proj": (f, h), "mlp.up_proj": (f, h),
              "mlp.down_proj": (h, f)}
    sd = {f"model.layers.0.{n}.weight": torch.randn(*s, generator=gen)
          for n, s in shapes.items()}
    sd.update({"model.layers.0.input_layernorm.weight": torch.ones(h),
               "model.layers.0.post_attention_layernorm.weight":
                   torch.ones(h),
               "model.embed_tokens.weight": torch.randn(v, h, generator=gen),
               "model.norm.weight": torch.ones(h),
               "lm_head.weight": torch.randn(v, h, generator=gen)})
    torch.save(sd, str(xgen_dir / "pytorch_model.bin"))
    calib = {}

    def record(key):
        def compute_fisher(model_type, config, params, tokens, **kw):
            calib[key] = np.asarray(tokens)
            raise _Calibrated
        return compute_fisher

    monkeypatch.setattr(gradients, "compute_fisher", record("port"))
    monkeypatch.setattr(jgradients, "compute_fisher", record("jax"))
    args = ["fisher", "--model", str(xgen_dir), "--dataset", "wikitext2",
            "--nsamples", "3", "--seqlen", "8", "--output",
            str(xgen_dir / "grads")]
    with pytest.raises(_Calibrated):
        cli.main(args + ["--device", "cpu"])
    with pytest.raises(_Calibrated):
        jcli.main(args)
    assert calib["port"].shape == (3, 8)
    np.testing.assert_array_equal(calib["port"], calib["jax"])
