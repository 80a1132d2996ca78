"""Dense-slot serving on the card, on a tiny LLaMA: the engine's captured
step programs against the same steps run eagerly (greedy, sampled,
speculative; f32, bf16 and int8 caches), a bf16 verify window's linear
rows bit-equal to one-row decode calls, and the HTTP server answering
with a fresh engine's tokens.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. On the card:
``python -m pytest tests/test_torch_serving_gpu.py -m gpu``."""

import http.client
import json
import threading

import pytest
import torch

from squeezellm_tpu_torch import server, serving, synthetic
from squeezellm_tpu_torch.models import fuse, llama
from squeezellm_tpu_torch.ops import decode_attn, lut_matmul, quant_linear
from squeezellm_tpu_torch.sampling import SamplingParams

pytestmark = pytest.mark.gpu

PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 1, 2], [3, 4, 5, 6], [8, 8, 1, 2],
           [7] * 12, [2, 4, 6, 8, 10], [11, 12, 13, 14], [1]]
BF16 = dict(dtype=torch.bfloat16, cache_dtype=torch.bfloat16, mode="bf16")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(dev):
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=384, n_layers=2, n_heads=4,
                            n_kv_heads=2, max_seq=128)
    return fuse.fuse_for_decode(synthetic.quantized_llama(
        cfg, 4, sparsity=0.01, topx=3, seed=3, device=dev))


@pytest.mark.parametrize("regime,how", [
    ("f32", "step"), ("f32", "window"), ("f32", "spec"), ("int8", "window"),
    ("bf16", "window"), ("bf16", "spec"), ("bf16", "sampled")])
def test_dense_engine_graphed_equals_eager(dev, regime, how):
    model = _model(dev)
    kw = dict(BF16) if regime == "bf16" else dict(
        cache_dtype="int8" if regime == "int8" else torch.float32)
    if how == "spec":
        kw["speculative"] = (4, 2)
    run = dict(max_new_tokens=10, window=8 if how == "window" else 1)
    if how == "sampled":
        run["sampling"] = SamplingParams(temperature=0.8, top_k=40,
                                         top_p=0.95)
    got = {}
    for graphed in (True, False):
        eng = serving.ContinuousBatchEngine(model, slots=4, max_seq=128,
                                            seed=5, graphs=graphed, **kw)
        k2 = (decode_attn.decode_attention_q8 if regime == "int8"
              else decode_attn.decode_attention)
        before = k2.launches
        got[graphed] = eng.run(PROMPTS, **run)
        torch.cuda.synchronize()
        assert eng._capture == graphed
        assert all(s.graph is not None for s in eng._steps.values()) == graphed
        # one K2 (K5) launch a layer a decode step, replays included, and
        # a decode step's for the one-token prompt's prefill
        assert k2.launches - before == 2 * (eng.stats["decode_steps"] + 1)
    assert got[True] == got[False]
    assert sorted(got[True]) == list(range(len(PROMPTS)))
    if regime == "f32" and how == "step":
        plain = serving.ContinuousBatchEngine(model, slots=4, max_seq=128,
                                              plain=True)
        assert plain.run(PROMPTS, max_new_tokens=10, window=1) == got[True]


@pytest.mark.parametrize("rows", [2, 5, 9, 16])
def test_bf16_window_rows_equal_one_row_decode_calls(dev, rows):
    """A verify window of up to 16 rows takes the decode step's GEMV
    (``Step.lin``), whose rows do not depend on their call: each window
    row equals the same row called alone, bit for bit, at every shape of
    a LLaMA layer (with the sidecar and the residual folded in)."""
    model = _model(dev)
    gen = torch.Generator(device=dev).manual_seed(rows)
    layer = model.layers[0]
    for lin in (layer.attn.proj["qkv"], layer.attn.proj["o"],
                layer.mlp.proj["gateup"], layer.mlp.proj["down"],
                model.lm_head.linear):
        spec, t = lin.spec, lin.tensors()
        x = torch.randn(rows, spec.in_features, generator=gen,
                        device=dev).to(torch.bfloat16)
        y0 = torch.randn(rows, spec.out_features, generator=gen,
                         device=dev).to(torch.bfloat16)
        before = dict(lut_matmul.lut_matmul.variant_launches)
        whole = quant_linear.quant_linear_apply(
            spec.quant, t, x, mode="bf16", y0=y0, decode=True)
        assert (lut_matmul.lut_matmul.variant_launches["gemv"]
                == before["gemv"] + 1)
        for r in range(rows):
            one = quant_linear.quant_linear_apply(
                spec.quant, t, x[r:r + 1], mode="bf16", y0=y0[r:r + 1],
                decode=True)
            assert torch.equal(whole[r:r + 1], one), (spec.quant, r)


def test_server_answers_on_the_card(dev):
    """The HTTP server over the bf16 dense engine: concurrent greedy
    completions equal a fresh engine's run() of each prompt; /health."""
    model = _model(dev)
    eng = serving.ContinuousBatchEngine(model, slots=4, max_seq=128, **BF16)
    srv = server.serve(eng, port=0, window=4)
    results = {}

    def go(i):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=300)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt_tokens": PROMPTS[i],
                                 "max_tokens": 8}))
        results[i] = json.loads(conn.getresponse().read())
        conn.close()

    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=60)
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.serving_loop.shutdown()
        srv.shutdown()
    assert srv.serving_loop.failed is None
    assert health["status"] == "ok" and health["served"] == 6
    for i in range(6):
        fresh = serving.ContinuousBatchEngine(model, slots=4, max_seq=128,
                                              **BF16)
        (want,) = fresh.run([PROMPTS[i]], max_new_tokens=8).values()
        assert results[i]["tokens"] == [int(t) for t in want], i
