"""The port's HTTP front end (`squeezellm_tpu_torch.server`) over both
engines on a tiny random LLaMA on the CPU: health, greedy completions
(token-identical to a fresh engine's `run`), sampled completions and stop
tokens, streaming, concurrent requests, bad requests, speculation, and an
engine failure that fails every request and /health. The cases of the
JAX package's `tests/test_server.py`."""

import http.client
import json
import threading

import pytest
import torch

from squeezellm_tpu_torch import serving, server, synthetic
from squeezellm_tpu_torch.models import llama

CONFIG = llama.LlamaConfig(vocab_size=128, hidden_size=128,
                           intermediate_size=256, n_layers=2, n_heads=4,
                           n_kv_heads=2, max_seq=64)
ENGINES = ("dense", "paged")


def _model():
    return synthetic.quantized_llama(CONFIG, 4, seed=0, device="cpu")


def _engine(kind, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("seed", 7)
    if kind == "paged":
        return serving.PagedContinuousBatchEngine(
            _model(), n_pages=16, page_size=16, cache_dtype=torch.float32,
            **kw)
    return serving.ContinuousBatchEngine(_model(), **kw)


@pytest.fixture(scope="module", params=ENGINES)
def httpd(request):
    srv = server.serve(_engine(request.param), host="127.0.0.1", port=0,
                       window=4)
    srv.kind = request.param
    yield srv
    srv.serving_loop.shutdown()
    srv.shutdown()


def _post(srv, body, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                      timeout=120)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, json.loads(data)


def _health(srv):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                      timeout=30)
    conn.request("GET", "/health")
    r = conn.getresponse()
    out = json.loads(r.read())
    conn.close()
    return r.status, out


def _alone(kind, prompt, n, **kw):
    """The prompt's tokens from a fresh engine's run()."""
    (toks,) = _engine(kind, **kw).run([prompt], max_new_tokens=n).values()
    return [int(t) for t in toks]


def test_health(httpd):
    status, out = _health(httpd)
    assert status == 200 and out["status"] == "ok"
    assert out["free_slots"] == 2


def test_completion_greedy(httpd):
    status, out = _post(httpd, {"prompt_tokens": [1, 2, 3],
                                "max_tokens": 5})
    assert status == 200
    assert out["finish_reason"] == "length"
    assert out["tokens"] == _alone(httpd.kind, [1, 2, 3], 5)
    _, again = _post(httpd, {"prompt_tokens": [1, 2, 3], "max_tokens": 5})
    assert again["tokens"] == out["tokens"]


def test_completion_sampled_and_stop(httpd):
    status, out = _post(httpd, {"prompt_tokens": [4, 5], "max_tokens": 6,
                                "temperature": 0.9, "top_k": 20,
                                "top_p": 0.9})
    assert status == 200 and len(out["tokens"]) == 6
    # a stop token (greedy, so the continuation is known) truncates at its
    # first occurrence and reports 'stop'
    _, full = _post(httpd, {"prompt_tokens": [4, 5], "max_tokens": 6})
    full = full["tokens"]
    stop = full[1]
    status, cut = _post(httpd, {"prompt_tokens": [4, 5], "max_tokens": 6,
                                "stop": [stop]})
    assert cut["tokens"] == full[:full.index(stop) + 1]
    assert cut["finish_reason"] == "stop"


def test_streaming_chunks(httpd):
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_port,
                                      timeout=120)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt_tokens": [9, 8, 7], "max_tokens": 7,
                             "stream": True}),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.getheader("Content-Type") == "text/event-stream"
    body = r.read().decode()
    conn.close()
    events = [ln[6:] for ln in body.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    toks = [t for e in events[:-1] for t in json.loads(e)["tokens"]]
    assert len(events) > 2  # one chunk per window of 4
    _, out = _post(httpd, {"prompt_tokens": [9, 8, 7], "max_tokens": 7})
    assert toks == out["tokens"]


def test_concurrent_requests(httpd):
    results = {}

    def go(i):
        results[i] = _post(httpd, {"prompt_tokens": [i, i + 1],
                                   "max_tokens": 4})

    ts = [threading.Thread(target=go, args=(i,)) for i in range(5)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert sorted(results) == list(range(5))
    for i, (status, out) in results.items():
        assert status == 200
        assert out["tokens"] == _alone(httpd.kind, [i, i + 1], 4)
    assert _health(httpd)[1]["served"] >= 5


def test_bad_request(httpd):
    status, _ = _post(httpd, {"max_tokens": 4})
    assert status == 400
    status, _ = _post(httpd, {"prompt_tokens": [1] * 70, "max_tokens": 4})
    assert status == 400  # exceeds max_seq
    status, out = _post(httpd, {"prompt_tokens": [1, 500], "max_tokens": 4})
    assert status == 400 and "vocabulary" in out["error"]
    status, _ = _post(httpd, {"prompt_tokens": [1]}, path="/v2/other")
    assert status == 404
    assert _health(httpd)[0] == 200  # the engine lives on


@pytest.mark.parametrize("kind", ENGINES)
def test_speculative_server_matches_greedy(kind):
    """The loop takes speculative windows when the engine has them; the
    answer equals the plain engine's greedy tokens."""
    want = _alone(kind, [1, 2, 3, 1, 2, 3, 1, 2], 8)
    eng = _engine(kind, speculative=(3, 2))
    srv = server.serve(eng, port=0, window=4)
    try:
        status, out = _post(srv, {"prompt_tokens": [1, 2, 3, 1, 2, 3, 1, 2],
                                  "max_tokens": 8})
        assert status == 200 and out["tokens"] == want
        assert eng.stats["spec_windows"] > 0
    finally:
        srv.serving_loop.shutdown()
        srv.shutdown()


@pytest.mark.parametrize("kind", ENGINES)
def test_engine_failure_fails_requests_and_health(kind):
    """A fatal engine error must not hang clients: the in-flight request
    gets a 503, /health reports failed, and new submissions are refused."""
    eng = _engine(kind)
    srv = server.serve(eng, port=0, window=4)  # the warm-up runs first
    calls = {"n": 0}
    orig = eng.step_window

    def boom(window):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("synthetic device loss")
        return orig(window)

    eng.step_window = boom
    try:
        status, out = _post(srv, {"prompt_tokens": [1, 2, 3],
                                  "max_tokens": 12})
        assert status == 503 and "engine failed" in out["error"], out
        status, health = _health(srv)
        assert status == 503 and health["status"] == "failed"
        assert "synthetic device loss" in health["error"]
        status, _ = _post(srv, {"prompt_tokens": [5], "max_tokens": 2})
        assert status == 503
    finally:
        srv.serving_loop.shutdown()
        srv.shutdown()


@pytest.mark.parametrize("kind", ENGINES)
def test_engine_failure_during_admission_fails_health(kind):
    """An error of the engine while it admits a valid request (here its
    prefill) is no bad request: the client gets a 503 and /health turns
    to failed."""
    eng = _engine(kind)
    srv = server.serve(eng, port=0, window=4)

    def boom(*a, **k):
        raise RuntimeError("synthetic launch failure")

    eng._prefill = boom
    try:
        status, out = _post(srv, {"prompt_tokens": [1, 2, 3],
                                  "max_tokens": 4})
        assert status == 503 and "synthetic launch failure" in out["error"]
        status, health = _health(srv)
        assert status == 503 and health["status"] == "failed"
    finally:
        srv.serving_loop.shutdown()
        srv.shutdown()


def test_failed_warm_up_raises():
    eng = _engine("dense")

    def boom(*a, **k):
        raise RuntimeError("no device")

    eng.run = boom
    with pytest.raises(RuntimeError, match="warm-up failed.*no device"):
        server.serve(eng, port=0)


def test_many_clients_on_few_slots_under_fast_switching():
    """More clients than slots and than cores, the interpreter switching
    threads every microsecond: every request gets its own greedy tokens,
    /health counts every one, and the engine thread survives."""
    import sys

    eng = _engine("dense")
    srv = server.serve(eng, port=0, window=2)
    prompts = [[i % 7 + 1, i % 5 + 2, i % 3 + 3] for i in range(16)]
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _post(srv, {"prompt_tokens": prompts[i], "max_tokens": 3})))
            for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in ts)
        status, health = _health(srv)
    finally:
        sys.setswitchinterval(old)
        srv.serving_loop.shutdown()
        srv.shutdown()
    assert status == 200 and health["served"] == 16
    want = {tuple(p): _alone("dense", p, 3) for p in map(tuple, prompts)}
    for i, (code, out) in results.items():
        assert code == 200 and out["tokens"] == want[tuple(prompts[i])], i
