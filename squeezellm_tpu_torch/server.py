"""HTTP serving front end over the continuous-batching engines.

The counterpart of the JAX package's ``server.py``: a minimal
OpenAI-completions-shaped server on the standard library, over
``serving.ContinuousBatchEngine`` or ``serving.PagedContinuousBatchEngine``:

  POST /v1/completions
      {"prompt_tokens": [1,2,3], "max_tokens": 32,
       "temperature": 0.8, "top_k": 40, "top_p": 0.95,
       "stop": [2], "stream": false}
    -> {"id": ..., "tokens": [...], "finish_reason": "length"|"stop"}
    With "stream": true the response is server-sent events, one
    `data: {"tokens": [...]}` chunk per decode window, ended by
    `data: [DONE]`.
  GET /health
    -> {"status": "ok", "free_slots": N, "served": M}

Threading: ALL device work stays on one engine thread (admission, the
step programs' capture and replays, the host syncs, the fan-out of
results); HTTP handler threads touch no tensor and exchange plain Python
objects through queues. A CUDA graph's capture fails if another thread
calls CUDA during it, and ``torch.no_grad`` holds per thread, so the
engine thread enters it itself. Before the socket accepts a request the
engine thread warms the step programs with a one-request run (their
first call captures them). The engine thread batches whatever requests
are in flight: HTTP concurrency maps onto the engine's slots. A failure of
the engine fails every pending request and turns /health to failed.

Tensor parallel (``serve --tp N``): every rank holds a TP engine
(``serving.TPContinuousBatchEngine`` or ``TPPagedContinuousBatchEngine``),
and they must make the same engine calls in the same order. Rank 0 runs
the HTTP front end and this loop; before each engine call (the warm-up,
an admission, a cancellation, a step window) its loop broadcasts the call
over a gloo process group on the CPU (``broadcast_object_list``), and the
other ranks, in :func:`follow`, make it too, in lockstep. An idle loop
broadcasts a heartbeat every ``HEARTBEAT_S`` seconds, so that a waiting
rank's broadcast never reaches its group's timeout, and the loop's end
broadcasts the stop.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import torch

from squeezellm_tpu_torch.sampling import SamplingParams

HEARTBEAT_S = 1.0  # an idle tensor-parallel loop's broadcast period


class _Pending:
    __slots__ = ("tokens", "max_tokens", "sampling", "stop", "stream",
                 "out", "rid")

    def __init__(self, tokens, max_tokens, sampling, stop, stream):
        self.tokens = tokens
        self.max_tokens = max_tokens
        self.sampling = sampling
        self.stop = stop
        self.stream = stream
        self.rid: Optional[int] = None
        self.out: "queue.Queue[Dict[str, Any]]" = queue.Queue()


class ServingLoop:
    """The engine thread: warms the engine with one request of two tokens
    (so that the step programs are captured before :meth:`start` returns
    and any client waits on them), then admits queued requests into slots,
    steps decode (or speculative) windows and fans the results out to
    each request's queue. control: on rank 0 of a tensor-parallel group,
    the gloo process group over which each engine call goes first to the
    other ranks (module docstring, :func:`follow`)."""

    def __init__(self, engine, window: int = 8, poll_s: float = 0.002,
                 control=None):
        self.engine = engine
        self.window = window
        self.poll_s = poll_s
        self.control = control
        self._sent = time.monotonic()  # the last broadcast's time
        self.pending: "queue.Queue[_Pending]" = queue.Queue()
        self.cancels: "queue.Queue[_Pending]" = queue.Queue()
        self.served = 0
        self.failed: Optional[str] = None  # fatal engine error, if any
        self._live: Dict[int, _Pending] = {}
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "ServingLoop":
        """Start the engine thread and wait for its warm-up; a warm-up
        that fails raises here."""
        self._thread.start()
        self._ready.wait()
        if self.failed:
            raise RuntimeError(f"engine warm-up failed: {self.failed}")
        return self

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def submit(self, req: _Pending) -> None:
        self.pending.put(req)

    def request_cancel(self, req: _Pending) -> None:
        """Thread-safe: the engine thread applies the cancel."""
        self.cancels.put(req)

    def _do(self, op: str, *args):
        """Make one engine call (:func:`_apply`), sent first to the other
        ranks of a tensor-parallel group."""
        if self.control is not None:
            _broadcast(self.control, (op, args))
            self._sent = time.monotonic()
        return _apply(self.engine, op, args)

    def _admit(self) -> None:
        while self.engine.free_slots():
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                return
            try:
                rid = self._do("add", req.tokens, req.max_tokens,
                               req.sampling, req.stop)
            except ValueError as e:  # the request's own fault
                req.out.put({"error": str(e)})
                continue
            except Exception:
                # the engine's fault: back in the queue, so that _run
                # fails this request with every other
                self.pending.put(req)
                raise
            req.rid = rid
            self._live[rid] = req

    def _drain_cancels(self) -> None:
        while True:
            try:
                req = self.cancels.get_nowait()
            except queue.Empty:
                return
            if req.rid is not None and req.rid in self._live:
                self._do("cancel", req.rid)
                del self._live[req.rid]

    def _run(self) -> None:
        try:
            with torch.no_grad():
                self._do("run", [[0]], 2, self.window)
                self._ready.set()
                self._run_inner()
        except Exception as e:  # a fatal engine error (OOM, device, bug)
            # fail fast but never silently: every in-flight and queued
            # request gets an error, /health reports the failure, and new
            # submissions are refused (the engine state may be corrupt)
            self.failed = f"{type(e).__name__}: {e}"
            for req in list(self._live.values()):
                req.out.put({"error": f"engine failed: {self.failed}"})
            self._live.clear()
            while True:
                try:
                    req = self.pending.get_nowait()
                except queue.Empty:
                    break
                req.out.put({"error": f"engine failed: {self.failed}"})
        finally:
            self._ready.set()
            if self.control is not None:
                try:
                    _broadcast(self.control, ("stop", ()))
                except RuntimeError:  # the group itself failed
                    pass

    def _run_inner(self) -> None:
        while not self._stop.is_set():
            self._drain_cancels()
            self._admit()
            if not self._live:
                if (self.control is not None and time.monotonic()
                        - self._sent > HEARTBEAT_S):
                    self._do("idle")
                try:
                    req = self.pending.get(timeout=self.poll_s)
                    self.pending.put(req)
                except queue.Empty:
                    pass
                continue
            res = self._do("step", self.window)
            for rid, r in res.items():
                req = self._live.get(rid)
                if req is None:
                    continue
                req.out.put({"new_tokens": r["new_tokens"],
                             "done": r["done"], "tokens": r.get("tokens")})
                if r["done"]:
                    del self._live[rid]
                    self.served += 1


def _apply(eng, op: str, args):
    """One engine call of the serving loop, by name: the warm-up run, an
    admission (-> request id), a cancellation, a step window (-> its
    results), or a heartbeat, which does nothing."""
    if op == "run":
        prompts, max_new, window = args
        return eng.run(prompts, max_new_tokens=max_new, window=window)
    if op == "add":
        tokens, max_tokens, sampling, stop = args
        return eng.add_request(tokens, max_tokens, sampling=sampling,
                               stop_tokens=stop)
    if op == "cancel":
        return eng.cancel(*args)
    if op == "step":
        return eng.step_any(*args)
    if op != "idle":
        raise ValueError(f"unknown serving op {op!r}")
    return None


def _broadcast(group, msg=None):
    """Rank 0's ``msg`` on every rank of ``group`` (a gloo group on the
    CPU); a non-zero rank passes nothing and gets rank 0's."""
    box = [msg]
    torch.distributed.broadcast_object_list(box, src=0, group=group)
    return box[0]


def follow(engine, control) -> None:
    """A non-zero rank of ``serve --tp N``: make every engine call that rank
    0's loop broadcasts over ``control``, in order, until it broadcasts the
    stop. An admission that rank 0 refused (a ValueError: the request's
    own fault) is refused here too, and skipped."""
    with torch.no_grad():
        while True:
            op, args = _broadcast(control)
            if op == "stop":
                return
            try:
                _apply(engine, op, args)
            except ValueError:
                if op != "add":
                    raise


def make_handler(loop: ServingLoop):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/health":
                self._json(404, {"error": "not found"})
            elif loop.failed:
                self._json(503, {"status": "failed", "error": loop.failed,
                                 "served": loop.served})
            else:
                self._json(200, {"status": "ok",
                                 "free_slots": loop.engine.free_slots(),
                                 "served": loop.served})

        def do_POST(self):
            if self.path != "/v1/completions":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                tokens = [int(t) for t in req["prompt_tokens"]]
                sp = None
                if float(req.get("temperature", 0.0)) > 0.0:
                    sp = SamplingParams(
                        temperature=float(req["temperature"]),
                        top_k=int(req.get("top_k", 0)),
                        top_p=float(req.get("top_p", 1.0)))
                p = _Pending(tokens, int(req.get("max_tokens", 16)), sp,
                             tuple(int(t) for t in req.get("stop", ())),
                             bool(req.get("stream", False)))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if loop.failed:
                # the engine thread is gone; nothing would drain this
                self._json(503, {"error": f"engine failed: {loop.failed}"})
                return
            loop.submit(p)
            rid = uuid.uuid4().hex[:12]
            if not p.stream:
                toks = []
                while True:
                    msg = p.out.get()
                    if "error" in msg:
                        self._json(503 if "engine failed" in msg["error"]
                                   else 400, msg)
                        return
                    toks.extend(msg["new_tokens"])
                    if msg["done"]:
                        break
                finish = ("stop" if p.stop and toks and toks[-1] in p.stop
                          else "length")
                self._json(200, {"id": rid, "tokens": toks,
                                 "finish_reason": finish})
                return
            # server-sent events: one chunk per decode window
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: str):
                payload = f"data: {data}\n\n".encode()
                self.wfile.write(f"{len(payload):x}\r\n".encode())
                self.wfile.write(payload + b"\r\n")

            try:
                while True:
                    msg = p.out.get()
                    if "error" in msg:
                        chunk(json.dumps(msg))
                        break
                    chunk(json.dumps({"id": rid,
                                      "tokens": msg["new_tokens"]}))
                    if msg["done"]:
                        break
                chunk("[DONE]")
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError, OSError):
                # the client went away mid-stream: free the slot
                loop.request_cancel(p)

    return Handler


def serve(engine, host: str = "127.0.0.1", port: int = 8000,
          window: int = 8, control=None) -> ThreadingHTTPServer:
    """Warm the engine on its thread, then start the HTTP server (not
    blocking; returns the server, whose ``serving_loop`` is the engine
    thread). port 0 takes a free port (``server_port``). Stop with
    ``.serving_loop.shutdown()`` and ``.shutdown()``. control: rank 0's
    gloo group of a tensor-parallel server (:class:`ServingLoop`), whose
    other ranks run :func:`follow`."""
    loop = ServingLoop(engine, window=window, control=control).start()
    httpd = ThreadingHTTPServer((host, port), make_handler(loop))
    httpd.serving_loop = loop
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
