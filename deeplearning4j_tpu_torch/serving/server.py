"""Stdlib HTTP serving front-end: engine + dynamic batcher + listener.

Counterpart of ``deeplearning4j_tpu/serving/server.py`` (``InferenceServer``
``:125``), the single-model surface:

- ``POST /predict``      JSON ``{"inputs": [[...]], "mask": [...]?,
                         "timeout_ms": n?}`` -> ``{"outputs": [...],
                         "model_version": v}``
- ``POST /predict_npy``  raw ``.npy`` body -> ``.npy`` response
- ``POST /generate``     continuous-batching generation
                         (``serving/generate.py``) with a ``generation=``
                         engine, 409 without: JSON ``{"prompt": [ids],
                         "max_new": n, "temperature", "top_k", "top_p",
                         "seed", "timeout_ms", "stream": bool}``; streamed
                         as one ``{"token": id}`` line per token and a
                         ``{"done": true, ...}`` summary, or one JSON body
                         ``{"tokens", "sequence", "prompt_len"}``
- ``POST /reload``       hot-swap to a checkpoint (optional JSON
                         ``{"path": ..., "force": bool}``)
- ``GET  /healthz``      liveness, model version and warm state, the int8
                         report, the checkpoint fingerprint, uptime, and
                         the generation engine's state and in-flight count
- ``GET  /metrics``      counters, queue depth, per-bucket hits and pad
                         waste, latency quantiles (and the generation
                         snapshot under ``"generation"``): JSON by default,
                         Prometheus text when the client accepts
                         ``text/plain``/openmetrics or asks
                         ``?format=prometheus``

Typed failures map to transport codes as in the reference's ``_error``:
malformed input -> 400, queue-full backpressure and shutdown -> 503 with a
``Retry-After`` header, request deadline -> 504; on ``/generate`` a context-window overflow or a bad
payload -> 400. The registry router and tenants, drain, ``/alerts``,
``/trace`` and ``/debug/*`` come with later slices (ROADMAP § A) and answer
404 saying so.
"""

from __future__ import annotations

import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch.serving.batcher import (
    DynamicBatcher,
    RequestDeadlineExceeded,
    ServerOverloadedError,
    ServerShutdownError,
    make_dispatcher,
)

PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"
#: seconds a request without ``timeout_ms`` may wait for its answer
DEFAULT_TIMEOUT_S = 30.0

#: routes of the reference's server that later slices bring
NOT_PORTED_ROUTES = {
    "/drain": "drain mode (ROADMAP § A, slice 8)",
    "/alerts": "the SLO alert engine (ROADMAP § A, slice 8)",
    "/trace": "per-request traces (ROADMAP § A, slice 8)",
    "/debug/": "the debug endpoints (ROADMAP § A, slice 8)",
    "/models/": "the model registry router (ROADMAP § A, slice 8)",
}


def wants_prometheus(accept_header: str, query: str = "") -> bool:
    """An explicit ``format=`` query wins; otherwise an Accept mentioning
    text/plain or openmetrics means a Prometheus scraper."""
    fmt = parse_qs(query).get("format", [None])[0]
    if fmt is not None:
        return fmt.lower() in ("prometheus", "text")
    accept = (accept_header or "").lower()
    return "text/plain" in accept or "openmetrics" in accept


class InferenceServer:
    """Engine + batcher + HTTP listener. ``port=0`` binds an ephemeral port
    (read it back from ``server.port``). The engine decides the device."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8080,
                 batch_limit: int = 32, max_wait_ms: float = 5.0,
                 queue_limit: int = 256, generation=None):
        self.engine = engine
        self.metrics = engine.metrics
        #: the GenerationEngine behind POST /generate (None: 409)
        self.generation = generation
        # bind the socket before starting the batcher worker: a bind
        # failure must raise without leaking a polling thread
        self._httpd = ThreadingHTTPServer((host, int(port)), _make_handler(self))
        self._httpd.daemon_threads = True
        # late-bound engine lookup: tooling may wrap engine.infer_versioned
        # after construction
        self.batcher = DynamicBatcher(
            make_dispatcher(lambda x, *mask: self.engine.infer_versioned(x, *mask),
                            metrics=self.metrics),
            batch_limit=batch_limit, max_wait_ms=max_wait_ms,
            queue_limit=queue_limit, metrics=self.metrics)
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._closed = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "InferenceServer":
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="dl4j-torch-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop the listener, then drain the batcher (queued requests are
        served, not dropped). Idempotent."""
        if self._serving:  # BaseServer.shutdown deadlocks if the loop never ran
            self._httpd.shutdown()
            self._serving = False
        if not self._closed:
            self._closed = True
            self._httpd.server_close()
        self.batcher.shutdown(drain=True)
        if self.generation is not None:
            self.generation.shutdown(drain=True)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def queue_depth(self) -> int:
        return self.batcher.queue_depth()

    def predict(self, x: np.ndarray, mask=None, timeout_s: Optional[float] = None):
        """``(outputs, model_version)``; the version is the snapshot's that
        computed them. ``mask``: the (b, T) feature mask of rank-3 input."""
        timeout = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
        req = self.batcher.submit(x, mask, timeout=timeout)
        out = req.result(timeout=timeout)
        version = req.model_version
        return out, (self.engine.model_version if version is None else version)


def _make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY: with Nagle on, the body segment stalls behind the
        # peer's delayed ACK (~40 ms per response on some kernels)
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # noqa: N802 — quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str = "application/json",
                  headers: Optional[dict] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict, headers: Optional[dict] = None) -> None:
            self._send(code, json.dumps(obj).encode(), headers=headers)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0) or 0)
            return self.rfile.read(n) if n else b""

        def _error(self, e: BaseException) -> None:
            headers = None
            if isinstance(e, (ServerOverloadedError, ServerShutdownError)):
                code = 503
                hint = getattr(e, "retry_after_s", None) or 1.0
                headers = {"Retry-After": str(max(int(math.ceil(hint)), 1))}
            elif isinstance(e, RequestDeadlineExceeded):
                code = 504
            elif isinstance(e, (ValueError, KeyError, TypeError)):
                code = 400
            else:
                code = 500
            self._send_json(code, {"error": type(e).__name__, "message": str(e)},
                            headers=headers)

        def _not_ported(self, path: str) -> bool:
            for prefix, what in NOT_PORTED_ROUTES.items():
                if path == prefix or (prefix.endswith("/") and path.startswith(prefix)):
                    self._send_json(404, {"error": "NotFound", "message":
                                          f"{path}: {what} is not ported yet"})
                    return True
            return False

        def do_GET(self):  # noqa: N802
            try:
                url = urlparse(self.path)
                if url.path == "/healthz":
                    info = server.engine.describe()
                    info["snapshot_version"] = info.get("version")
                    info["uptime_s"] = round(time.time() - server.metrics.started_at, 3)
                    if server.generation is not None:
                        info["generation"] = server.generation.describe()
                        info["generation_inflight"] = server.generation.inflight()
                    self._send_json(200, {"status": "ok", **info})
                elif url.path == "/metrics":
                    depth = server.queue_depth()
                    if wants_prometheus(self.headers.get("Accept", ""), url.query):
                        self._send(200, server.metrics.prometheus_text(
                            queue_depth=depth).encode(), PROMETHEUS_CTYPE)
                    else:
                        body = server.metrics.snapshot(queue_depth=depth)
                        if server.generation is not None:
                            body["generation"] = server.generation.metrics.snapshot()
                        self._send_json(200, body)
                elif not self._not_ported(url.path):
                    self._send_json(404, {"error": "NotFound", "message": self.path})
            except Exception as e:  # noqa: BLE001 — never kill the connection thread
                self._error(e)

        def do_POST(self):  # noqa: N802
            try:
                path = urlparse(self.path).path
                if path == "/predict":
                    self._predict_json()
                elif path == "/predict_npy":
                    self._predict_npy()
                elif path == "/reload":
                    self._reload()
                elif path == "/generate":
                    self._generate()
                elif not self._not_ported(path):
                    self._send_json(404, {"error": "NotFound", "message": self.path})
            except Exception as e:  # noqa: BLE001 — mapped to the typed HTTP error response
                self._error(e)

        def _predict_json(self) -> None:
            try:
                payload = json.loads(self._body() or b"{}")
                x = np.asarray(payload["inputs"], np.float32)
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(f"bad /predict payload: {e}") from e
            try:
                mask = payload.get("mask")
                mask = None if mask is None else np.asarray(mask, np.float32)
            except (ValueError, TypeError) as e:
                raise ValueError(f"bad /predict mask: {e}") from e
            if x.ndim == 1:
                x = x[None, :]  # single example convenience
            timeout_ms = payload.get("timeout_ms")
            out, version = server.predict(
                x, timeout_s=None if timeout_ms is None else float(timeout_ms) / 1e3,
                mask=mask)
            self._send_json(200, {"outputs": np.asarray(out).tolist(),
                                  "model_version": version})

        def _generate(self) -> None:
            """Submit errors (overload, window overflow, bad knobs, shutdown)
            raise before any header is sent and map to their codes; once a
            stream has started, a failure becomes a terminal ``{"error":
            ...}`` line (the status line is already on the wire)."""
            gen = server.generation
            if gen is None:
                self._send_json(409, {
                    "error": "NoGenerationEngine",
                    "message": "server started without a generation engine "
                               "(cli serve --gen-slots N)"})
                return
            try:
                payload = json.loads(self._body() or b"{}")
                prompt = np.asarray(payload["prompt"], np.int32).reshape(-1)
                timeout_ms = payload.get("timeout_ms")
                timeout_s = None if timeout_ms is None else float(timeout_ms) / 1e3
                knobs = dict(max_new=int(payload.get("max_new", 20)),
                             temperature=float(payload.get("temperature", 0.0)),
                             top_k=int(payload.get("top_k", 0)),
                             top_p=float(payload.get("top_p", 0.0)),
                             seed=int(payload.get("seed", 0)))
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(f"bad /generate payload: {e}") from e
            req = gen.submit(prompt, timeout=timeout_s, **knobs)
            wait_s = gen.default_timeout_s if timeout_s is None else timeout_s
            if not payload.get("stream", True):
                out = req.result(timeout=wait_s)
                self._send_json(200, {"tokens": [int(t) for t in req.tokens],
                                      "sequence": out.tolist(),
                                      "prompt_len": int(prompt.size)})
                return
            # newline-delimited JSON, chunked: tokens go out as decoded
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj: dict) -> None:
                data = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            try:
                for tok in req.stream(timeout=wait_s):
                    chunk({"token": int(tok)})
                chunk({"done": True, "tokens": [int(t) for t in req.tokens],
                       "prompt_len": int(prompt.size)})
            except Exception as e:  # noqa: BLE001 — the status line is sent: a terminal chunk
                try:
                    chunk({"error": type(e).__name__, "message": str(e)})
                except OSError:
                    return  # the client went away mid-stream
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass

        def _predict_npy(self) -> None:
            body = self._body()
            try:
                x = np.load(io.BytesIO(body), allow_pickle=False)
            except (ValueError, EOFError, OSError) as e:
                raise ValueError(f"bad /predict_npy body: {e}") from e
            out, _ = server.predict(np.asarray(x, np.float32))
            buf = io.BytesIO()
            np.save(buf, np.asarray(out), allow_pickle=False)
            self._send(200, buf.getvalue(), ctype="application/x-npy")

        def _reload(self) -> None:
            body = self._body()
            try:
                payload = json.loads(body) if body else {}
            except ValueError as e:
                raise ValueError(f"bad /reload payload: {e}") from e
            try:
                result = server.engine.reload(source=payload.get("path"),
                                              force=bool(payload.get("force", False)))
            except FileNotFoundError as e:
                self._send_json(409, {"error": "FileNotFoundError", "message": str(e)})
                return
            self._send_json(200, result)

    return Handler
