"""Deadline-based dynamic batcher with bounded-queue backpressure.

Counterpart of ``deeplearning4j_tpu/serving/batcher.py``. A batch launches
when it reaches ``batch_limit`` examples or when ``max_wait_ms`` has passed
since its first request, whichever comes first. A request that would
overflow the limit stays queued and opens the next batch (no overshoot); a
full queue rejects at once with a typed :class:`ServerOverloadedError`
(HTTP 503); ``shutdown`` flips its flag before joining, drains what is
queued, and a submit that slips past the flag fails its own request, so no
caller blocks on a request nobody will serve. Completion is first-wins.

The worker thread runs the dispatch under ``torch.inference_mode()``,
which is per thread. A request may carry a feature mask for rank-3 input;
requests coalesce only with requests of the same row shape and mask shape.
The reference's chaos hooks, lock witness and per-request stage traces
come with the control-plane slice (ROADMAP § A).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics


class ServingError(RuntimeError):
    """Base of the typed serving failures."""


class ServerOverloadedError(ServingError):
    """Bounded request queue is full: shed load upstream (HTTP 503).

    ``retry_after_s`` (when the rejecting surface can estimate one) is the
    backoff hint the HTTP front-end forwards as a ``Retry-After`` header."""

    retry_after_s: Optional[float] = None


class ServerShutdownError(ServingError):
    """Request arrived at (or survived into) server shutdown."""


class RequestDeadlineExceeded(ServingError, TimeoutError):
    """The request's deadline passed before (or while) serving it."""


class InferenceRequest:
    """One submitted request: input rows and a completion event.
    ``finish``/``fail`` are idempotent and first-wins."""

    __slots__ = ("x", "mask", "deadline", "enqueued_at", "_event", "_lock",
                 "result_", "error_", "model_version")

    def __init__(self, x, mask=None, deadline: Optional[float] = None):
        self.x = np.asarray(x)
        self.mask = None if mask is None else np.asarray(mask)
        #: absolute time.monotonic() deadline, or None
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.result_: Optional[np.ndarray] = None
        self.error_: Optional[BaseException] = None
        #: version of the model snapshot that served this request
        self.model_version: Optional[int] = None

    @property
    def rows(self) -> int:
        return int(self.x.shape[0]) if self.x.ndim else 1

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic()) > self.deadline)

    def done(self) -> bool:
        return self._event.is_set()

    def finish(self, result) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self.result_ = result
            self._event.set()
            return True

    def fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self.error_ = error
            self._event.set()
            return True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the outcome. On timeout the request is failed (a
        concurrent worker completion wins) and
        :class:`RequestDeadlineExceeded` raises."""
        if not self._event.wait(timeout):
            self.fail(RequestDeadlineExceeded(
                f"request not served within timeout={timeout}s"))
            self._event.wait()  # lost the race -> a result exists; reread
        if self.error_ is not None:
            raise self.error_
        return self.result_


def make_dispatcher(infer: Callable[..., np.ndarray],
                    metrics: Optional[ServingMetrics] = None
                    ) -> Callable[[List[InferenceRequest]], None]:
    """Standard dispatch: group coalesced requests by per-row shape and mask
    shape, concatenate each group into one ``infer(x)`` call (``infer(x,
    mask)`` for a group with masks), slice the rows back to their requests.
    ``infer`` may return the rows or ``(rows, version)``
    (``InferenceEngine.infer_versioned``); the version is stamped on each
    request before it completes."""

    def signature(r: InferenceRequest):
        return r.x.shape[1:], None if r.mask is None else r.mask.shape[1:]

    def dispatch(batch: List[InferenceRequest]) -> None:
        groups: dict = {}
        for r in batch:
            groups.setdefault(signature(r), []).append(r)
        for reqs in groups.values():
            x = (reqs[0].x if len(reqs) == 1
                 else np.concatenate([r.x for r in reqs], axis=0))
            mask = (None if reqs[0].mask is None
                    else np.concatenate([r.mask for r in reqs], axis=0))
            try:
                out = infer(x) if mask is None else infer(x, mask)
            except Exception as e:  # noqa: BLE001 — routed to every request's typed failure path
                if metrics is not None:
                    metrics.record_error()
                for r in reqs:
                    r.fail(e)
                continue
            version = None
            if isinstance(out, tuple):
                out, version = out
            off = 0
            now = time.monotonic()
            for r in reqs:
                n = r.rows
                r.model_version = version  # before finish: the waiter reads it
                r.finish(out[off:off + n])
                off += n
                if metrics is not None:
                    metrics.record_latency(now - r.enqueued_at)

    return dispatch


class DynamicBatcher:
    def __init__(self, dispatch: Callable[[List[InferenceRequest]], None],
                 batch_limit: int = 32, max_wait_ms: float = 5.0,
                 queue_limit: int = 64,
                 metrics: Optional[ServingMetrics] = None):
        self._dispatch = dispatch
        self.batch_limit = max(int(batch_limit), 1)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        self._queue: "queue.Queue[InferenceRequest]" = queue.Queue(
            maxsize=max(int(queue_limit), 1))
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._shutdown = False
        # EWMA of per-dispatch wall seconds: the Retry-After estimator's
        # service-time term (until the first dispatch, a 1 s floor)
        self._dispatch_ewma_s: Optional[float] = None
        self._pending: Optional[InferenceRequest] = None  # worker-only slot
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="dl4j-torch-batcher")
        self._worker.start()

    # -- client side --------------------------------------------------------
    def queue_depth(self) -> int:
        return self._queue.qsize()

    def retry_after_s(self) -> float:
        """Backoff hint for overloaded clients: queue depth x the recent
        per-dispatch wall time, clamped to [1, 60] s."""
        per_dispatch = self._dispatch_ewma_s or 0.0
        return min(max(self._queue.qsize() * per_dispatch, 1.0), 60.0)

    def submit(self, x, mask=None, timeout: Optional[float] = None) -> InferenceRequest:
        """Enqueue a request; returns at once (block on ``req.result()``).
        ``mask``: the (b, T) feature mask of rank-3 input, or None.
        ``timeout`` sets the request's deadline, enforced while queued and
        by ``result``'s wait."""
        if self._shutdown:
            raise ServerShutdownError("server is shut down")
        req = InferenceRequest(x, mask, deadline=None if timeout is None
                               else time.monotonic() + float(timeout))
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.record_reject()
            err = ServerOverloadedError(
                f"request queue full ({self._queue.maxsize} requests); "
                "retry with backoff or scale out")
            err.retry_after_s = self.retry_after_s()
            raise err from None
        # shutdown may have drained the queue between the flag check and
        # the put: fail our own request (a no-op if the drain served it)
        if self._shutdown and req.fail(
                ServerShutdownError("server shut down while enqueuing")):
            raise ServerShutdownError("server shut down while enqueuing")
        self.metrics.record_request(req.rows)
        return req

    # -- worker side --------------------------------------------------------
    def _next(self, timeout: Optional[float]) -> Optional[InferenceRequest]:
        if self._pending is not None:
            req, self._pending = self._pending, None
            return req
        try:
            if timeout is None or timeout <= 0:
                return self._queue.get_nowait()
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _loop(self) -> None:
        with torch.inference_mode():
            while self._serve_one_batch():
                pass

    def _serve_one_batch(self) -> bool:
        """Coalesce and dispatch one batch; False once shut down and idle."""
        first = self._next(0.05)
        if first is None:
            return not self._shutdown
        batch = [first]
        total = first.rows
        # coalesce up to batch_limit or the wait window, without
        # overshooting: a request that would overflow stays pending
        window_end = time.monotonic() + self.max_wait_s
        while total < self.batch_limit:
            wait = 0.0 if self._shutdown else window_end - time.monotonic()
            nxt = self._next(wait)
            if nxt is None:
                break
            if total + nxt.rows > self.batch_limit:
                self._pending = nxt
                break
            batch.append(nxt)
            total += nxt.rows
        now = time.monotonic()
        live: List[InferenceRequest] = []
        for r in batch:
            if r.done():
                continue  # timed out caller-side / failed at shutdown
            if r.expired(now):
                self.metrics.record_deadline()
                r.fail(RequestDeadlineExceeded("request deadline passed while queued"))
                continue
            live.append(r)
        if not live:
            return True
        t_dispatch = time.monotonic()
        try:
            self._dispatch(live)
            for r in live:
                if not r.done():  # dispatcher contract violation
                    r.fail(ServingError("dispatch returned without completing request"))
        except Exception as e:  # noqa: BLE001 — routed to every request's typed failure path
            self.metrics.record_error()
            for r in live:
                r.fail(e)
        dt = time.monotonic() - t_dispatch
        self._dispatch_ewma_s = (dt if self._dispatch_ewma_s is None
                                 else 0.8 * self._dispatch_ewma_s + 0.2 * dt)
        return True

    # -- lifecycle ----------------------------------------------------------
    def shutdown(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop accepting work, serve (``drain=True``) or fail what is
        queued, and join the worker. Idempotent."""
        self._shutdown = True  # before the join: unblocks the worker's exit
        if not drain:
            self._fail_queued(ServerShutdownError("server shut down before serving request"))
        self._worker.join(timeout=timeout)
        # if the worker died or overran the join, nobody will serve the
        # leftovers: fail them
        self._fail_queued(ServerShutdownError("server shut down before serving request"))

    def _fail_queued(self, err: ServingError) -> None:
        if self._pending is not None and not self._worker.is_alive():
            self._pending.fail(err)
            self._pending = None
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            req.fail(err)
