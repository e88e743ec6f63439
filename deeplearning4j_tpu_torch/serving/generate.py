"""Continuous-batching autoregressive generation engine.

Counterpart of ``deeplearning4j_tpu/serving/generate.py``
(``GenerationRequest`` ``:91``, ``_RecurrentBackend`` ``:716``,
``generation_memory_report`` ``:944``, ``GenerationEngine`` ``:994``). The
/predict path batches requests; generation batches tokens:

- the engine owns a slot slab: for a recurrent network (TextGenerationLSTM)
  each recurrent layer's carried ``(h, c)`` stacked to ``(n_slots, units)``
  on the model's device;
- a request claims a free slot, prefills its prompt padded to a bucket
  length under a mask (``prefill_bucket_lengths``), and joins the next
  decode step;
- every token step is one batched decode for all slots: the direct cell
  stack (one fused LSTM cell launch per recurrent layer) or, for a stack
  the cell path cannot take, the network's ``_forward`` over a T = 1
  sequence; then the head and the
  sampler (greedy, temperature, top-k, top-p as per-row data), and one
  device-to-host copy of the new tokens and keys;
- finished, expired or abandoned requests free their slot at token
  granularity, and the next queued request claims it while the others
  keep decoding.

A slot decoded among others gives the same tokens as the request alone:
every op of a step is row-wise (the fused cell's sums run in a fixed order
whatever the batch, and each slot samples from its own counter-based
generator seeded from the request's seed, ``models/transformer_lm.py``).

Typed failures reuse the batcher's vocabulary: queue full ->
``ServerOverloadedError`` (HTTP 503), deadline -> ``RequestDeadlineExceeded``
(504), window overflow -> ``ContextWindowExceeded`` (400), a slab over the
memory budget -> :class:`GenerationMemoryError` at build time, a hung
decode -> :class:`DecodeStalledError` (the watchdog). The KV-cache backend
of TransformerLM, speculative decoding and the shared-prefix cache come
with the TransformerLM slice (ROADMAP § A, slice 6) and raise
:class:`GenerationNotPortedError`; the reference's chaos seams, request
traces, flight events and lock witness come with the control-plane slice.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.batcher import (
    RequestDeadlineExceeded,
    ServerOverloadedError,
    ServerShutdownError,
    ServingError,
)
from deeplearning4j_tpu_torch.serving.metrics import GenerationMetrics


class GenerationMemoryError(ServingError):
    """The ``n_slots`` x ``max_length`` decode state would not fit the
    memory budget (raised when the engine is built)."""


class DecodeStalledError(ServingError):
    """A decode dispatch hung past the watchdog limit; the active requests
    were failed so that their callers unblock."""


class GenerationNotPortedError(NotImplementedError):
    """A generation feature of the reference that the port does not have
    yet (ROADMAP § A)."""


class GenerationRequest:
    """One generation request: prompt, sampling policy and streamed output.
    Completion (``finish``/``fail``) is idempotent, first wins. Tokens stream
    into a queue as they are decoded (``stream()``); ``result()`` blocks for
    the whole sequence."""

    _END = object()

    __slots__ = ("prompt", "max_new", "temperature", "top_k", "top_p", "seed",
                 "deadline", "enqueued_at", "tokens", "slot", "_event", "_lock",
                 "_stream", "result_", "error_")

    def __init__(self, prompt_ids, max_new: int, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 deadline: Optional[float] = None):
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        #: absolute time.monotonic() deadline, or None
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        #: generated token ids, in order
        self.tokens: List[int] = []
        #: slot index while decoding, else None
        self.slot: Optional[int] = None
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._stream: "queue.Queue" = queue.Queue()
        self.result_: Optional[np.ndarray] = None
        self.error_: Optional[BaseException] = None

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic()) > self.deadline)

    def done(self) -> bool:
        return self._event.is_set()

    def push_token(self, tok: int) -> None:
        self.tokens.append(int(tok))
        self._stream.put(int(tok))

    def finish(self) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self.result_ = np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])
            self._event.set()
            self._stream.put(self._END)
        return True

    def fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self.error_ = error
            self._event.set()
            self._stream.put(self._END)
        return True

    def stream(self, timeout: Optional[float] = None):
        """Yield token ids as they are decoded; raise the request's typed
        error where it failed. ``timeout`` bounds the wait for each token."""
        while True:
            try:
                item = self._stream.get(timeout=timeout)
            except queue.Empty:
                raise RequestDeadlineExceeded(f"no token within timeout={timeout}s") from None
            if item is self._END:
                if self.error_ is not None:
                    raise self.error_
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the whole sequence (prompt + generated), 1-D int32. On
        timeout the request is failed (a concurrent completion wins) and the
        typed error raises."""
        if not self._event.wait(timeout):
            self.fail(RequestDeadlineExceeded(f"request not served within timeout={timeout}s"))
            self._event.wait()
        if self.error_ is not None:
            raise self.error_
        return self.result_


# --------------------------------------------------------------------------
# the recurrent backend
# --------------------------------------------------------------------------
def _cell_decode_supported(model) -> bool:
    """True when the layer stack can decode through the direct cell path: no
    preprocessors, every recurrent layer has ``_step``, every other layer a
    per-timestep head. Anything else takes the ``_forward`` path."""
    from deeplearning4j_tpu_torch.nn.conf.layers.core import ActivationLayer, DenseLayer
    from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (
        BaseRecurrentLayer,
        RnnLossLayer,
        RnnOutputLayer,
    )

    if getattr(model.conf, "preprocessors", None):
        return False
    for layer in model.layers:
        if isinstance(layer, BaseRecurrentLayer):
            if not hasattr(layer, "_step"):
                return False
        elif not isinstance(layer, (RnnOutputLayer, RnnLossLayer, DenseLayer,
                                    ActivationLayer)):
            return False
    return True


def _logits(y: torch.Tensor) -> torch.Tensor:
    """The head's probabilities as f32 log-probabilities (the reference's
    ``log(clip(y, 1e-30))``)."""
    return torch.log(torch.clamp(y.float(), min=1e-30))


class _RecurrentBackend:
    """Incremental decode for recurrent MultiLayerNetworks: per-slot carried
    state stacked to ``(n_slots, ...)`` (the carry is the whole decode
    state, so ``max_length`` bounds the request window only).

    - cell path (wherever the stack supports it): one direct
      ``layer._step`` per recurrent layer on ``(S, d)`` activations, then
      the heads;
    - legacy path (the stacks ``_cell_decode_supported`` refuses): the
      network's ``_forward`` with carries over a T = 1 sequence.

    Both give the same tokens (asserted in the tests)."""

    kind = "recurrent"

    def __init__(self, model, n_slots: int, max_length: Optional[int],
                 prefill_buckets: Optional[Sequence[int]]):
        from deeplearning4j_tpu_torch.models.transformer_lm import prefill_bucket_lengths

        self.model = model
        self.device = model.device
        self.n_slots = int(n_slots)
        self.max_length = int(max_length) if max_length else 256
        self.buckets = prefill_bucket_lengths(
            self.max_length, prefill_buckets or getattr(model, "serving_seq_buckets", None))
        self.vocab = int(model.layers[0].n_in)
        self.cell_path = _cell_decode_supported(model)
        self.reset()
        self.cache_bytes = sum(t.numel() * t.element_size()
                               for c in self._carries if c is not None for t in c)

    def reset(self) -> None:
        """(Re)build the carried state: at construction, and after a failed
        or stalled decode."""
        with torch.inference_mode():
            self._carries = self.model._init_carries(self.n_slots)

    def bucket_for(self, prompt_len: int) -> int:
        return next(t for t in self.buckets if t >= prompt_len)

    def _one_hot(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.one_hot(ids.long(), self.vocab).to(torch.float32)

    def _cell_forward(self, p, st, carries, x):
        """The direct per-timestep stack: (S, V) one-hot -> (S, vocab) head
        output and the new carries (train=False; masks play no part at T = 1
        with every row real)."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer

        model = self.model
        if model._compute_dtype is not None:
            p = model.compute_params(p)
            x = x.to(model._compute_dtype)
        nc: List = [None] * len(model.layers)
        for idx, layer in enumerate(model.layers):
            if isinstance(layer, BaseRecurrentLayer):
                nc[idx], x = layer._step(p[idx], carries[idx], x)
            else:
                x, _ = layer.apply(p[idx], x, state=st[idx], train=False)
        return x, nc

    def prefill(self, slot: int, prompt: np.ndarray, temperature: float, top_k: int,
                top_p: float, key: np.ndarray):
        """Run ``prompt`` padded to its bucket from zero state into ``slot``;
        returns ``(first token, advanced key, bucket, first logits)``."""
        from deeplearning4j_tpu_torch.models.transformer_lm import sample_next_device

        model, dev = self.model, self.device
        tp = int(prompt.shape[0])
        tb = self.bucket_for(tp)
        ids = np.zeros((tb,), np.int64)
        ids[:tp] = prompt
        x = self._one_hot(torch.from_numpy(ids).to(dev))[None]
        mask = (torch.arange(tb, device=dev) < tp).to(torch.float32)[None]
        y, _, nc1 = model._forward(model.params_, model.state_, x, fmask=mask,
                                   carries=model._init_carries(1))
        logits = _logits(y[:, tp - 1])
        tok0, key_t = sample_next_device(logits, temperature, top_k, top_p,
                                         torch.from_numpy(key).to(dev))
        for big, row in zip(self._carries, nc1):
            if big is not None:
                for b_leaf, r_leaf in zip(big, row):
                    b_leaf[slot] = r_leaf[0]
        out = torch.cat([tok0.to(torch.int64), key_t]).cpu().numpy()
        return int(out[0]), out[1:], tb, logits[0]

    def decode(self, tokens: np.ndarray, active: np.ndarray, temperature: np.ndarray,
               top_k: np.ndarray, top_p: np.ndarray, keys: np.ndarray):
        """One token for every slot; inactive slots keep their token, key and
        state. Returns ``(tokens (S,) int32, keys (S, 2) int64)``."""
        from deeplearning4j_tpu_torch.models.transformer_lm import sample_next_rows
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import tree_map

        model, dev = self.model, self.device
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int64)).to(dev)
        act = torch.from_numpy(np.ascontiguousarray(active, np.bool_)).to(dev)
        keys_t = torch.from_numpy(np.ascontiguousarray(keys, np.int64)).to(dev)
        x = self._one_hot(toks)
        if self.cell_path:
            y, nc = self._cell_forward(model.params_, model.state_, self._carries, x)
            logits = _logits(y)
        else:
            y, _, nc = model._forward(model.params_, model.state_, x[:, None, :],
                                      carries=self._carries)
            logits = _logits(y[:, -1, :])
        nxt, nkeys = sample_next_rows(
            logits, torch.from_numpy(np.asarray(temperature, np.float32)).to(dev),
            torch.from_numpy(np.asarray(top_k, np.int64)).to(dev),
            torch.from_numpy(np.asarray(top_p, np.float32)).to(dev), keys_t)
        nxt = torch.where(act, nxt.to(torch.int64), toks)
        nkeys = torch.where(act[:, None], nkeys, keys_t)
        self._carries = [
            None if old is None else tree_map(
                lambda a, b: torch.where(act[:, None], a.to(b.dtype), b), new, old)
            for new, old in zip(nc, self._carries)]
        out = torch.cat([nxt[:, None], nkeys], dim=1).cpu().numpy()
        return out[:, 0].astype(np.int32), out[:, 1:]

    def window_check(self, prompt_len: int, max_new: int) -> None:
        from deeplearning4j_tpu_torch.models.transformer_lm import ContextWindowExceeded

        if prompt_len + max_new > self.max_length:
            raise ContextWindowExceeded(prompt_len, max_new, self.max_length)


def _is_transformer_lm(model) -> bool:
    return any(k.__name__ == "TransformerLM" for k in type(model).__mro__)


_NO_TRANSFORMER = ("TransformerLM generation (the KV-cache backend) is not ported "
                   "yet (ROADMAP § A, slice 6)")


def _pick_backend(model, n_slots, max_length, prefill_buckets) -> _RecurrentBackend:
    if _is_transformer_lm(model):
        raise GenerationNotPortedError(_NO_TRANSFORMER)
    from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer

    layers = getattr(model, "layers", None)
    if layers is not None and any(isinstance(lay, BaseRecurrentLayer) for lay in layers):
        return _RecurrentBackend(model, n_slots, max_length, prefill_buckets)
    raise TypeError(
        f"{type(model).__name__} has no incremental-decode path: expected a "
        "MultiLayerNetwork with recurrent layers (carried h/c state)")


def generation_memory_report(model, n_slots: int, max_length: Optional[int] = None) -> dict:
    """Whether the decode state fits, before it is allocated: for a
    recurrent network the layer-wise estimate (``nn/conf/memory.py``) of the
    params and of the per-slot activation state at ``n_slots`` rows."""
    if _is_transformer_lm(model):
        raise GenerationNotPortedError(_NO_TRANSFORMER)
    from deeplearning4j_tpu_torch.nn.conf.memory import memory_report_mln

    report = memory_report_mln(model.conf)
    params = report.total_params * 4
    cache = max(report.total_memory_bytes(batch_size=int(n_slots), training=False)
                - params, 0)
    return {"cache_bytes": int(cache), "param_bytes": int(params),
            "total_bytes": int(cache) + int(params), "n_slots": int(n_slots),
            "max_length": max_length}


def _device_bytes_limit(device: torch.device) -> Optional[int]:
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
class GenerationEngine:
    """Slotted continuous-batching decode engine over one model.

    One worker thread owns the device state (the slot slab, under
    ``_dev_lock``); callers touch only the bounded admission queue and their
    own :class:`GenerationRequest`. The backend reads ``model.params_`` at
    each dispatch, so a params swap of the same shapes takes effect at the
    next token.

    ``memory_limit_bytes``: a budget, ``"auto"`` (the card's memory; none
    on the CPU) or None to skip the check. ``watchdog_mult`` /
    ``watchdog_min_s``: a dispatch running longer than ``max(min_s, mult x
    the rolling step time)`` fails the active requests typed (None turns
    the watchdog off)."""

    def __init__(self, model, n_slots: int = 8, max_length: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 queue_limit: int = 64, default_timeout_s: float = 120.0,
                 metrics: Optional[GenerationMetrics] = None,
                 memory_limit_bytes="auto", watchdog_mult: Optional[float] = 20.0,
                 watchdog_min_s: float = 30.0, spec_decode_k: int = 1, prefix_cache_mb: float = 0.0):
        if int(spec_decode_k) < 1:
            raise ValueError(f"spec_decode_k must be >= 1, got {spec_decode_k}")
        if int(spec_decode_k) > 1:
            raise GenerationNotPortedError(
                "speculative decoding (spec_decode_k > 1) is not ported yet "
                "(ROADMAP § A, slice 6)")
        if prefix_cache_mb and float(prefix_cache_mb) > 0:
            raise GenerationNotPortedError(
                "the shared-prefix cache (prefix_cache_mb > 0) is not ported yet "
                "(ROADMAP § A, slice 6)")
        self.metrics = metrics if metrics is not None else GenerationMetrics()
        self.default_timeout_s = float(default_timeout_s)
        self.watchdog_mult = None if watchdog_mult is None else float(watchdog_mult)
        self.watchdog_min_s = float(watchdog_min_s)
        self._step_ewma_s: Optional[float] = None
        self._dispatch_t0: Optional[float] = None
        # the watchdog tags its trip with the dispatch it saw hung; the
        # worker honors a trip only for that dispatch
        self._dispatch_gen = 0
        self._stall_gen = -1
        self._stall_tripped = False
        #: EWMA of tokens per finished request (the Retry-After estimate)
        self._req_steps_ewma: Optional[float] = None
        self.backend = _pick_backend(model, n_slots, max_length, prefill_buckets)
        self.n_slots = self.backend.n_slots
        self.max_length = self.backend.max_length
        self.metrics.set_slots(self.n_slots)

        self.memory_report = generation_memory_report(model, self.n_slots,
                                                      self.backend.max_length)
        limit = (_device_bytes_limit(self.backend.device) if memory_limit_bytes == "auto"
                 else memory_limit_bytes)
        self.memory_report["limit_bytes"] = limit
        if limit is not None and self.memory_report["total_bytes"] > limit:
            raise GenerationMemoryError(
                f"decode state needs {self.memory_report['cache_bytes']:,} cache bytes "
                f"(+{self.memory_report['param_bytes']:,} params) for n_slots="
                f"{self.n_slots} x max_length={self.backend.max_length}, over the "
                f"{limit:,}-byte budget; lower n_slots or max_length")

        S = self.n_slots
        self._queue: "queue.Queue[GenerationRequest]" = queue.Queue(
            maxsize=max(int(queue_limit), 1))
        self._slots: List[Optional[GenerationRequest]] = [None] * S
        self._active = np.zeros((S,), bool)
        self._tokens = np.zeros((S,), np.int32)
        self._temp = np.zeros((S,), np.float32)
        self._topk = np.zeros((S,), np.int64)
        self._topp = np.zeros((S,), np.float32)
        self._keys = np.zeros((S, 2), np.int64)
        self._shutdown = False
        self._stopped = threading.Event()  # set once the worker has exited
        self._dev_lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="dl4j-torch-generate")
        self._worker.start()
        self._watchdog: Optional[threading.Thread] = None
        if self.watchdog_mult is not None:
            self._watchdog = threading.Thread(target=self._watchdog_loop, daemon=True,
                                              name="dl4j-torch-generate-watchdog")
            self._watchdog.start()

    # -- client side --------------------------------------------------------
    def submit(self, prompt_ids, max_new: int = 20, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0, seed: int = 0,
               timeout: Optional[float] = None) -> GenerationRequest:
        """Enqueue a request; returns at once (consume ``req.stream()`` or
        block on ``req.result()``). Raises the typed failures: window
        overflow, bad prompt or sampling knobs, queue full, shutdown."""
        from deeplearning4j_tpu_torch.models.transformer_lm import _validate_sampling

        if self._shutdown:
            raise ServerShutdownError("generation engine is shut down")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt.min() < 0 or prompt.max() >= self.backend.vocab:
            raise ValueError(f"prompt token ids must be in [0, {self.backend.vocab})")
        self.backend.window_check(prompt.size, int(max_new))
        _validate_sampling(temperature, top_k, top_p)
        timeout = self.default_timeout_s if timeout is None else timeout
        req = GenerationRequest(prompt, max_new, temperature, top_k, top_p, seed,
                                deadline=None if timeout is None
                                else time.monotonic() + float(timeout))
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.record_reject()
            err = ServerOverloadedError(
                f"generation queue full ({self._queue.maxsize} requests); "
                "retry with backoff or add slots")
            err.retry_after_s = self.retry_after_s()
            raise err from None
        if self._shutdown and req.fail(ServerShutdownError("engine shut down while enqueuing")):
            raise ServerShutdownError("engine shut down while enqueuing")
        self.metrics.record_request()
        return req

    def generate(self, prompt_ids, timeout: Optional[float] = None, **kwargs) -> np.ndarray:
        """Blocking convenience: submit + result."""
        req = self.submit(prompt_ids, timeout=timeout, **kwargs)
        return req.result(timeout=timeout or self.default_timeout_s)

    # -- introspection ------------------------------------------------------
    @property
    def active_slots(self) -> int:
        return int(self._active.sum())

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def inflight(self) -> int:
        """Accepted, unfinished requests: decoding slots + queued."""
        return self.active_slots + self._queue.qsize()

    def retry_after_s(self) -> float:
        """Backoff hint for overloaded clients, clamped to [1, 60] s: queued
        / n_slots waves x tokens per request x step time."""
        steps = self._req_steps_ewma or 20.0
        waves = self._queue.qsize() / max(self.n_slots, 1)
        return min(max(waves * steps * (self._step_ewma_s or 0.0), 1.0), 60.0)

    def describe(self) -> dict:
        return {
            "backend": self.backend.kind,
            "decode_cell_path": self.backend.cell_path,
            "n_slots": self.n_slots,
            "active_slots": self.active_slots,
            "max_length": self.backend.max_length,
            "prefill_buckets": list(self.backend.buckets),
            "queue_depth": self.queue_depth(),
            "spec_decode_k": 1,
            "device": str(self.backend.device),
            "memory": dict(self.memory_report),
        }

    # -- warmup -------------------------------------------------------------
    def warmup(self) -> dict:
        """One prefill per bucket and one decode step (allocator, library
        handles and the kernel build are then warm). Skipped while slots are
        active."""
        t0 = time.perf_counter()
        with self._dev_lock, torch.inference_mode():
            if self._active.any():
                return {"skipped": "slots active (already warm)"}
            key = np.zeros((2,), np.int64)
            for tb in self.backend.buckets:
                # a tb-long prompt fills bucket tb (no decode follows, so the
                # window check does not apply)
                self.backend.prefill(0, np.zeros((tb,), np.int32), 0.0, 0, 0.0, key)
            self.backend.decode(self._tokens, np.zeros_like(self._active), self._temp,
                                self._topk, self._topp, self._keys)
        return {"buckets": list(self.backend.buckets),
                "seconds": round(time.perf_counter() - t0, 3)}

    # -- worker -------------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i in range(self.n_slots) if self._slots[i] is None]

    def _admit(self) -> None:
        """Prefill queued requests into the free slots."""
        from deeplearning4j_tpu_torch.models.transformer_lm import new_key

        for slot in self._free_slots():
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req.done():
                continue  # the caller gave up while it was queued
            if req.expired():
                self.metrics.record_deadline()
                req.fail(RequestDeadlineExceeded("request deadline passed while queued"))
                continue
            t0 = time.monotonic()
            try:
                tok0, key, _bucket, _ = self.backend.prefill(
                    slot, req.prompt, req.temperature, req.top_k, req.top_p,
                    new_key(req.seed).numpy())
            except Exception as e:  # noqa: BLE001 — keep the worker alive; the caller gets e
                self.metrics.record_error()
                req.fail(e)
                continue
            self.metrics.record_prefill(time.monotonic() - t0)
            self.metrics.record_first_token()
            self._slots[slot] = req
            req.slot = slot
            self._active[slot] = True
            self._tokens[slot] = tok0
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._topp[slot] = req.top_p
            self._keys[slot] = key
            req.push_token(tok0)
            if len(req.tokens) >= req.max_new:
                self._finish_slot(slot)

    def _finish_slot(self, slot: int, error: Optional[BaseException] = None) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._active[slot] = False
        if req is None:
            return
        req.slot = None
        n_tok = len(req.tokens)
        if n_tok:
            self._req_steps_ewma = (float(n_tok) if self._req_steps_ewma is None
                                    else 0.8 * self._req_steps_ewma + 0.2 * n_tok)
        if error is not None:
            if isinstance(error, RequestDeadlineExceeded):
                self.metrics.record_deadline()
            else:
                self.metrics.record_error()
            req.fail(error)
        else:
            req.finish()
            self.metrics.record_finish(time.monotonic() - req.enqueued_at)

    def _watchdog_loop(self) -> None:
        """The decode runs on the worker thread, so a hung device call
        freezes the worker where its own recovery cannot run. The watchdog
        sees the dispatch's start stamp from outside and, past the limit,
        fails the active requests typed; the worker rebuilds the slab when
        the dispatch returns."""
        poll = min(max(self.watchdog_min_s / 4.0, 0.02), 1.0)
        while not self._stopped.wait(poll):
            gen, t0 = self._dispatch_gen, self._dispatch_t0
            if t0 is None or self._stall_tripped:
                continue
            limit = max(self.watchdog_min_s,
                        self.watchdog_mult * (self._step_ewma_s or 0.0))
            elapsed = time.monotonic() - t0
            if elapsed <= limit or self._dispatch_gen != gen or self._dispatch_t0 is None:
                continue
            self._stall_gen = gen
            self._stall_tripped = True
            if self._dispatch_gen != gen or self._dispatch_t0 is None:
                self._stall_tripped = False  # it completed meanwhile
                continue
            err = DecodeStalledError(
                f"decode dispatch stuck for {elapsed:.1f}s (limit {limit:.1f}s = "
                "max(watchdog_min_s, watchdog_mult x rolling step time)); active "
                "requests failed, worker thread still in the dispatch")
            self.metrics.record_error()
            for slot in range(self.n_slots):
                req = self._slots[slot]
                if req is not None:
                    req.fail(err)

    def _step(self) -> None:
        n_active = int(self._active.sum())
        t0 = time.monotonic()
        self._dispatch_gen += 1
        gen = self._dispatch_gen
        self._dispatch_t0 = t0
        try:
            toks, keys = self.backend.decode(self._tokens, self._active, self._temp,
                                             self._topk, self._topp, self._keys)
        except Exception as e:  # noqa: BLE001 — fail the active requests typed, keep the worker
            self._dispatch_t0 = None
            self._stall_tripped = False
            for slot in range(self.n_slots):
                if self._slots[slot] is not None:
                    self._finish_slot(slot, error=e)
            self.backend.reset()
            return
        self._dispatch_t0 = None
        dt = time.monotonic() - t0
        if self._stall_tripped:
            self._stall_tripped = False
            if self._stall_gen == gen:
                # the watchdog failed these requests while the dispatch hung:
                # its result is stale
                err = DecodeStalledError("decode dispatch exceeded the watchdog limit")
                for slot in range(self.n_slots):
                    if self._slots[slot] is not None:
                        self._finish_slot(slot, error=err)
                self.backend.reset()
                return
        self._step_ewma_s = dt if self._step_ewma_s is None else 0.8 * self._step_ewma_s + 0.2 * dt
        self.metrics.record_decode_step(dt, n_active)
        self._tokens = np.array(toks, np.int32)
        self._keys = np.array(keys, np.int64)
        now = time.monotonic()
        for slot in range(self.n_slots):
            if not self._active[slot]:
                continue
            req = self._slots[slot]
            req.push_token(int(toks[slot]))
            if len(req.tokens) >= req.max_new:
                self._finish_slot(slot)
            elif req.expired(now) or req.done():
                # done(): the caller gave up (result timeout); the slot frees
                # at token granularity either way
                self._finish_slot(slot, error=RequestDeadlineExceeded(
                    "request deadline passed mid-decode"))

    def _loop(self) -> None:
        with torch.inference_mode():
            while True:
                with self._dev_lock:
                    self._admit()
                    any_active = self._active.any()
                    if any_active:
                        self._step()
                self.metrics.set_active_slots(int(self._active.sum()))
                if any_active:
                    continue
                if self._shutdown and self._queue.empty():
                    return
                # idle: wait for work without holding the device lock, then
                # put it back and admit under the lock
                try:
                    req = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._requeue_front(req)

    def _requeue_front(self, req: GenerationRequest) -> None:
        with self._queue.mutex:
            self._queue.queue.appendleft(req)
            self._queue.not_empty.notify()

    # -- lifecycle ----------------------------------------------------------
    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting work; ``drain=True`` finishes the active and queued
        requests first, else they fail typed. Idempotent."""
        self._shutdown = True
        if not drain:
            self._fail_queued()
            with self._dev_lock:
                for slot in range(self.n_slots):
                    if self._slots[slot] is not None:
                        self._finish_slot(slot, error=ServerShutdownError(
                            "engine shut down mid-decode"))
        self._worker.join(timeout=timeout)
        self._fail_queued()
        if not self._worker.is_alive():
            self._stopped.set()
            if self._watchdog is not None:
                self._watchdog.join(timeout=timeout)

    def _fail_queued(self) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            req.fail(ServerShutdownError("engine shut down before serving request"))


__all__ = ["GenerationEngine", "GenerationRequest", "GenerationMetrics",
           "GenerationMemoryError", "DecodeStalledError", "GenerationNotPortedError",
           "generation_memory_report"]
