"""ParallelInference: concurrent inference over one model.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py`` (reference
``parallelism/ParallelInference.java:35``). Three modes:

- ``sequential``: each request runs as it is on the caller's thread.
- ``batched``: concurrent requests coalesce, up to ``batch_limit`` rows,
  into one dispatch of the model's forward, through the serving stack's
  :class:`~deeplearning4j_tpu_torch.serving.batcher.DynamicBatcher` and
  :func:`~deeplearning4j_tpu_torch.serving.batcher.make_dispatcher`; each
  coalesced batch is padded to a shape bucket (:class:`~deeplearning4j_tpu_
  torch.serving.buckets.BucketPolicy`, powers of two up to ``batch_limit``
  by default) and sliced back (``slice_result``). A dispatch never exceeds
  ``batch_limit`` rows; a full queue raises the typed
  ``ServerOverloadedError`` at once; ``output(timeout=)`` bounds the wait
  (``RequestDeadlineExceeded``); ``metrics`` counts the dispatches.
- ``inplace``: ``workers`` replicas served round-robin, each under its own
  lock. Replica 0 is the caller's model; the others are its clones
  (``clone()``, on the model's device), so no replica's state is shared.

``shutdown`` is race-free: the flag flips first, then what is queued is
served, and a request that raced the drain fails with the shutdown error
instead of leaving its caller blocked; ``output`` after it raises
``RuntimeError``. An unknown mode raises ``ValueError``. The model runs
where it lives (the card for a model made with the default device).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Union

import numpy as np


def _model_output(model, x, mask=None) -> np.ndarray:
    """``model``'s output for ``x``: a ComputationGraph through its single
    output."""
    if hasattr(model, "output_single"):
        if mask is not None:
            raise NotImplementedError(
                "feature masks into a ComputationGraph are not ported yet (ROADMAP § A)")
        return model.output_single(x)
    return model.output(x, mask=mask)


class ParallelInference:
    """Inference modes (reference ``parallelism/inference/InferenceMode``):
    ``sequential``, ``batched`` (the throughput mode) and ``inplace``."""

    INFERENCE_MODE_SEQUENTIAL = "sequential"
    INFERENCE_MODE_BATCHED = "batched"
    INFERENCE_MODE_INPLACE = "inplace"

    class Builder:
        def __init__(self, model):
            self.model = model
            self._mode = ParallelInference.INFERENCE_MODE_BATCHED
            self._batch_limit = 32
            self._queue_limit = 64
            self._workers = None
            self._max_wait_ms = 2.0
            self._buckets: Union[bool, Sequence[int]] = True

        def inference_mode(self, mode: str):
            self._mode = mode
            return self

        def batch_limit(self, n: int):
            self._batch_limit = int(n)
            return self

        def queue_limit(self, n: int):
            self._queue_limit = int(n)
            return self

        def max_wait_ms(self, ms: float):
            """``batched``: how long a non-full batch waits for more requests
            before it is dispatched."""
            self._max_wait_ms = float(ms)
            return self

        def buckets(self, buckets: Union[bool, Sequence[int]]):
            """``batched`` shape buckets: True (default) pads each coalesced
            batch to a power-of-two bucket up to ``batch_limit``, False
            pads nothing, or an ascending list of batch sizes."""
            self._buckets = buckets
            return self

        def workers(self, n: int):
            """``inplace``: the number of model replicas. ``sequential`` and
            ``batched`` run one forward a dispatch and ignore it."""
            self._workers = int(n)
            return self

        def build(self) -> "ParallelInference":
            return ParallelInference(
                self.model, mode=self._mode, batch_limit=self._batch_limit,
                queue_limit=self._queue_limit, workers=self._workers,
                max_wait_ms=self._max_wait_ms, buckets=self._buckets)

    @staticmethod
    def builder(model) -> "Builder":
        return ParallelInference.Builder(model)

    def __init__(self, model, mode: str = "batched", batch_limit: int = 32,
                 queue_limit: int = 64, workers: Optional[int] = None,
                 max_wait_ms: float = 2.0, buckets: Union[bool, Sequence[int]] = True):
        if mode not in (self.INFERENCE_MODE_SEQUENTIAL, self.INFERENCE_MODE_BATCHED,
                        self.INFERENCE_MODE_INPLACE):
            raise ValueError(f"Unknown inference mode {mode!r}")
        self.model = model
        self.mode = mode
        self.batch_limit = batch_limit
        self._shutdown = False
        if mode == self.INFERENCE_MODE_INPLACE:
            n = max(int(workers or 2), 1)
            # replica 0 is the caller's model; the rest are clones, so no
            # replica's state is shared
            self._replicas = [model] + [model.clone() for _ in range(n - 1)]
            self._replica_locks = [threading.Lock() for _ in range(n)]
            self._rr = 0
            self._rr_lock = threading.Lock()
        elif mode == self.INFERENCE_MODE_BATCHED:
            from deeplearning4j_tpu_torch.serving.batcher import DynamicBatcher, make_dispatcher
            from deeplearning4j_tpu_torch.serving.buckets import BucketPolicy
            from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics

            if buckets is True:
                self._buckets = BucketPolicy(max_batch=batch_limit)
            elif buckets is False or buckets is None:
                self._buckets = None  # every coalesced size as it is
            else:
                # batch_limit unioned in: a full batch pads to it, not past it
                self._buckets = BucketPolicy(batch_buckets=buckets, max_batch=batch_limit)
            self.metrics = ServingMetrics()
            self._batcher = DynamicBatcher(
                make_dispatcher(self._bucketed_infer, metrics=self.metrics),
                batch_limit=batch_limit, max_wait_ms=max_wait_ms,
                queue_limit=queue_limit, metrics=self.metrics)

    def _bucketed_infer(self, x, mask=None) -> np.ndarray:
        """One coalesced dispatch: pad to the bucket, run the model's
        forward, slice the padding back off."""
        from deeplearning4j_tpu_torch.serving.buckets import slice_result

        x = np.asarray(x)
        t_orig = x.shape[1] if x.ndim >= 3 else None
        if self._buckets is not None:
            xp, mp, n = self._buckets.pad_batch(x, mask)
        else:
            xp, mp, n = x, mask, x.shape[0]
        self.metrics.record_dispatch(xp.shape[0], real_rows=n)
        y = _model_output(self.model, xp, mp)
        return slice_result(y, n, t_orig, xp.shape[1] if t_orig is not None else None)

    def output(self, x, mask=None, timeout: Optional[float] = None) -> np.ndarray:
        """Thread-safe blocking inference (reference ``ParallelInference.
        output``). ``timeout`` (seconds, ``batched``) bounds the wait: on
        expiry the request is abandoned and ``RequestDeadlineExceeded``
        raises. A full request queue raises ``ServerOverloadedError`` at
        once."""
        if self._shutdown:
            raise RuntimeError("ParallelInference is shut down")
        if self.mode == self.INFERENCE_MODE_SEQUENTIAL:
            return _model_output(self.model, x, mask)
        if self.mode == self.INFERENCE_MODE_INPLACE:
            with self._rr_lock:
                i = self._rr
                self._rr = (self._rr + 1) % len(self._replicas)
            with self._replica_locks[i]:
                return _model_output(self._replicas[i], x, mask)
        req = self._batcher.submit(np.asarray(x), None if mask is None else np.asarray(mask),
                                   timeout=timeout)
        return req.result(timeout=timeout)

    def shutdown(self) -> None:
        """Flip the shutdown flag first (no caller can enqueue into a dead
        queue), then drain: queued requests are served, and one that raced
        the drain fails with the shutdown error rather than blocking its
        caller."""
        self._shutdown = True
        if self.mode == self.INFERENCE_MODE_BATCHED:
            self._batcher.shutdown(drain=True)
