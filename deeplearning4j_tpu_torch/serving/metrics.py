"""Serving metrics on the metrics registry (``obs/metrics.py``): counters,
per-bucket hits and pad waste, latency quantiles from a fixed-size ring.

A copy of ``ServingMetrics`` of ``deeplearning4j_tpu/serving/metrics.py``
(``:34-218``): the same ``record_*`` methods, attribute reads and
``snapshot()`` keys for the ``/metrics`` endpoint, and the Prometheus text
of the backing registry; and ``GenerationMetrics`` (``:220-440``) for the
generation engine, without the speculative-decoding and prefix-cache
series (ROADMAP § A, slice 6). By default each instance owns a private
registry, so independent engines never double-count; ``cli serve`` hands
it the process-wide one.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry, value_rate_fn


class ServingMetrics:
    def __init__(self, ring_size: int = 2048,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        reg = self.registry
        self._requests = reg.counter(
            "serving_requests_total", "requests accepted into the queue")
        self._examples = reg.counter(
            "serving_examples_total", "rows across accepted requests")
        self._rejects = reg.counter(
            "serving_rejects_total", "ServerOverloadedError rejections")
        self._deadline = reg.counter(
            "serving_deadline_exceeded_total", "requests past their deadline")
        self._errors = reg.counter(
            "serving_errors_total", "dispatch failures propagated to callers")
        self._dispatches = reg.counter(
            "serving_dispatches_total", "device batches launched")
        self._reloads = reg.counter(
            "serving_reloads_total", "model hot reloads")
        self._latency = reg.histogram(
            "serving_latency_seconds", "request latency (ring-buffer window)",
            ring_size=ring_size)
        self.started_at = time.time()
        reg.gauge("serving_uptime_seconds", "seconds since metrics start",
                  fn=lambda: time.time() - self.started_at)
        reg.gauge(
            "serving_latency_p99_ms",
            "p99 request latency over the ring window, milliseconds "
            "(0 before any request) — the latency-SLO alert input",
            fn=lambda: round((self.latency_quantile(0.99) or 0.0) * 1e3, 3))

    # -- recording ----------------------------------------------------------
    def record_request(self, rows: int) -> None:
        self._requests.inc()
        self._examples.inc(int(rows))

    def record_reject(self) -> None:
        self._rejects.inc()

    def record_deadline(self) -> None:
        self._deadline.inc()

    def record_error(self) -> None:
        self._errors.inc()

    def record_dispatch(self, bucket: int,
                        real_rows: Optional[int] = None) -> None:
        """One device batch launched at ``bucket`` padded rows;
        ``real_rows`` (when the caller knows it — the engine does)
        splits the bucket's rows into real vs padding so the per-bucket
        pad-waste ratio is a first-class metric instead of a number the
        dispatch path computed and threw away."""
        self._dispatches.inc()
        lbl = {"bucket": str(int(bucket))}
        self.registry.counter(
            "serving_bucket_hits_total", "dispatches per bucket size",
            labels=lbl).inc()
        if real_rows is not None:
            real = min(max(int(real_rows), 0), int(bucket))
            self.registry.counter(
                "serving_real_samples_total",
                "real (request) rows dispatched, per bucket",
                labels=lbl).inc(real)
            self.registry.counter(
                "serving_padded_samples_total",
                "padding rows dispatched (bucket quantization waste), "
                "per bucket", labels=lbl).inc(int(bucket) - real)

    def record_reload(self) -> None:
        self._reloads.inc()

    def record_latency(self, seconds: float) -> None:
        self._latency.observe(float(seconds))

    # -- attribute-style reads (original public surface) ---------------------
    @property
    def requests(self) -> int:
        return int(self._requests.value())

    @property
    def examples(self) -> int:
        return int(self._examples.value())

    @property
    def rejects(self) -> int:
        return int(self._rejects.value())

    @property
    def deadline_exceeded(self) -> int:
        return int(self._deadline.value())

    @property
    def errors(self) -> int:
        return int(self._errors.value())

    @property
    def dispatches(self) -> int:
        return int(self._dispatches.value())

    @property
    def reloads(self) -> int:
        return int(self._reloads.value())

    @property
    def bucket_hits(self) -> Dict[int, int]:
        fam = self.registry.family_values("serving_bucket_hits_total")
        return {int(label.split("=", 1)[1]): int(v)
                for label, v in fam.items()}

    def pad_waste(self) -> Dict[int, dict]:
        """bucket → {real, padded, waste_ratio}: cumulative rows split
        into request rows vs bucket-quantization padding. waste_ratio is
        padding over total dispatched rows — the fraction of device work
        burned on padding at that bucket (the signal that says WHICH
        bucket list to retune)."""
        real = self.registry.family_values("serving_real_samples_total")
        padded = self.registry.family_values("serving_padded_samples_total")
        out: Dict[int, dict] = {}
        for label in set(real) | set(padded):
            bucket = int(label.split("=", 1)[1])
            r = int(real.get(label, 0))
            p = int(padded.get(label, 0))
            out[bucket] = {
                "real": r, "padded": p,
                "waste_ratio": round(p / (r + p), 4) if (r + p) else 0.0,
            }
        return out

    # -- reading ------------------------------------------------------------
    def latency_quantile(self, q: float) -> Optional[float]:
        """q in [0, 1] over the ring window; None before any request."""
        return self._latency.quantile(q)

    def snapshot(self, queue_depth: Optional[int] = None) -> dict:
        """One JSON-ready dict for the /metrics endpoint (keys unchanged
        from the pre-registry implementation)."""
        window = self._latency.window()
        n = len(window)
        out = {
            "requests": self.requests,
            "examples": self.examples,
            "rejects": self.rejects,
            "deadline_exceeded": self.deadline_exceeded,
            "errors": self.errors,
            "dispatches": self.dispatches,
            "reloads": self.reloads,
            "bucket_hits": {str(k): v
                            for k, v in sorted(self.bucket_hits.items())},
            "pad_waste": {str(k): v
                          for k, v in sorted(self.pad_waste().items())},
            "uptime_s": round(time.time() - self.started_at, 3),
            "latency_window": n,
        }
        for name, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
            out[f"latency_{name}_ms"] = (
                None if n == 0
                else round(window[min(int(q * n), n - 1)] * 1e3, 3))
        if queue_depth is not None:
            out["queue_depth"] = int(queue_depth)
            self.registry.gauge("serving_queue_depth",
                                "pending requests in the batcher queue"
                                ).set(int(queue_depth))
        return out

    def prometheus_text(self, queue_depth: Optional[int] = None) -> str:
        """Prometheus text exposition of the backing registry."""
        if queue_depth is not None:
            self.registry.gauge("serving_queue_depth",
                                "pending requests in the batcher queue"
                                ).set(int(queue_depth))
        return self.registry.prometheus_text()


class GenerationMetrics:
    """The generation engine's metrics (``serving/generate.py``): requests,
    rejects, deadlines, errors, tokens, prefills and decode steps with their
    wall seconds (the prefill/decode split), slot occupancy, request
    latency, and ``generation_tokens_per_sec`` (the scrape-to-scrape rate
    of the token counter)."""

    def __init__(self, ring_size: int = 2048,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        reg = self.registry
        self._requests = reg.counter(
            "generation_requests_total", "generation requests accepted into the queue")
        self._rejects = reg.counter(
            "generation_rejects_total",
            "generation requests rejected (queue full / invalid window)")
        self._deadline = reg.counter(
            "generation_deadline_total",
            "generation requests past their deadline (queued or mid-decode)")
        self._errors = reg.counter(
            "generation_errors_total", "generation failures propagated to callers")
        self._tokens = reg.counter(
            "generation_tokens_total", "tokens generated across requests")
        self._prefills = reg.counter(
            "generation_prefills_total", "prompt prefills (slot claims)")
        self._decode_steps = reg.counter(
            "generation_decode_steps_total",
            "batched decode dispatches (one per token for ALL slots)")
        self._prefill_s = reg.counter(
            "generation_prefill_seconds_total", "wall seconds spent in prompt prefill")
        self._decode_s = reg.counter(
            "generation_decode_seconds_total",
            "wall seconds spent in batched decode steps")
        self._latency = reg.histogram(
            "generation_request_seconds",
            "end-to-end request latency (ring-buffer window)", ring_size=ring_size)
        self._slots = reg.gauge("generation_slots", "decode slots in the engine")
        self._active = reg.gauge("generation_active_slots", "slots currently decoding")
        reg.gauge("generation_tokens_per_sec",
                  "generated tokens/sec (scrape-to-scrape rate)",
                  fn=value_rate_fn(lambda: self._tokens.value()))
        self.started_at = time.time()

    # -- recording ----------------------------------------------------------
    def set_slots(self, n: int) -> None:
        self._slots.set(int(n))

    def set_active_slots(self, n: int) -> None:
        self._active.set(int(n))

    def record_request(self) -> None:
        self._requests.inc()

    def record_reject(self) -> None:
        self._rejects.inc()

    def record_deadline(self) -> None:
        self._deadline.inc()

    def record_error(self) -> None:
        self._errors.inc()

    def record_prefill(self, seconds: float) -> None:
        self._prefills.inc()
        self._prefill_s.inc(float(seconds))

    def record_decode_step(self, seconds: float, tokens: int) -> None:
        self._decode_steps.inc()
        self._decode_s.inc(float(seconds))
        if tokens:
            self._tokens.inc(int(tokens))

    def record_first_token(self) -> None:
        self._tokens.inc()

    def record_finish(self, latency_seconds: float) -> None:
        self._latency.observe(float(latency_seconds))

    # -- reading ------------------------------------------------------------
    @property
    def tokens(self) -> int:
        return int(self._tokens.value())

    @property
    def requests(self) -> int:
        return int(self._requests.value())

    @property
    def rejects(self) -> int:
        return int(self._rejects.value())

    @property
    def deadline_exceeded(self) -> int:
        return int(self._deadline.value())

    @property
    def errors(self) -> int:
        return int(self._errors.value())

    def snapshot(self) -> dict:
        """JSON-ready dict merged into the server's /metrics body."""
        window = self._latency.window()
        n = len(window)
        prefill_s = self._prefill_s.value()
        decode_s = self._decode_s.value()
        out = {
            "requests": self.requests,
            "rejects": self.rejects,
            "deadline_exceeded": self.deadline_exceeded,
            "errors": self.errors,
            "tokens": self.tokens,
            "prefills": int(self._prefills.value()),
            "decode_steps": int(self._decode_steps.value()),
            "prefill_seconds": round(prefill_s, 4),
            "decode_seconds": round(decode_s, 4),
            "prefill_fraction": (round(prefill_s / (prefill_s + decode_s), 4)
                                 if (prefill_s + decode_s) > 0 else None),
            "slots": int(self._slots.value()),
            "active_slots": int(self._active.value()),
            "latency_window": n,
        }
        for name, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
            out[f"latency_{name}_ms"] = (
                None if n == 0 else round(window[min(int(q * n), n - 1)] * 1e3, 3))
        return out
