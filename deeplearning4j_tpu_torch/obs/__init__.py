"""Observability (slice 3: the metrics registry)."""

from deeplearning4j_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
