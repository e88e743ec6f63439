"""Observability: the metrics registry (slice 3) and the in-graph training
telemetry (``telemetry.py``, ROADMAP § A8)."""

from deeplearning4j_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from deeplearning4j_tpu_torch.obs.telemetry import (  # noqa: F401
    BundleTelemetry,
    TelemetryConf,
)
