"""Serving: the InferenceEngine, the dynamic batcher and the HTTP server."""

from deeplearning4j_tpu_torch.serving.batcher import (  # noqa: F401
    DynamicBatcher,
    RequestDeadlineExceeded,
    ServerOverloadedError,
    ServerShutdownError,
    ServingError,
)
from deeplearning4j_tpu_torch.serving.buckets import BucketPolicy  # noqa: F401
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine  # noqa: F401
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from deeplearning4j_tpu_torch.serving.server import InferenceServer  # noqa: F401
