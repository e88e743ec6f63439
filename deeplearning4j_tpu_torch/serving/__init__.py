"""Serving (slice 1: the single-device InferenceEngine)."""

from deeplearning4j_tpu_torch.serving.buckets import BucketPolicy  # noqa: F401
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine  # noqa: F401
