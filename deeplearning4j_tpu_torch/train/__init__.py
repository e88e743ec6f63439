"""Checkpoints (slice 3: the zip format and the checkpoint-validation
helpers the serving engine uses), bundled train steps (``pipeline.py``,
slice 18) and the training fault policy (``faults.py``, slice 20). The
names the reference's ``train`` package exports that are ported are
exported here too."""

from deeplearning4j_tpu_torch.train.faults import (  # noqa: F401
    FaultPolicy,
    TrainingDivergedError,
    fault_injection,
    latest_valid_checkpoint,
    validate_checkpoint,
)
from deeplearning4j_tpu_torch.train.model_serializer import (  # noqa: F401
    ModelGuesser,
    ModelSerializer,
)
