"""Training utilities: listeners (``listeners.py``), early stopping
(``earlystopping.py``), checkpoints (the zip format, validation and
retention), bundled train steps (``pipeline.py``) and the training fault
policy (``faults.py``). The names the reference's ``train`` package exports
that are ported are exported here too."""

from deeplearning4j_tpu_torch.train.faults import (  # noqa: F401
    FaultPolicy,
    TrainingDivergedError,
    fault_injection,
    latest_valid_checkpoint,
    load_latest_valid,
    prune_checkpoints,
    save_checkpoint,
    validate_checkpoint,
)
from deeplearning4j_tpu_torch.train.listeners import (  # noqa: F401
    CheckpointListener,
    CollectScoresIterationListener,
    EvaluativeListener,
    PerformanceListener,
    ScoreIterationListener,
    SleepyTrainingListener,
    TimeIterationListener,
    TrainingListener,
)
from deeplearning4j_tpu_torch.train.model_serializer import (  # noqa: F401
    ModelGuesser,
    ModelSerializer,
)
