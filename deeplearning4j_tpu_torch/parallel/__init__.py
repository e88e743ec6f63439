"""Parallelism: data-parallel training over ``torch.distributed`` ranks.

Counterpart of ``deeplearning4j_tpu/parallel`` (the part ported so far):
``TrainingMesh`` (the data axis of a process group), ``ParallelWrapper``
(replicated or ZeRO-1 sharded update) and the sharded-update core of
``zero.py``. The reference's other parallel runtimes (parallel inference,
shared training, tensor/pipeline/expert parallelism, multi-host) come with
ROADMAP § A3 and A7.
"""

from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.zero import (
    ShardedUpdateLayout,
    apply_sharded_updates,
    make_sharded_train_step,
)

__all__ = ["TrainingMesh", "ParallelWrapper", "ShardedUpdateLayout",
           "apply_sharded_updates", "make_sharded_train_step"]
