"""Parallelism: data-parallel training over ``torch.distributed`` ranks.

Counterpart of ``deeplearning4j_tpu/parallel`` (the part ported so far):
``TrainingMesh`` (the data axis of a process group, with the cross-rank
batch statistics of train-mode BN layers), ``ParallelWrapper`` (replicated
or ZeRO-1 sharded update), the sharded-update core of ``zero.py``, and
``SharedTrainingMaster`` on the threshold-encoded gradients of
``compression.py``. The reference's other parallel runtimes (parallel
inference, tensor/pipeline/expert parallelism, multi-host) come with
ROADMAP § A3 and A7.
"""

from deeplearning4j_tpu_torch.parallel.compression import (
    EncodedUpdate,
    EncodingHandler,
    bitmap_decode,
    bitmap_encode,
    gather_and_decode,
    make_compressed_allreduce,
    threshold_decode,
    threshold_encode,
)
from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh
from deeplearning4j_tpu_torch.parallel.shared_training import SharedTrainingMaster
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.zero import (
    ShardedUpdateLayout,
    apply_sharded_updates,
    make_sharded_train_step,
)

__all__ = ["TrainingMesh", "ParallelWrapper", "ShardedUpdateLayout",
           "apply_sharded_updates", "make_sharded_train_step", "SharedTrainingMaster",
           "EncodedUpdate", "EncodingHandler", "threshold_encode", "threshold_decode",
           "gather_and_decode", "bitmap_encode", "bitmap_decode",
           "make_compressed_allreduce"]
