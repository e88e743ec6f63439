"""Parallelism: data-parallel training over ``torch.distributed`` ranks,
and concurrent inference.

Counterpart of ``deeplearning4j_tpu/parallel`` (the part ported so far):
``TrainingMesh`` (the data axis of a process group, with the cross-rank
batch statistics of train-mode BN layers), ``ParallelWrapper`` (replicated
or ZeRO-1 sharded update, guarded under a fault policy), the sharded-update
core of ``zero.py``, ``SharedTrainingMaster`` on the threshold-encoded
gradients of ``compression.py``, and ``ParallelInference``. The
reference's other parallel runtimes (tensor/pipeline/expert parallelism,
multi-host) come with ROADMAP § A7.
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
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh
from deeplearning4j_tpu_torch.parallel.shared_training import SharedTrainingMaster
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.zero import (
    ShardedUpdateLayout,
    apply_sharded_updates,
    make_sharded_train_step,
)

__all__ = ["TrainingMesh", "ParallelWrapper", "ParallelInference", "ShardedUpdateLayout",
           "apply_sharded_updates", "make_sharded_train_step", "SharedTrainingMaster",
           "EncodedUpdate", "EncodingHandler", "threshold_encode", "threshold_decode",
           "gather_and_decode", "bitmap_encode", "bitmap_decode",
           "make_compressed_allreduce"]
