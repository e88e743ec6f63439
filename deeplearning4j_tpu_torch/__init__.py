"""deeplearning4j_tpu_torch: the PyTorch + CUDA port of deeplearning4j_tpu.

The JAX package ``deeplearning4j_tpu`` is the reference; this package
mirrors its module paths, its configuration dicts and its public layouts
(NHWC activations, HWIO conv weights), and imports nothing of it. Slice 1
serves a ComputationGraph (ResNet-50) through ``InferenceEngine``; the two
fused conv+BN+ReLU forward kernels on that path are hand-written CUDA for
Hopper (``nn/ops/csrc/fused_conv.cu``).

Entry points (``ZooModel.init``, ``ComputationGraph.init``,
``InferenceEngine``) run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise :class:`DeviceUnavailableError`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

# fp32 means fp32. The reference pins matmul precision to "highest"
# (deeplearning4j_tpu/__init__.py), so TF32 — ~3 decimal digits, and cuDNN's
# default for fp32 convolutions — stays off for matmuls and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# and a bf16 matmul accumulates in f32 to the end, as XLA's does
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

#: the device an entry point uses when the caller names none
DEFAULT_DEVICE = "cuda"


class DeviceUnavailableError(RuntimeError):
    """The requested device (by default the CUDA card) is not available."""


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` (default :data:`DEFAULT_DEVICE`) as a ``torch.device``;
    raises :class:`DeviceUnavailableError` for CUDA without a card."""
    d = torch.device(DEFAULT_DEVICE if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {str(d)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return d


def _dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    if name is None:
        return None
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "float64": torch.float64}[name]
