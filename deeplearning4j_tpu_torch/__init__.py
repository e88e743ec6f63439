"""deeplearning4j_tpu_torch: the PyTorch + CUDA port of deeplearning4j_tpu.

The JAX package ``deeplearning4j_tpu`` is the reference; this package
mirrors its module paths, its configuration dicts and its public layouts
(NHWC activations, HWIO conv weights), and imports nothing of it. It serves
and trains ResNet-50, serves MultiLayerNetworks (VGG16, LeNet, int8 heads)
and recurrent networks (TextGenerationLSTM, through ``InferenceEngine`` and
the continuous-batching ``GenerationEngine``) behind ``InferenceServer`` and
``cli serve``, and serves and trains a TransformerLM (``fit_batch``); the
kernels on those paths are hand-written CUDA for Hopper (``nn/ops/csrc``).

Entry points (``ZooModel.init``, ``MultiLayerNetwork.init``,
``ComputationGraph.init``, ``InferenceEngine``) run on the CUDA card unless
the caller passes ``device="cpu"``; without a card they raise
:class:`DeviceUnavailableError`. A ``GenerationEngine`` runs where its model
lives.
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


class NotEnoughDevicesError(DeviceUnavailableError):
    """More CUDA cards were asked for than the machine has."""


def resolve_devices(n: int, device: Union[str, torch.device, None] = None) -> list:
    """``n`` devices of ``device``'s type (default :data:`DEFAULT_DEVICE`):
    the first ``n`` CUDA cards, or ``n`` CPU entries. Raises
    :class:`NotEnoughDevicesError` naming both counts when fewer than ``n``
    cards exist; never places two of the ``n`` on one card."""
    kind = torch.device(DEFAULT_DEVICE if device is None else device).type
    if kind == "cpu":
        return [torch.device("cpu")] * int(n)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise NotEnoughDevicesError(
            f"{n} workers need {n} CUDA cards, one each; this machine has {have}")
    return [torch.device("cuda", i) for i in range(int(n))]


def _dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    if name is None:
        return None
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "float64": torch.float64}[name]
