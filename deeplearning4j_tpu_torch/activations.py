"""Activation functions by name.

Counterpart of ``deeplearning4j_tpu/activations.py``: layer configs name
their activation, and :func:`get` resolves the name (case-insensitive,
underscores ignored) to a torch function. Slice 1 ports the activations
the ResNet-50 serving path uses, plus ``sigmoid`` (the GlobalConf
default); the other names raise.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

ActivationFn = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


_REGISTRY: dict = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "sigmoid": sigmoid,
    "softmax": softmax,
}


def get(name_or_fn: Union[str, ActivationFn, None]) -> ActivationFn:
    """Resolve an activation by name, or pass a callable through."""
    if name_or_fn is None:
        return identity
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower().replace("_", "")
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown or not yet ported activation '{name_or_fn}'. "
            f"Ported: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names() -> list:
    return sorted(_REGISTRY)
