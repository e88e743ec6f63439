"""Activation functions by name.

Counterpart of ``deeplearning4j_tpu/activations.py``: layer configs name
their activation, and :func:`get` resolves the name (case-insensitive,
underscores ignored) to a torch function. The port has the activations
its served models use: ResNet-50's and VGG16's, ``sigmoid`` (the
GlobalConf default), ``tanh`` (the recurrent layers') and ``gelu`` (the
transformer blocks'); the other names raise.
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


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: its default is the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


_REGISTRY: dict = {
    "gelu": gelu,
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "sigmoid": sigmoid,
    "softmax": softmax,
    "tanh": tanh,
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
