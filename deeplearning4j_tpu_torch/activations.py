"""Activation functions by name.

Counterpart of ``deeplearning4j_tpu/activations.py``: layer configs name
their activation, and :func:`get` resolves the name (case-insensitive,
underscores ignored) to a torch function, the reference's 23 names and its
parsed ``leakyrelu(alpha)`` / ``thresholdedrelu(theta)`` forms. Each
function is the reference's formula in the same operations, so autograd
gives ``jax.grad``'s gradient at the kinks too: a two-sided
``jnp.maximum``/``jnp.minimum`` tie (``relu6`` at 6, ``hardtanh`` at ±1,
``rectifiedtanh`` at 0) takes half the gradient from each side,
``jnp.clip`` is ``min(max(x, lo), hi)`` (:func:`clip`) and ``jnp.abs`` has
slope 1 at 0 (:func:`abs_`).
"""

from __future__ import annotations

import re
from typing import Callable, Union

import torch

ActivationFn = Callable[[torch.Tensor], torch.Tensor]

#: ``jax.nn.selu``'s constants
SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` as min(max(x, lo), hi), so the gradient at a bound is
    the reference's (0.5 at a tie)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``, whose gradient at 0 is 1 (``torch.abs``'s is 0)."""
    return torch.where(x >= 0, x, -x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.relu(x), torch.full_like(x, 6.0))


def leakyrelu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """``jax.nn.leaky_relu``: slope 1 at 0."""
    return torch.where(x >= 0, x, alpha * x)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """``jax.nn.elu``: the negative branch's gradient (``alpha``) at 0."""
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(torch.where(pos, torch.zeros_like(x), x)))


def selu(x: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * elu(x, SELU_ALPHA)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return clip(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def hardtanh(x: torch.Tensor) -> torch.Tensor:
    return clip(x, -1.0, 1.0)


def rationaltanh(x: torch.Tensor) -> torch.Tensor:
    """1.7159 · a rational approximation of tanh(2x/3) (the reference's
    ActivationRationalTanh)."""
    y = 2.0 * x / 3.0
    inner = torch.sign(y) * (1.0 - 1.0 / (1.0 + abs_(y) + y * y + 1.41645 * y ** 4))
    return 1.7159 * inner


def rectifiedtanh(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(torch.zeros_like(x), torch.tanh(x))


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def logsoftmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x, dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (abs_(x) + 1.0)


def cube(x: torch.Tensor) -> torch.Tensor:
    return x * x * x


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: its default is the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(softplus(x))


def thresholdedrelu(x: torch.Tensor, theta: float = 1.0) -> torch.Tensor:
    return torch.where(x > theta, x, torch.zeros_like(x))


def rrelu(x: torch.Tensor, lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0) -> torch.Tensor:
    """Randomized leaky ReLU in its deterministic form: the mean slope, as
    the reference computes it in a train step too."""
    return leakyrelu(x, (lower + upper) / 2.0)


_REGISTRY: dict = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "softplus": softplus,
    "softsign": softsign,
    "cube": cube,
    "swish": swish,
    "gelu": gelu,
    "mish": mish,
    "thresholdedrelu": thresholdedrelu,
    "rrelu": rrelu,
}


def get(name_or_fn: Union[str, ActivationFn, None]) -> ActivationFn:
    """Resolve an activation by name, or pass a callable through.
    ``leakyrelu(alpha)`` and ``thresholdedrelu(theta)`` take their parameter
    from the name."""
    if name_or_fn is None:
        return identity
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower().replace("_", "")
    m = re.fullmatch(r"(leakyrelu|thresholdedrelu)\(([-+0-9.e]+)\)", key)
    if m:
        p = float(m.group(2))
        if m.group(1) == "leakyrelu":
            return lambda x: leakyrelu(x, p)
        return lambda x: thresholdedrelu(x, p)
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation '{name_or_fn}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names() -> list:
    return sorted(_REGISTRY)
