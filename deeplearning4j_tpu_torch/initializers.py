"""Weight initialization schemes, drawn from a ``torch.Generator``.

Counterpart of ``deeplearning4j_tpu/initializers.py``, with the same scheme
names and fan-in/fan-out semantics. The draws differ from JAX's (threefry
keys there, a seeded ``torch.Generator`` here), so weights move between the
packages through :mod:`deeplearning4j_tpu_torch.interop`, never by seed.
Slice 1 ports the schemes ResNet-50 uses: ``relu`` (He) and ``xavier``, the
layer default; the others raise.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_STD = {
    "xavier": lambda fan_in, fan_out: math.sqrt(2.0 / (fan_in + fan_out)),
    "relu": lambda fan_in, fan_out: math.sqrt(2.0 / fan_in),
}


def init_weights(gen: torch.Generator, shape: Sequence[int], fan_in: float,
                 fan_out: float, scheme="xavier", dtype=torch.float32) -> torch.Tensor:
    """Draw a weight tensor on the CPU: ``xavier`` N(0, 2/(fanIn+fanOut)),
    ``relu`` N(0, 2/fanIn)."""
    key = scheme.lower() if isinstance(scheme, str) else None
    if key not in _STD:
        raise NotImplementedError(
            f"weight init scheme {scheme!r} is not ported yet (ROADMAP § A)")
    std = _STD[key](max(float(fan_in), 1.0), max(float(fan_out), 1.0))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return w.mul_(std).to(dtype)
