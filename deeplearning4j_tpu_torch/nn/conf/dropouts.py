"""Dropout variants, weight noise, and the noise sources they draw from.

Counterpart of ``deeplearning4j_tpu/nn/conf/dropouts.py`` (reference
``nn/conf/dropout/{Dropout,AlphaDropout,GaussianDropout,GaussianNoise}.java``
and ``nn/conf/weightnoise/{DropConnect,WeightNoise}.java``), with the same
``@class`` names and fields. A layer's ``dropout`` is a float (plain
inverted dropout on the layer's input, the drop probability) or an
:class:`IDropout`; its ``weight_noise`` an :class:`IWeightNoise`, applied to
the layer's params at forward time in training.

Each variant is a *draw* (a mask or a noise tensor, taken from a noise
source) and a deterministic *combine* of the draw with the input, so a test
can feed in a draw made elsewhere (:class:`FedNoise`).

:class:`NoiseSource` is counter-based: every draw is a pure function of the
model's seed, the step's draw position, the rank, the stream (the layer
and what in it draws) and the element's index, computed with integer
hashing in int64 tensor ops (every product below 2**63, so no overflow)
on the tensor's own device. Nothing is kept between draws: the same source
draws the same bits on the CPU and on the card, eager or inside a captured
CUDA graph (where the position is a device scalar the graph reads), and a
later recomputation (rematerialization) redraws them from the same source.
Only the float maths after the integers (a log, a cosine) may round
differently across devices.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import serde

M32 = 0xFFFFFFFF
#: the largest tensor one draw covers (element indices are 32-bit)
MAX_DRAW = 1 << 32


def _hash32(x):
    """A 32-bit integer mixer (two multiply-xorshift rounds with 31-bit odd
    multipliers) on a Python int or an int64 tensor holding values in
    [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & M32
    return x ^ (x >> 15)


def _fold(key, word):
    """``key`` (32 bits) with ``word`` (an int or an int64 tensor) mixed in."""
    return _hash32((key + _hash32(word & M32) + 0x9E3779B9) & M32)


class NoiseSource:
    """The noise of one train step: draws keyed by ``(seed, position, rank,
    path)``. ``position`` is the step's draw position (an int, or a 0-dim
    int64 tensor on the draws' device inside a captured bundle); ``rank``
    keys the draws that fall on a rank's own rows (activations) and, unless
    ``ranked_params``, not those on the replicated params (:meth:`shared`);
    ``path`` names the stream."""

    def __init__(self, seed: int, position, rank: Optional[int] = 0,
                 path: Sequence[int] = (), ranked_params: bool = False):
        self.seed, self.position, self.rank, self.path = int(seed), position, rank, tuple(path)
        self.ranked_params = bool(ranked_params)

    def child(self, i: int) -> "NoiseSource":
        """The sub-stream ``i`` (a layer of a network, a param of a layer)."""
        return NoiseSource(self.seed, self.position, self.rank, self.path + (int(i),),
                           self.ranked_params)

    def shared(self) -> "NoiseSource":
        """This stream for the params' noise: without the rank, so that
        every rank draws the same bits (a data-parallel step, which the
        reference draws once for the global batch), or with it where
        ``ranked_params`` (each rank its own, as the shared-training
        master's)."""
        if self.ranked_params:
            return self
        return NoiseSource(self.seed, self.position, None, self.path)

    def _key(self, salt: int):
        words = [self.seed & M32, (self.seed >> 32) & M32,
                 -1 if self.rank is None else self.rank, salt, *self.path]
        a, b = 0x243F6A88, 0x85A308D3
        for w in words:
            a = _fold(a, w & M32)
            b = _fold(b, w & M32)
        # the position last: everything above stays on the host
        return _fold(a, self.position), _fold(b ^ 0x5BD1E995, self.position)

    def bits(self, n: int, device, salt: int = 0) -> torch.Tensor:
        """``n`` 32-bit draws (int64 in [0, 2**32)) of this stream."""
        if n >= MAX_DRAW:
            raise ValueError(f"a draw covers fewer than 2**32 elements, got {n}")
        a, b = self._key(salt)
        h = _hash32(torch.arange(n, dtype=torch.int64, device=device) ^ a)
        return _hash32((h + b) & M32)

    def uniform(self, shape, device, salt: int = 0) -> torch.Tensor:
        """f32 in [0, 1): the top 24 bits of :meth:`bits` (exact)."""
        n = math.prod(shape)
        return ((self.bits(n, device, salt) >> 8).to(torch.float32)
                * 2.0 ** -24).reshape(tuple(shape))

    def bernoulli(self, keep: float, shape, device) -> torch.Tensor:
        """A bool mask, True with probability ``keep``."""
        return self.uniform(shape, device) < keep

    def normal(self, shape, dtype, device) -> torch.Tensor:
        """Standard normal draws (Box–Muller in f32, then ``dtype``)."""
        u1 = self.uniform(shape, device, salt=1) + 2.0 ** -25  # (0, 1)
        u2 = self.uniform(shape, device, salt=2)
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
        return z.to(dtype)


class FedNoise:
    """A noise source that hands out given draws in the order they are
    asked for (its children and :meth:`shared` are itself): a test seam to
    run the combines on draws made elsewhere. Each draw is checked against
    the shape asked for."""

    def __init__(self, draws: Sequence):
        self.draws = list(draws)
        self.taken = 0

    def child(self, i: int) -> "FedNoise":
        return self

    def shared(self) -> "FedNoise":
        return self

    def _next(self, shape, device) -> torch.Tensor:
        if self.taken >= len(self.draws):
            raise IndexError(f"FedNoise: draw {self.taken} asked for, "
                             f"{len(self.draws)} given")
        d = self.draws[self.taken]
        d = (d if isinstance(d, torch.Tensor) else torch.from_numpy(np.array(d))).to(device)
        self.taken += 1
        if tuple(d.shape) != tuple(shape):
            raise ValueError(f"FedNoise: draw of shape {tuple(d.shape)} where "
                             f"{tuple(shape)} is asked for")
        return d

    def bernoulli(self, keep: float, shape, device) -> torch.Tensor:
        return self._next(shape, device).to(torch.bool)

    def uniform(self, shape, device, salt: int = 0) -> torch.Tensor:
        return self._next(shape, device).to(torch.float32)

    def normal(self, shape, dtype, device) -> torch.Tensor:
        return self._next(shape, device).to(dtype)


# --------------------------------------------------------------------------
# input dropout
# --------------------------------------------------------------------------
class IDropout:
    """SPI (reference ``IDropout``): transform the layer input at train
    time; identity at inference. ``apply`` is ``combine(x, draw(...))``."""

    def draw(self, rng, shape, dtype, device) -> torch.Tensor:
        raise NotImplementedError

    def combine(self, x: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, x: torch.Tensor, rng) -> torch.Tensor:
        return self.combine(x, self.draw(rng, x.shape, x.dtype, x.device))

    def to_dict(self) -> dict:
        return serde.generic_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "IDropout":
        return serde.generic_from_dict(serde.lookup(data["@class"]), data)



def inverted_dropout(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """``x / keep`` where ``mask``, else 0, in x's dtype."""
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@serde.register
class Dropout(IDropout):
    """Inverted dropout; ``p`` = DROP probability."""

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def draw(self, rng, shape, dtype, device):
        return rng.bernoulli(1.0 - self.p, shape, device)

    def combine(self, x, mask):
        return inverted_dropout(x, mask, 1.0 - self.p)


@serde.register
class AlphaDropout(IDropout):
    """SELU-compatible dropout (reference ``AlphaDropout.java``): dropped
    units are set to alpha' and the result is affinely rescaled so mean and
    variance are preserved (Klambauer et al. 2017)."""

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def coefficients(self):
        """``(a, b, alpha_p)`` as the reference computes them."""
        keep = 1.0 - self.p
        alpha_p = -self._ALPHA * self._SCALE
        a = (keep + alpha_p * alpha_p * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        return a, b, alpha_p

    def draw(self, rng, shape, dtype, device):
        return rng.bernoulli(1.0 - self.p, shape, device)

    def combine(self, x, mask):
        a, b, alpha_p = self.coefficients()
        kept = torch.where(mask, x, torch.full((), alpha_p, dtype=x.dtype, device=x.device))
        return (a * kept + b).to(x.dtype)


@serde.register
class GaussianDropout(IDropout):
    """Multiplicative gaussian noise ~ N(1, rate/(1-rate)) (reference
    ``GaussianDropout.java``); mean-preserving, no inference rescale."""

    def __init__(self, rate: float = 0.5):
        self.rate = float(rate)

    def stdev(self) -> float:
        return math.sqrt(self.rate / max(1.0 - self.rate, 1e-8))

    def draw(self, rng, shape, dtype, device):
        return rng.normal(shape, dtype, device)

    def combine(self, x, z):
        return x * (1.0 + self.stdev() * z)


@serde.register
class GaussianNoise(IDropout):
    """Additive gaussian noise N(0, stddev²) (reference
    ``GaussianNoise.java``)."""

    def __init__(self, stddev: float = 0.1):
        self.stddev = float(stddev)

    def draw(self, rng, shape, dtype, device):
        return rng.normal(shape, dtype, device)

    def combine(self, x, z):
        return x + self.stddev * z


# --------------------------------------------------------------------------
# weight noise
# --------------------------------------------------------------------------
class IWeightNoise:
    """SPI (reference ``IWeightNoise``): transform a layer's param dict at
    forward time during training. Params are taken in sorted name order,
    one draw (stream ``i``) per param."""

    apply_to_biases = False

    def draw(self, rng, shape, dtype, device) -> torch.Tensor:
        raise NotImplementedError

    def combine(self, v: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_to_params(self, params: Dict[str, torch.Tensor], rng) -> Dict[str, torch.Tensor]:
        out = {}
        for i, (k, v) in enumerate(sorted(params.items())):
            if (self.apply_to_biases or self._is_weight(k)) and v.is_floating_point():
                out[k] = self.combine(v, self.draw(rng.child(i), v.shape, v.dtype, v.device))
            else:
                out[k] = v
        return out

    def to_dict(self) -> dict:
        return serde.generic_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "IWeightNoise":
        return serde.generic_from_dict(serde.lookup(data["@class"]), data)


    @staticmethod
    def _is_weight(name: str) -> bool:
        # bias conventions across the layer catalog: b, bo, b1, b2, beta
        return not name.startswith(("b", "beta"))


@serde.register
class DropConnect(IWeightNoise):
    """Drops individual WEIGHTS (not activations) with probability
    ``1 - weight_retain_prob`` (reference ``DropConnect.java``)."""

    def __init__(self, weight_retain_prob: float = 0.5, apply_to_biases: bool = False):
        self.weight_retain_prob = float(weight_retain_prob)
        self.apply_to_biases = bool(apply_to_biases)

    def draw(self, rng, shape, dtype, device):
        return rng.bernoulli(self.weight_retain_prob, shape, device)

    def combine(self, v, mask):
        return inverted_dropout(v, mask, self.weight_retain_prob)


@serde.register
class WeightNoise(IWeightNoise):
    """Additive (default) or multiplicative gaussian noise on weights
    (reference ``WeightNoise.java`` with a normal distribution)."""

    def __init__(self, stddev: float = 0.01, additive: bool = True,
                 apply_to_biases: bool = False):
        self.stddev = float(stddev)
        self.additive = bool(additive)
        self.apply_to_biases = bool(apply_to_biases)

    def draw(self, rng, shape, dtype, device):
        return rng.normal(shape, dtype, device)

    def combine(self, v, z):
        noise = self.stddev * z
        return v + noise if self.additive else v * (1.0 + noise)
