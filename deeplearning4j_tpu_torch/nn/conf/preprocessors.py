"""Input preprocessors: shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``: the CNN <->
feed-forward, recurrent <-> feed-forward and CNN <-> recurrent pairs, a
generic reshape, a composition, the per-column batch standardizations and
Bernoulli sampling. Layouts are the reference's: FF ``(b, s)``, RNN ``(b,
T, s)``, CNN ``(b, h, w, c)`` NHWC, so a flatten is in (h, w, c) order, as
``x.reshape(b, -1)`` is in JAX, and a dense weight that follows a conv stack
lines up with the reference's row for row. A preprocessor also maps the
feature mask (:meth:`InputPreProcessor.feed_forward_mask`).

:class:`BinomialSamplingPreProcessor` draws from the counter-based noise of
``nn/conf/dropouts.py`` keyed as the reference keys its draw (its ``seed``
and a scalar of the batch), so its samples are the reference's in
distribution, not in bits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType


class InputPreProcessor:
    def pre_process(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        raise NotImplementedError

    def get_output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def feed_forward_mask(self, mask):
        """The mask that goes with the preprocessed activations (the same
        by default)."""
        return mask

    def to_dict(self) -> dict:
        return serde.generic_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "InputPreProcessor":
        actual = serde.lookup(data.get("@class", cls.__name__))
        return serde.generic_from_dict(actual, data)

    def __eq__(self, other):
        return type(self) is type(other) and serde.encode(self) == serde.encode(other)

    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


@serde.register
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """(b, h, w, c) -> (b, h*w*c), flattened in NHWC order."""

    def __init__(self, height: int = 0, width: int = 0, channels: int = 0):
        self.height, self.width, self.channels = int(height), int(width), int(channels)

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], -1)

    def get_output_type(self, input_type):
        return InputType.feed_forward(
            input_type.height * input_type.width * input_type.channels)


@serde.register
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """(b, h*w*c) -> (b, h, w, c)."""

    def __init__(self, height: int, width: int, channels: int):
        self.height, self.width, self.channels = int(height), int(width), int(channels)

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def get_output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@serde.register
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """(b, T, s) -> (b*T, s): per-timestep dense processing; the (b, T) mask
    flattens with it."""

    def pre_process(self, x, mask=None):
        return x.reshape(-1, x.shape[-1])

    def feed_forward_mask(self, mask):
        return None if mask is None else mask.reshape(-1)

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.size)


@serde.register
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """(b*T, s) -> (b, T, s); needs the timestep count."""

    def __init__(self, timesteps: Optional[int] = None):
        self.timesteps = timesteps

    def pre_process(self, x, mask=None):
        t = self.timesteps
        if t is None:
            raise ValueError("FeedForwardToRnnPreProcessor needs timesteps")
        return x.reshape(-1, t, x.shape[-1])

    def get_output_type(self, input_type):
        return InputType.recurrent(input_type.size, self.timesteps)


@serde.register
class CnnToRnnPreProcessor(InputPreProcessor):
    """(b*T, h, w, c) -> (b, T, h*w*c): per-timestep CNN activations folded
    back into a sequence (the partner of :class:`RnnToCnnPreProcessor`)."""

    def __init__(self, timesteps: Optional[int] = None):
        self.timesteps = timesteps

    def pre_process(self, x, mask=None):
        t = self.timesteps
        if t is None:
            raise ValueError("CnnToRnnPreProcessor needs timesteps")
        bt, h, w, c = x.shape
        return x.reshape(bt // t, t, h * w * c)

    def get_output_type(self, input_type):
        return InputType.recurrent(
            input_type.height * input_type.width * input_type.channels, self.timesteps)


@serde.register
class RnnToCnnPreProcessor(InputPreProcessor):
    """(b, T, s) -> (b*T, h, w, c): spatial layers applied per timestep."""

    def __init__(self, height: int, width: int, channels: int):
        self.height, self.width, self.channels = int(height), int(width), int(channels)

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0] * x.shape[1], self.height, self.width, self.channels)

    def get_output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@serde.register
class ReshapePreprocessor(InputPreProcessor):
    """Each example reshaped to ``shape``; ``output_type``: the output's
    InputType dict (else feed-forward of the shape's size)."""

    def __init__(self, shape, output_type: Optional[dict] = None):
        self.shape = list(shape)
        self.output_type = output_type

    def pre_process(self, x, mask=None):
        return x.reshape((x.shape[0],) + tuple(self.shape))

    def get_output_type(self, input_type):
        if self.output_type:
            return InputType.from_dict(self.output_type)
        return InputType.feed_forward(math.prod(self.shape))


@serde.register
class ComposableInputPreProcessor(InputPreProcessor):
    """Several preprocessors in order, the mask mapped through each."""

    def __init__(self, *preprocessors):
        if len(preprocessors) == 1 and isinstance(preprocessors[0], (list, tuple)):
            preprocessors = tuple(preprocessors[0])
        self.preprocessors = list(preprocessors)

    def pre_process(self, x, mask=None):
        for p in self.preprocessors:
            x = p.pre_process(x, mask)
            mask = p.feed_forward_mask(mask)
        return x

    def feed_forward_mask(self, mask):
        for p in self.preprocessors:
            mask = p.feed_forward_mask(mask)
        return mask

    def get_output_type(self, input_type):
        for p in self.preprocessors:
            input_type = p.get_output_type(input_type)
        return input_type


def _batch_std(x: torch.Tensor) -> torch.Tensor:
    """The per-column population std over the batch, at least 1e-8."""
    return torch.clamp(x.std(dim=0, keepdim=True, correction=0), min=1e-8)


@serde.register
class ZeroMeanPrePreProcessor(InputPreProcessor):
    """The per-column batch mean subtracted."""

    def pre_process(self, x, mask=None):
        return x - x.mean(dim=0, keepdim=True)

    def get_output_type(self, input_type):
        return input_type


@serde.register
class UnitVarianceProcessor(InputPreProcessor):
    """Divided by the per-column batch std."""

    def pre_process(self, x, mask=None):
        return x / _batch_std(x)

    def get_output_type(self, input_type):
        return input_type


@serde.register
class ZeroMeanAndUnitVariancePreProcessor(InputPreProcessor):
    """Per-column batch standardization."""

    def pre_process(self, x, mask=None):
        return (x - x.mean(dim=0, keepdim=True)) / _batch_std(x)

    def get_output_type(self, input_type):
        return input_type


@serde.register
class BinomialSamplingPreProcessor(InputPreProcessor):
    """Each activation, clipped to [0, 1], as the probability of a 1. The
    draw is keyed as the reference's: ``seed``, then a scalar of the batch
    (``int32(sum(x * 1e4))``, on the device), so that batches draw apart
    while the preprocessor stays a pure function of its input."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def pre_process(self, x, mask=None):
        from deeplearning4j_tpu_torch.nn.conf.dropouts import NoiseSource

        lim = float(2 ** 31 - 1)
        position = torch.clamp(torch.sum(x.float() * 1e4), -lim, lim).to(torch.int64)
        u = NoiseSource(self.seed, position).uniform(x.shape, x.device)
        return (u < torch.clamp(x.float(), 0.0, 1.0)).to(x.dtype)

    def get_output_type(self, input_type):
        return input_type
