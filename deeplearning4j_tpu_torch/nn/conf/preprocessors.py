"""Input preprocessors: shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py`` (slice 3:
the CNN <-> feed-forward pair). Layouts are the reference's: FF ``(b, s)``,
CNN ``(b, h, w, c)`` NHWC, so a flatten is in (h, w, c) order, as
``x.reshape(b, -1)`` is in JAX, and a dense weight that follows a conv
stack lines up with the reference's row for row. The recurrent
preprocessors come with the recurrent slice (ROADMAP § A).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType


class InputPreProcessor:
    def pre_process(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        raise NotImplementedError

    def get_output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

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
