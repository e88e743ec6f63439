"""Graph vertices: the parameter-free vertices of a ComputationGraph.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_vertices.py``: Merge,
ElementWise, Subset, Stack/Unstack, L2/L2Normalize, Scale/Shift,
PoolHelper, Reshape, Preprocessor and the three time-series vertices, with
the reference's ``@class`` names and fields, so a configuration dict reads
and writes the same in either package. A vertex is a pure function of its input activations:
``apply(inputs, masks, *, train=False, rng=None)``, and
``feed_forward_mask(masks)`` gives the mask of its output. Activations are
NHWC / ``(b, T, size)``, so a merge along features is ``dim=-1`` in every
family.

The three time-series vertices read feature masks: LastTimeStep and
ReverseTimeSeries the mask of the vertex or input their ``mask_input``
names (the graph hands it over as the first mask), DuplicateToTimeSeries
the mask of its second input, whose steps it copies.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType

Masks = List[Optional[torch.Tensor]]


class GraphVertex:
    """Base vertex config/runtime."""

    def get_output_type(self, *input_types: InputType) -> InputType:
        if len(input_types) != 1:
            raise ValueError(f"{type(self).__name__} expects 1 input")
        return input_types[0]

    def apply(self, inputs: List[torch.Tensor], masks: Masks, *, train: bool = False,
              rng=None) -> torch.Tensor:
        raise NotImplementedError

    def feed_forward_mask(self, masks: Masks) -> Optional[torch.Tensor]:
        """The output's mask given the inputs' masks: the first that is set."""
        for m in masks:
            if m is not None:
                return m
        return None

    def to_dict(self) -> dict:
        return serde.generic_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "GraphVertex":
        actual = serde.lookup(data.get("@class", cls.__name__))
        return serde.generic_from_dict(actual, data)

    def __eq__(self, other):
        return type(self) is type(other) and serde.encode(self) == serde.encode(other)

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items() if v is not None}
        return f"{type(self).__name__}({fields})"


@serde.register
class MergeVertex(GraphVertex):
    """Concatenation along the feature axis (channels of NHWC, features of
    FF and RNN activations). ``require_rank``: the rank the inputs must have
    (an explicit concat axis that is the last axis only at that rank)."""

    def __init__(self, require_rank=None, **kwargs):
        super().__init__(**kwargs)
        self.require_rank = require_rank

    def get_output_type(self, *input_types: InputType) -> InputType:
        if not input_types:
            raise ValueError("MergeVertex needs >=1 input")
        first = input_types[0]
        if first.kind == "convolutional":
            for t in input_types:
                if (t.height, t.width) != (first.height, first.width):
                    raise ValueError("MergeVertex: mismatched spatial dims")
            return InputType.convolutional(first.height, first.width,
                                           sum(t.channels for t in input_types))
        if first.kind == "recurrent":
            return InputType.recurrent(sum(t.size for t in input_types), first.timesteps)
        return InputType.feed_forward(sum(t.size for t in input_types))

    def apply(self, inputs, masks, *, train=False, rng=None):
        rr = getattr(self, "require_rank", None)
        if rr is not None and inputs and inputs[0].dim() != rr:
            raise ValueError(
                f"MergeVertex: expected rank-{rr} inputs (explicit concat "
                f"axis is only last-axis at that rank); got rank {inputs[0].dim()}")
        if len(inputs) == 1:
            return inputs[0]
        return torch.cat(inputs, dim=-1)


@serde.register
class ElementWiseVertex(GraphVertex):
    """Pointwise op over N same-shaped inputs: add, subtract, product,
    average, max."""

    OPS = ("add", "subtract", "product", "average", "max")

    def __init__(self, op: str = "add"):
        op = op.lower()
        if op not in self.OPS:
            raise ValueError(f"ElementWiseVertex op must be one of {self.OPS}")
        self.op = op

    def get_output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, inputs, masks, *, train=False, rng=None):
        if self.op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            return inputs[0] - inputs[1]
        out = inputs[0]
        for x in inputs[1:]:
            if self.op in ("add", "average"):
                out = out + x
            elif self.op == "product":
                out = out * x
            else:
                out = torch.maximum(out, x)
        if self.op == "average":
            out = out / len(inputs)
        return out


@serde.register
class SubsetVertex(GraphVertex):
    """The features ``from_idx`` to ``to_idx``, both included."""

    def __init__(self, from_idx: int, to_idx: int):
        self.from_idx = int(from_idx)
        self.to_idx = int(to_idx)

    def get_output_type(self, *input_types: InputType) -> InputType:
        t = input_types[0]
        n = self.to_idx - self.from_idx + 1
        if t.kind == "recurrent":
            return InputType.recurrent(n, t.timesteps)
        if t.kind == "convolutional":
            return InputType.convolutional(t.height, t.width, n)
        return InputType.feed_forward(n)

    def apply(self, inputs, masks, *, train=False, rng=None):
        return inputs[0][..., self.from_idx:self.to_idx + 1]


@serde.register
class StackVertex(GraphVertex):
    """Concatenation along the batch axis."""

    def get_output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, inputs, masks, *, train=False, rng=None):
        return torch.cat(inputs, dim=0)

    def feed_forward_mask(self, masks):
        if all(m is None for m in masks):
            return None
        if any(m is None for m in masks):
            raise ValueError("StackVertex: all-or-none masks required")
        return torch.cat(masks, dim=0)


@serde.register
class UnstackVertex(GraphVertex):
    """Chunk ``from_idx`` of ``stack_size`` equal chunks of the batch."""

    def __init__(self, from_idx: int, stack_size: int):
        self.from_idx = int(from_idx)
        self.stack_size = int(stack_size)

    def get_output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def _chunk(self, t: torch.Tensor, what: str) -> torch.Tensor:
        if t.shape[0] % self.stack_size != 0:
            raise ValueError(
                f"UnstackVertex: {what}batch {t.shape[0]} not divisible by "
                f"stackSize {self.stack_size}")
        step = t.shape[0] // self.stack_size
        return t[self.from_idx * step:(self.from_idx + 1) * step]

    def apply(self, inputs, masks, *, train=False, rng=None):
        return self._chunk(inputs[0], "")

    def feed_forward_mask(self, masks):
        return None if masks[0] is None else self._chunk(masks[0], "mask ")


@serde.register
class L2NormalizeVertex(GraphVertex):
    """x / (||x||₂ + eps) over the non-batch axes."""

    def __init__(self, eps: float = 1e-8):
        self.eps = float(eps)

    def apply(self, inputs, masks, *, train=False, rng=None):
        x = inputs[0]
        norm = torch.sqrt(torch.sum(x * x, dim=tuple(range(1, x.dim())), keepdim=True))
        return x / (norm + self.eps)


@serde.register
class L2Vertex(GraphVertex):
    """The L2 distance of two inputs, (batch, 1): sqrt(sum (a - b)² + eps)."""

    def __init__(self, eps: float = 1e-8):
        self.eps = float(eps)

    def get_output_type(self, *input_types: InputType) -> InputType:
        return InputType.feed_forward(1)

    def apply(self, inputs, masks, *, train=False, rng=None):
        a, b = inputs
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + self.eps)


@serde.register
class ScaleVertex(GraphVertex):
    """x * scale."""

    def __init__(self, scale: float):
        self.scale = float(scale)

    def apply(self, inputs, masks, *, train=False, rng=None):
        return inputs[0] * self.scale


@serde.register
class ShiftVertex(GraphVertex):
    """x + shift."""

    def __init__(self, shift: float):
        self.shift = float(shift)

    def apply(self, inputs, masks, *, train=False, rng=None):
        return inputs[0] + self.shift


@serde.register
class PoolHelperVertex(GraphVertex):
    """A CNN activation without its first row and column (the helper of
    Caffe-style ceil-mode pooling in imported GoogLeNets)."""

    def get_output_type(self, *input_types: InputType) -> InputType:
        (it,) = input_types
        if it.kind != "convolutional":
            raise ValueError("PoolHelperVertex expects convolutional input")
        return InputType.convolutional(it.height - 1, it.width - 1, it.channels)

    def apply(self, inputs, masks, *, train=False, rng=None):
        return inputs[0][:, 1:, 1:, :]


@serde.register
class ReshapeVertex(GraphVertex):
    """Reshape to ``new_shape`` (the batch dim may be -1); ``output_type``:
    the output's InputType dict where the shape does not say it."""

    def __init__(self, new_shape: Sequence[int], output_type: Optional[dict] = None):
        self.new_shape = [int(s) for s in new_shape]
        self.output_type = output_type

    def get_output_type(self, *input_types: InputType) -> InputType:
        if self.output_type is not None:
            return InputType.from_dict(self.output_type)
        shp = self.new_shape
        if len(shp) == 2:
            return InputType.feed_forward(shp[1])
        if len(shp) == 3:
            return InputType.recurrent(shp[2], shp[1])
        if len(shp) == 4:
            return InputType.convolutional(shp[1], shp[2], shp[3])
        raise ValueError(f"Cannot infer InputType from shape {shp}")

    def apply(self, inputs, masks, *, train=False, rng=None):
        return torch.reshape(inputs[0], self.new_shape)


@serde.register
class PreprocessorVertex(GraphVertex):
    """An input preprocessor (``nn/conf/preprocessors.py``) as a vertex."""

    def __init__(self, preprocessor):
        self.preprocessor = preprocessor

    def get_output_type(self, *input_types: InputType) -> InputType:
        return self.preprocessor.get_output_type(input_types[0])

    def apply(self, inputs, masks, *, train=False, rng=None):
        return self.preprocessor.pre_process(inputs[0], masks[0])

    def feed_forward_mask(self, masks):
        return self.preprocessor.feed_forward_mask(masks[0])

    def to_dict(self) -> dict:
        return {"@class": "PreprocessorVertex", "preprocessor": serde.encode(self.preprocessor)}

    @classmethod
    def from_dict(cls, data: dict) -> "PreprocessorVertex":
        return cls(serde.decode(data["preprocessor"]))


@serde.register
class LastTimeStepVertex(GraphVertex):
    """(b, T, s) -> (b, s): each example's last valid step by the mask of
    ``mask_input`` (a network input or vertex, resolved by the graph), the
    last step without a mask. It consumes the mask."""

    def __init__(self, mask_input: Optional[str] = None):
        self.mask_input = mask_input

    def get_output_type(self, *input_types: InputType) -> InputType:
        return InputType.feed_forward(input_types[0].size)

    def apply(self, inputs, masks, *, train=False, rng=None):
        x, m = inputs[0], masks[0]
        if m is None:
            return x[:, -1, :]
        idx = torch.clamp(m.to(torch.int32).sum(dim=1) - 1, 0, x.shape[1] - 1)
        return x[torch.arange(x.shape[0], device=x.device), idx.to(torch.int64)]

    def feed_forward_mask(self, masks):
        return None


@serde.register
class DuplicateToTimeSeriesVertex(GraphVertex):
    """(b, s) -> (b, T, s), T from the second input, which the builder wires
    from ``timesteps_input``; the output's mask is that input's."""

    def __init__(self, timesteps_input: str):
        self.timesteps_input = timesteps_input

    def get_output_type(self, *input_types: InputType) -> InputType:
        ts = input_types[1].timesteps if len(input_types) > 1 else None
        return InputType.recurrent(input_types[0].size, ts)

    def apply(self, inputs, masks, *, train=False, rng=None):
        x, ref = inputs[0], inputs[1]
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[1])

    def feed_forward_mask(self, masks):
        return masks[1] if len(masks) > 1 else None


@serde.register
class ReverseTimeSeriesVertex(GraphVertex):
    """The time axis reversed; with the mask of ``mask_input``, only each
    example's valid prefix (the padded steps stay where they are)."""

    def __init__(self, mask_input: Optional[str] = None):
        self.mask_input = mask_input

    def apply(self, inputs, masks, *, train=False, rng=None):
        x, m = inputs[0], masks[0]
        if m is None:
            return torch.flip(x, dims=(1,))
        lengths = m.to(torch.int32).sum(dim=1).to(torch.int64)[:, None]
        t = torch.arange(x.shape[1], device=x.device)[None, :]
        idx = torch.where(t < lengths, lengths - 1 - t, t)
        return torch.take_along_dim(x, idx[:, :, None], dim=1)
