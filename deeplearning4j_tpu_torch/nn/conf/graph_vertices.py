"""Graph vertices (slice 1: ``ElementWiseVertex``).

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_vertices.py``.
"""

from __future__ import annotations

from typing import List

import torch

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType


class GraphVertex:
    """Base vertex config/runtime."""

    def get_output_type(self, *input_types: InputType) -> InputType:
        if len(input_types) != 1:
            raise ValueError(f"{type(self).__name__} expects 1 input")
        return input_types[0]

    def apply(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

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

    def apply(self, inputs):
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
