"""InputType: shape metadata flowing through configuration building.

Counterpart of ``deeplearning4j_tpu/nn/conf/input_type.py``, same layouts:
feed-forward ``(batch, size)``, recurrent ``(batch, time, size)``,
convolutional ``(batch, height, width, channels)`` (NHWC).
"""

from __future__ import annotations

from typing import Optional, Tuple


class InputType:
    KINDS = ("feedforward", "recurrent", "convolutional", "convolutional_flat")

    def __init__(self, kind: str, **dims):
        if kind not in self.KINDS:
            raise ValueError(f"bad InputType kind {kind}")
        self.kind = kind
        self.dims = dims

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("feedforward", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType("recurrent", size=int(size),
                         timesteps=None if timesteps is None else int(timesteps))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("convolutional", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        return InputType("convolutional_flat", height=int(height),
                         width=int(width), channels=int(channels))

    @property
    def size(self) -> int:
        if self.kind in ("feedforward", "recurrent"):
            return self.dims["size"]
        if self.kind == "convolutional_flat":
            return self.dims["height"] * self.dims["width"] * self.dims["channels"]
        raise ValueError(f"size undefined for {self.kind}")

    @property
    def height(self) -> int:
        return self.dims["height"]

    @property
    def width(self) -> int:
        return self.dims["width"]

    @property
    def channels(self) -> int:
        return self.dims["channels"]

    @property
    def timesteps(self) -> Optional[int]:
        return self.dims.get("timesteps")

    def shape(self, batch: int = 1) -> Tuple[int, ...]:
        """Concrete activation shape for a given batch size."""
        if self.kind == "feedforward":
            return (batch, self.size)
        if self.kind == "recurrent":
            return (batch, self.timesteps or 1, self.size)
        if self.kind == "convolutional":
            return (batch, self.height, self.width, self.channels)
        return (batch, self.size)  # convolutional_flat is stored flattened

    def to_dict(self) -> dict:
        return {"kind": self.kind, **self.dims}

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        d = dict(d)
        return InputType(d.pop("kind"), **d)

    def __eq__(self, other):
        return (isinstance(other, InputType) and self.kind == other.kind
                and self.dims == other.dims)

    def __repr__(self):
        return f"InputType.{self.kind}({self.dims})"
