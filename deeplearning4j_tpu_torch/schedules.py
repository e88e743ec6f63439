"""Learning-rate (and generally hyperparameter) schedules.

Counterpart of ``deeplearning4j_tpu/schedules.py``, with the same dicts.
This slice ports the fixed schedule; the others are read from a
configuration (their dicts round-trip) but raise when asked for a value.
``value_at`` returns a 0-dim f32 tensor on the CPU, which PyTorch combines
with tensors on any device as a scalar, and which rounds as the reference's
f32 scalar does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NOT_PORTED = "is not ported yet (ROADMAP § A, training slices)"


class Schedule:
    schedule_type: str = "iteration"  # or "epoch"

    def value_at(self, iteration, epoch) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} {NOT_PORTED}")

    def to_dict(self) -> dict:
        d = {"@class": type(self).__name__}
        d.update(self.__dict__)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Schedule":
        d = dict(d)
        d.pop("@schedule", None)
        name = d.pop("@class")
        cls = _SCHEDULES.get(name)
        if cls is None:
            return _UnportedSchedule(name, d)
        obj = cls.__new__(cls)
        obj.__dict__.update(d)
        return obj

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()

    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


class FixedSchedule(Schedule):
    def __init__(self, value: float):
        self.value = float(value)
        self.schedule_type = "iteration"

    def value_at(self, iteration, epoch) -> torch.Tensor:
        return torch.tensor(self.value, dtype=torch.float32)


class _UnportedSchedule(Schedule):
    """A reference schedule this slice does not compute (Exponential, Step,
    Warmup, ...): kept as its dict, raises on :meth:`value_at`."""

    def __init__(self, name: str, fields: dict):
        self._name, self._fields = name, dict(fields)

    def value_at(self, iteration, epoch):
        raise NotImplementedError(f"{self._name} {NOT_PORTED}")

    def to_dict(self) -> dict:
        return {"@class": self._name, **self._fields}


_SCHEDULES = {"FixedSchedule": FixedSchedule}


def as_schedule(value: Union[float, Schedule, dict, None]) -> Optional[Schedule]:
    """A number becomes a :class:`FixedSchedule`; a schedule dict (as
    updater configs hold them) is decoded; a schedule passes through."""
    if value is None or isinstance(value, Schedule):
        return value
    if isinstance(value, dict):
        return Schedule.from_dict(value)
    return FixedSchedule(float(value))
