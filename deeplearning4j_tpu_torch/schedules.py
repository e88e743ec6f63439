"""Learning-rate (and generally hyperparameter) schedules.

Counterpart of ``deeplearning4j_tpu/schedules.py``, with the same ten
schedules and the same dicts (``MapSchedule`` writes its keys as strings,
``WarmupSchedule`` nests its base's dict). ``value_at(iteration, epoch)``
returns a 0-dim f32 tensor computed by the reference's f32 operations:

- from host ints (the plain and bundled steps): on the CPU, a scalar that
  PyTorch combines with tensors on any device;
- from a 0-dim device tensor (the guarded step's clock, ``good_count``):
  on that device, so that no step reads the clock back.

Two quirks of the reference are kept, because it is the oracle:
``CycleSchedule`` stores ``annealing_cycles``/``annealing_decay`` and never
reads them, and ``MapSchedule`` clips a step below its first key to the
first value.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch


def _f32(t) -> torch.Tensor:
    """``t`` (an int, a float or a 0-dim tensor) as a 0-dim f32 tensor, on
    the tensor's device."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32)
    return torch.tensor(float(t), dtype=torch.float32)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


class Schedule:
    schedule_type: str = "iteration"  # or "epoch"

    def _t(self, iteration, epoch):
        return epoch if self.schedule_type == "epoch" else iteration

    def value_at(self, iteration, epoch) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def reads_iteration(self) -> bool:
        """Whether the value follows the iteration (else only the epoch, a
        host count)."""
        return self.schedule_type != "epoch"

    def to_dict(self) -> dict:
        d = {"@class": type(self).__name__}
        d.update(self.__dict__)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Schedule":
        d = dict(d)
        d.pop("@schedule", None)
        name = d.pop("@class")
        if name not in _SCHEDULES:
            raise KeyError(f"Unknown schedule {name!r}. Known: {sorted(_SCHEDULES)}")
        cls = _SCHEDULES[name]
        if cls is MapSchedule:
            return MapSchedule(d["schedule_type"], {int(k): v for k, v in d["values"].items()})
        if cls is WarmupSchedule:
            return WarmupSchedule(d["warmup_steps"], Schedule.from_dict(d["base"]),
                                  d.get("schedule_type", "iteration"))
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

    def reads_iteration(self) -> bool:
        return False


class ExponentialSchedule(Schedule):
    """value = initial * gamma^t."""

    def __init__(self, schedule_type: str, initial_value: float, gamma: float):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.gamma = float(gamma)

    def value_at(self, iteration, epoch):
        return self.initial_value * torch.pow(self.gamma, _f32(self._t(iteration, epoch)))


class InverseSchedule(Schedule):
    """value = initial / (1 + gamma*t)^power."""

    def __init__(self, schedule_type: str, initial_value: float, gamma: float, power: float):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.gamma = float(gamma)
        self.power = float(power)

    def value_at(self, iteration, epoch):
        t = _f32(self._t(iteration, epoch))
        return self.initial_value / torch.pow(1.0 + self.gamma * t, self.power)


class PolySchedule(Schedule):
    """value = initial * (1 - t/maxIter)^power."""

    def __init__(self, schedule_type: str, initial_value: float, power: float, max_iter: int):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.power = float(power)
        self.max_iter = int(max_iter)

    def value_at(self, iteration, epoch):
        t = _f32(self._t(iteration, epoch))
        frac = _clip01(t / float(self.max_iter))
        return self.initial_value * torch.pow(1.0 - frac, self.power)


class SigmoidSchedule(Schedule):
    """value = initial / (1 + exp(-gamma*(t - stepSize)))."""

    def __init__(self, schedule_type: str, initial_value: float, gamma: float, step_size: int):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.gamma = float(gamma)
        self.step_size = int(step_size)

    def value_at(self, iteration, epoch):
        t = _f32(self._t(iteration, epoch))
        return self.initial_value / (1.0 + torch.exp(-self.gamma * (t - self.step_size)))


class StepSchedule(Schedule):
    """value = initial * decayRate^floor(t/step)."""

    def __init__(self, schedule_type: str, initial_value: float, decay_rate: float,
                 step: float):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.decay_rate = float(decay_rate)
        self.step = float(step)

    def value_at(self, iteration, epoch):
        t = _f32(self._t(iteration, epoch))
        return self.initial_value * torch.pow(self.decay_rate, torch.floor(t / self.step))


class MapSchedule(Schedule):
    """Piecewise-constant schedule from {t: value}; holds the last value. A
    value for t = 0 is required (the reference's rule)."""

    def __init__(self, schedule_type: str, values: Dict[int, float]):
        if 0 not in {int(k) for k in values}:
            raise ValueError("MapSchedule requires a value for t=0")
        self.schedule_type = schedule_type
        self.values = {int(k): float(v)
                       for k, v in sorted(values.items(), key=lambda kv: int(kv[0]))}

    def to_dict(self) -> dict:
        return {"@class": "MapSchedule", "schedule_type": self.schedule_type,
                "values": {str(k): v for k, v in self.values.items()}}

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        t = (t.to(torch.int32) if isinstance(t, torch.Tensor)
             else torch.tensor(int(t), dtype=torch.int32))
        # the value of the last key <= t (the first below it), by selects on
        # t's device: no table is copied there
        items = list(self.values.items())
        out = torch.full((), items[0][1], dtype=torch.float32, device=t.device)
        for k, v in items[1:]:
            out = torch.where(t >= k, torch.full_like(out, v), out)
        return out


class CycleSchedule(Schedule):
    """One-cycle schedule: a linear ramp from ``initial_value`` up to
    ``max_value`` over half a cycle and back down over the other half,
    repeated. ``annealing_cycles``/``annealing_decay`` are stored and, as in
    the reference, not read."""

    def __init__(self, schedule_type: str, initial_value: float, max_value: float,
                 cycle_length: int, annealing_cycles: int = 0,
                 annealing_decay: float = 0.1):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.max_value = float(max_value)
        self.cycle_length = int(cycle_length)
        self.annealing_cycles = int(annealing_cycles)
        self.annealing_decay = float(annealing_decay)

    def value_at(self, iteration, epoch):
        t = _f32(self._t(iteration, epoch))
        up = self.cycle_length / 2.0
        pos = torch.remainder(t, float(self.cycle_length))
        ramp_up = self.initial_value + (self.max_value - self.initial_value) * (pos / up)
        ramp_dn = self.max_value - (self.max_value - self.initial_value) * ((pos - up) / up)
        return torch.where(pos < up, ramp_up, ramp_dn)


class CosineSchedule(Schedule):
    """Cosine decay from ``initial`` to ``final`` over ``decay_steps``, then
    ``final``."""

    def __init__(self, initial: float, decay_steps: int, final: float = 0.0,
                 schedule_type: str = "iteration"):
        self.initial = float(initial)
        self.final = float(final)
        self.decay_steps = int(decay_steps)
        self.schedule_type = schedule_type

    def value_at(self, iteration, epoch):
        t = _f32(self._t(iteration, epoch))
        frac = _clip01(t / max(self.decay_steps, 1))
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return self.final + (self.initial - self.final) * cos


class WarmupSchedule(Schedule):
    """Linear warmup from 0 to ``base`` over ``warmup_steps``, then ``base``
    evaluated with the warmup removed from the step."""

    def __init__(self, warmup_steps: int, base: Union[float, Schedule],
                 schedule_type: str = "iteration"):
        self.warmup_steps = int(warmup_steps)
        self.base = as_schedule(base)
        self.schedule_type = schedule_type

    def value_at(self, iteration, epoch):
        t = _f32(self._t(iteration, epoch))
        shifted = torch.clamp(t - self.warmup_steps, min=0.0)
        if self.schedule_type == "epoch":
            base_val = self.base.value_at(iteration, shifted)
        else:
            base_val = self.base.value_at(shifted, epoch)
        ramp = _clip01(t / max(self.warmup_steps, 1))
        return ramp * base_val

    def reads_iteration(self) -> bool:
        return self.schedule_type != "epoch" or self.base.reads_iteration()

    def to_dict(self) -> dict:
        return {"@class": "WarmupSchedule", "warmup_steps": self.warmup_steps,
                "schedule_type": self.schedule_type, "base": self.base.to_dict()}


_SCHEDULES = {c.__name__: c for c in (
    FixedSchedule, ExponentialSchedule, InverseSchedule, PolySchedule, SigmoidSchedule,
    StepSchedule, MapSchedule, CycleSchedule, CosineSchedule, WarmupSchedule)}


def as_schedule(value: Union[float, Schedule, dict, None]) -> Optional[Schedule]:
    """A number becomes a :class:`FixedSchedule`; a schedule dict (as
    updater configs hold them) is decoded; a schedule passes through."""
    if value is None or isinstance(value, Schedule):
        return value
    if isinstance(value, dict):
        return Schedule.from_dict(value)
    return FixedSchedule(float(value))
