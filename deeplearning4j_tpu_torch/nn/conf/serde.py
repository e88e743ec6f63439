"""JSON serde for config objects, in the reference's format.

Counterpart of ``deeplearning4j_tpu/nn/conf/serde.py``: every config object
becomes a dict with an ``@class`` tag and the same field names, so the two
packages read and write the same configuration dicts.

Updaters, schedules, distributions and the regularization config are
:class:`TaggedConf` dicts with their maths (``updaters.py``,
``initializers.py``, ``regularization.py``). A ``{"@type": "constraint"}`` dict decodes into its class in
``regularization.py``; the dropout and weight-noise classes
(``nn/conf/dropouts.py``) resolve by ``@class``; both modules load with
the layer catalog. A ``FaultPolicy`` decodes into
``train/faults.FaultPolicy`` and a ``TelemetryConf`` into
``obs/telemetry.TelemetryConf``, whose modules register them when first
asked for.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

# config classes resolvable from @class tags, filled by register() calls
_CLASSES: Dict[str, type] = {}

# @class names registered by a module that this one cannot import at its top
# (it imports this one): imported at the first lookup
_LAZY = {"FaultPolicy": "deeplearning4j_tpu_torch.train.faults",
         "TelemetryConf": "deeplearning4j_tpu_torch.obs.telemetry"}


class UnknownConfigClassError(KeyError):
    """An ``@class`` tag resolves to no registered config class."""


class TaggedConf(dict):
    """A config the port stores as its JSON dict (``@type``- or
    ``@class``-tagged) and writes back as it was read."""


def register(cls: type) -> type:
    _CLASSES[cls.__name__] = cls
    return cls


def lookup(name: str) -> type:
    if name not in _CLASSES and name in _LAZY:
        import importlib

        importlib.import_module(_LAZY[name])
    if name not in _CLASSES:
        raise UnknownConfigClassError(
            f"Unknown config class '{name}' (not ported yet, or misspelled). "
            f"Registered: {sorted(_CLASSES)}")
    return _CLASSES[name]


def encode(obj: Any) -> Any:
    """Recursively encode a config object graph into JSON-compatible data."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (list, tuple)):
        return [encode(o) for o in obj]
    if isinstance(obj, TaggedConf):
        return copy.deepcopy(dict(obj))
    if hasattr(obj, "to_dict") and type(obj).__name__ in _CLASSES:
        d = obj.to_dict()
        d.setdefault("@class", type(obj).__name__)
        return d
    if isinstance(obj, dict):
        return {str(k): encode(v) for k, v in obj.items()}
    raise TypeError(f"Cannot encode {type(obj)} into config JSON: {obj!r}")


def decode(data: Any) -> Any:
    """Inverse of :func:`encode`."""
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, list):
        return [decode(d) for d in data]
    if isinstance(data, dict):
        if data.get("@type") == "constraint":
            return lookup(data["@class"]).from_dict(data)
        if "@type" in data:
            return TaggedConf(copy.deepcopy(data))
        if "@class" in data:
            return lookup(data["@class"]).from_dict(data)
        return {k: decode(v) for k, v in data.items()}
    raise TypeError(f"Cannot decode config JSON fragment: {data!r}")


def generic_to_dict(obj: Any) -> dict:
    d: Dict[str, Any] = {"@class": type(obj).__name__}
    for k, v in obj.__dict__.items():
        if k.startswith("_"):
            continue
        d[k] = encode(v)
    return d


def generic_from_dict(cls: type, data: dict) -> Any:
    obj = cls.__new__(cls)
    for k, v in data.items():
        if k.startswith("@"):
            continue
        setattr(obj, k, decode(v))
    return obj
