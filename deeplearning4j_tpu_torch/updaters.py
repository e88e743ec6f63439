"""Updater and regularization configs, as data.

The serving slice carries the training configuration of a model so that
its configuration dict matches the reference's, but it runs no optimizer:
the updater math and the train step come with the training slice
(ROADMAP § A). Each class here is a :class:`TaggedConf` holding exactly the
dict ``deeplearning4j_tpu.nn.conf.serde.encode`` writes for its reference
counterpart.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.serde import TaggedConf


def _fixed(value: float) -> dict:
    return {"@schedule": True, "@class": "FixedSchedule",
            "value": float(value), "schedule_type": "iteration"}


class Sgd(TaggedConf):
    def __init__(self, learning_rate: float = 1e-1):
        super().__init__({"@type": "updater", "@class": "Sgd",
                          "learning_rate": _fixed(learning_rate)})


class Nesterovs(TaggedConf):
    def __init__(self, learning_rate: float = 0.1, momentum: float = 0.9):
        super().__init__({"@type": "updater", "@class": "Nesterovs",
                          "learning_rate": _fixed(learning_rate),
                          "momentum": _fixed(momentum)})


class RegularizationConf(TaggedConf):
    def __init__(self, l1: float = 0.0, l2: float = 0.0, l1_bias: float = 0.0,
                 l2_bias: float = 0.0, weight_decay: float = 0.0,
                 weight_decay_bias: float = 0.0):
        super().__init__({"@type": "regularization", "l1": float(l1),
                          "l2": float(l2), "l1_bias": float(l1_bias),
                          "l2_bias": float(l2_bias),
                          "weight_decay": float(weight_decay),
                          "weight_decay_bias": float(weight_decay_bias)})
