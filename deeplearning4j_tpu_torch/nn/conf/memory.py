"""Analytic memory estimate of a network before it runs.

The part of ``deeplearning4j_tpu/nn/conf/memory.py`` (``:27-186``) that the
generation engine's memory report reads (``serving/generate.py``): for a
list configuration, a per-layer count of parameters, updater slots and
activation elements, and the bytes they take for a batch size. The
reference's int8-serving and ZeRO-1 terms and its text rendering come with
later slices; the graph report comes with the rest of the layer catalog
(ROADMAP § A4).
"""

from __future__ import annotations

from typing import List

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


class LayerMemoryReport:
    def __init__(self, layer_name: str, layer_type: str, input_type: InputType,
                 output_type: InputType, n_params: int, updater_slots: int,
                 activation_elems_per_example: int):
        self.layer_name = layer_name
        self.layer_type = layer_type
        self.input_type = input_type
        self.output_type = output_type
        self.n_params = int(n_params)
        self.updater_slots = int(updater_slots)
        self.activation_elems_per_example = int(activation_elems_per_example)

    def total_memory_bytes(self, batch_size: int, bytes_per_elem: int = 4,
                           training: bool = True) -> int:
        fixed = self.n_params * bytes_per_elem
        var = self.activation_elems_per_example * batch_size * bytes_per_elem
        if training:
            # gradients and updater slots; activations kept for backprop and
            # the input gradient
            fixed += self.n_params * bytes_per_elem * (1 + self.updater_slots)
            var *= 2
        return fixed + var


class NetworkMemoryReport:
    def __init__(self, layer_reports: List[LayerMemoryReport], model_class: str,
                 model_name: str, dtype: str = "float32"):
        self.layer_reports = layer_reports
        self.model_class = model_class
        self.model_name = model_name
        self.dtype = dtype

    @property
    def total_params(self) -> int:
        return sum(r.n_params for r in self.layer_reports)

    def total_memory_bytes(self, batch_size: int, training: bool = True) -> int:
        """Bytes at ``batch_size`` (training adds gradients, updater slots and
        the kept activations)."""
        b = _DTYPE_BYTES[self.dtype]
        return sum(r.total_memory_bytes(batch_size, b, training) for r in self.layer_reports)


def _updater_slot_count(layer) -> int:
    from deeplearning4j_tpu_torch.updaters import as_updater

    if getattr(layer, "updater", None) is None:
        return 0
    try:
        return len(as_updater(layer.updater).init_state(torch.zeros((1,))))
    except NotImplementedError:  # an updater not ported yet: Adam-like 2 slots
        return 2


def memory_report_mln(conf, name: str = "MultiLayerNetwork") -> NetworkMemoryReport:
    """The report of a list configuration."""
    types = conf.layer_types()
    reports = [LayerMemoryReport(
        layer_name=layer.name or f"layer{i}", layer_type=type(layer).__name__,
        input_type=types[i], output_type=types[i + 1], n_params=layer.n_params(types[i]),
        updater_slots=_updater_slot_count(layer),
        activation_elems_per_example=types[i + 1].arity())
        for i, layer in enumerate(conf.layers)]
    return NetworkMemoryReport(reports, "MultiLayerNetwork", name, conf.global_conf.dtype)
