"""Analytic memory estimate of a network before it runs.

Counterpart of ``deeplearning4j_tpu/nn/conf/memory.py`` (reference
``nn/conf/memory/{MemoryReport,LayerMemoryReport,NetworkMemoryReport}.java``):
for a list or graph configuration, a per-layer count of parameters, updater
slots and activation elements, and the bytes they take for a batch size:
params, and in training their gradients and updater slots, plus the layer
outputs (twice in training: kept for the backward and the gradient with
respect to them). ``data_parallel_shards`` models the ZeRO-1 sharded update
(each replica holds 1/N of every slot), ``int8_weights`` int8 weight-only
serving (the dense and output heads' ``W`` at one byte, plus an f32 scale
an output channel). The figures and ``to_string`` are the reference's.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


class LayerMemoryReport:
    def __init__(self, layer_name: str, layer_type: str, input_type: InputType,
                 output_type: InputType, n_params: int, updater_slots: int,
                 activation_elems_per_example: int, int8_weight_params: int = 0):
        self.layer_name = layer_name
        self.layer_type = layer_type
        self.input_type = input_type
        self.output_type = output_type
        self.n_params = int(n_params)
        self.updater_slots = int(updater_slots)
        self.activation_elems_per_example = int(activation_elems_per_example)
        #: weight elements int8 serving quantizes (a dense or output head's W)
        self.int8_weight_params = int(int8_weight_params)

    def updater_state_bytes(self, bytes_per_elem: int = 4,
                            data_parallel_shards: int = 1) -> int:
        """Updater-slot bytes a replica holds: 1/N of them (rounded up)
        under the ZeRO-1 sharded update over N replicas."""
        total = self.n_params * self.updater_slots * bytes_per_elem
        return -(-total // max(int(data_parallel_shards), 1))

    def total_memory_bytes(self, batch_size: int, bytes_per_elem: int = 4,
                           training: bool = True, data_parallel_shards: int = 1,
                           int8_weights: bool = False) -> int:
        fixed = self.n_params * bytes_per_elem
        if not training and int8_weights and self.int8_weight_params:
            fixed -= self.int8_weight_params * (bytes_per_elem - 1)
            fixed += self.output_type.size * 4 if self.output_type else 0
        if training:
            fixed += self.n_params * bytes_per_elem  # gradients
            fixed += self.updater_state_bytes(bytes_per_elem, data_parallel_shards)
        var = self.activation_elems_per_example * batch_size * bytes_per_elem
        if training:
            var *= 2  # kept for the backward, and the gradient with respect to it
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

    def total_memory_bytes(self, batch_size: int, training: bool = True,
                           dtype: Optional[str] = None, data_parallel_shards: int = 1,
                           int8_weights: bool = False) -> int:
        """Bytes a replica holds at ``batch_size``: ``data_parallel_shards``
        divides the updater state only; ``int8_weights`` (inference) counts
        the quantized heads at one byte a weight."""
        b = _DTYPE_BYTES[dtype or self.dtype]
        return sum(r.total_memory_bytes(batch_size, b, training, data_parallel_shards,
                                        int8_weights=int8_weights)
                   for r in self.layer_reports)

    def updater_state_bytes(self, dtype: Optional[str] = None,
                            data_parallel_shards: int = 1) -> int:
        """Updater-slot bytes a replica holds."""
        b = _DTYPE_BYTES[dtype or self.dtype]
        return sum(r.updater_state_bytes(b, data_parallel_shards) for r in self.layer_reports)

    def to_string(self, batch_size: int = 32, data_parallel_shards: int = 1) -> str:
        train_b = self.total_memory_bytes(batch_size, True,
                                          data_parallel_shards=data_parallel_shards)
        lines = [
            f"NetworkMemoryReport: {self.model_class} ({self.model_name})",
            f"  dtype={self.dtype}  total params={self.total_params:,}",
            f"  est. training memory @ batch {batch_size}: {train_b / 2**20:.1f} MiB",
            f"  est. inference memory @ batch {batch_size}: "
            f"{self.total_memory_bytes(batch_size, False) / 2**20:.1f} MiB",
        ]
        if data_parallel_shards > 1:
            full = self.updater_state_bytes()
            shard = self.updater_state_bytes(data_parallel_shards=data_parallel_shards)
            lines.append(
                f"  sharded_update over {data_parallel_shards} replicas: "
                f"updater state {full / 2**20:.1f} → {shard / 2**20:.1f} "
                f"MiB/replica (saves {(full - shard) / 2**20:.1f} MiB)")
        lines.append("  per-layer:")
        for r in self.layer_reports:
            lines.append(
                f"    {r.layer_name:24s} {r.layer_type:28s} params={r.n_params:>12,} "
                f"act/ex={r.activation_elems_per_example:>10,}")
        return "\n".join(lines)

    def __repr__(self):
        return self.to_string()


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
    from deeplearning4j_tpu_torch.nn.ops.int8_matmul import quantizable_layer

    types = conf.layer_types()
    reports = []
    for i, layer in enumerate(conf.layers):
        int8q = 0
        if quantizable_layer(layer) and layer.n_in and layer.n_out:
            int8q = int(layer.n_in) * int(layer.n_out)
        reports.append(LayerMemoryReport(
            layer_name=layer.name or f"layer{i}", layer_type=type(layer).__name__,
            input_type=types[i], output_type=types[i + 1],
            n_params=layer.n_params(types[i]), updater_slots=_updater_slot_count(layer),
            activation_elems_per_example=types[i + 1].arity(), int8_weight_params=int8q))
    return NetworkMemoryReport(reports, "MultiLayerNetwork", name, conf.global_conf.dtype)


def memory_report_graph(conf, name: str = "ComputationGraph") -> NetworkMemoryReport:
    """The report of a graph configuration: its layer vertices in
    topological order."""
    from deeplearning4j_tpu_torch.nn.conf.graph_builder import LayerVertex

    lt = conf.layer_input_types()
    vt = conf.vertex_types()
    reports = [LayerMemoryReport(
        layer_name=n, layer_type=type(conf.vertices[n].layer).__name__, input_type=lt[n],
        output_type=vt[n], n_params=conf.vertices[n].layer.n_params(lt[n]),
        updater_slots=_updater_slot_count(conf.vertices[n].layer),
        activation_elems_per_example=vt[n].arity())
        for n in conf.topological_order if isinstance(conf.vertices[n], LayerVertex)]
    return NetworkMemoryReport(reports, "ComputationGraph", name, conf.global_conf.dtype)
