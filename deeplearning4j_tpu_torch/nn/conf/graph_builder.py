"""ComputationGraph configuration + builder.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_builder.py``: named
vertices, named inputs/outputs, per-vertex input lists, validation, a
deterministic topological order and type inference. The configuration dict
(``to_dict``/``to_json``) is the reference's, so a configuration written by
either package builds in the other. ``build`` inserts input preprocessors
where the reference's graph builder does (``builders.infer_preprocessor``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import GraphVertex
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import GlobalConf, Layer

CONF_FORMAT_VERSION = 1


@serde.register
class LayerVertex(GraphVertex):
    """A vertex holding a Layer (+ optional input preprocessor)."""

    def __init__(self, layer: Layer, preprocessor=None):
        self.layer = layer
        self.preprocessor = preprocessor

    def layer_input_type(self, input_type: InputType) -> InputType:
        """The type the layer sees: ``input_type`` after the preprocessor."""
        if self.preprocessor is not None:
            return self.preprocessor.get_output_type(input_type)
        return input_type

    def get_output_type(self, *input_types: InputType) -> InputType:
        return self.layer.get_output_type(self.layer_input_type(input_types[0]))

    def to_dict(self) -> dict:
        return {"@class": "LayerVertex", "layer": serde.encode(self.layer),
                "preprocessor": serde.encode(self.preprocessor)}

    @classmethod
    def from_dict(cls, data: dict) -> "LayerVertex":
        return cls(serde.decode(data["layer"]), serde.decode(data.get("preprocessor")))


def topological_order(inputs: Sequence[str],
                      vertex_inputs: Dict[str, List[str]]) -> List[str]:
    """Kahn's algorithm, deterministic (insertion order)."""
    children: Dict[str, List[str]] = {n: [] for n in list(inputs) + list(vertex_inputs)}
    indeg: Dict[str, int] = {}
    for name, ins in vertex_inputs.items():
        for src in ins:
            if src not in children:
                raise ValueError(f"Vertex '{name}' references unknown input '{src}'")
            children[src].append(name)
        indeg[name] = sum(1 for src in ins if src in vertex_inputs)
    ready = [n for n in vertex_inputs if indeg[n] == 0]
    order: List[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for c in children.get(n, []):
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if len(order) != len(vertex_inputs):
        cyc = sorted(set(vertex_inputs) - set(order))
        raise ValueError(f"Graph has a cycle involving: {cyc}")
    return order


@serde.register
class ComputationGraphConfiguration:
    def __init__(self, global_conf: GlobalConf, network_inputs: List[str],
                 network_outputs: List[str], vertices: Dict[str, GraphVertex],
                 vertex_inputs: Dict[str, List[str]],
                 input_types: Optional[List[InputType]] = None,
                 backprop_type: str = "standard", tbptt_fwd_length: int = 20,
                 tbptt_back_length: int = 20):
        self.global_conf = global_conf
        self.network_inputs = list(network_inputs)
        self.network_outputs = list(network_outputs)
        self.vertices = dict(vertices)
        self.vertex_inputs = {k: list(v) for k, v in vertex_inputs.items()}
        self.input_types = input_types
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = int(tbptt_fwd_length)
        self.tbptt_back_length = int(tbptt_back_length)
        self.topological_order = topological_order(self.network_inputs,
                                                   self.vertex_inputs)

    def layer_input_types(self) -> Dict[str, InputType]:
        """InputType seen by each LayerVertex's layer."""
        if self.input_types is None:
            raise ValueError("input_types not set")
        types: Dict[str, InputType] = dict(zip(self.network_inputs, self.input_types))
        seen: Dict[str, InputType] = {}
        for name in self.topological_order:
            v = self.vertices[name]
            in_types = [types[src] for src in self.vertex_inputs[name]]
            if isinstance(v, LayerVertex):
                seen[name] = v.layer_input_type(in_types[0])
            types[name] = v.get_output_type(*in_types)
        return seen

    def to_dict(self) -> dict:
        return {
            "@class": "ComputationGraphConfiguration",
            "format_version": CONF_FORMAT_VERSION,
            "global_conf": serde.encode(self.global_conf),
            "network_inputs": list(self.network_inputs),
            "network_outputs": list(self.network_outputs),
            # list of pairs: insertion order decides topo-sort ties
            "vertices": [[k, serde.encode(v)] for k, v in self.vertices.items()],
            "vertex_inputs": [[k, list(v)] for k, v in self.vertex_inputs.items()],
            "input_types": None if self.input_types is None
            else [t.to_dict() for t in self.input_types],
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ComputationGraphConfiguration":
        def pairs(v):
            return v.items() if isinstance(v, dict) else v

        return cls(
            global_conf=serde.decode(d["global_conf"]),
            network_inputs=d["network_inputs"],
            network_outputs=d["network_outputs"],
            vertices={k: serde.decode(v) for k, v in pairs(d["vertices"])},
            vertex_inputs={k: list(v) for k, v in pairs(d["vertex_inputs"])},
            input_types=None if d.get("input_types") is None
            else [InputType.from_dict(t) for t in d["input_types"]],
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ComputationGraphConfiguration":
        return cls.from_dict(json.loads(s))

    def __eq__(self, other):
        return (isinstance(other, ComputationGraphConfiguration)
                and self.to_dict() == other.to_dict())


class GraphBuilder:
    def __init__(self, global_conf: GlobalConf):
        self._g = global_conf
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, GraphVertex] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._input_types: Optional[List[InputType]] = None

    def add_inputs(self, *names: str) -> "GraphBuilder":
        for n in names:
            if n in self._inputs or n in self._vertices:
                raise ValueError(f"Duplicate name '{n}'")
            self._inputs.append(n)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str,
                  preprocessor=None) -> "GraphBuilder":
        return self.add_vertex(name, LayerVertex(layer, preprocessor), *inputs)

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str) -> "GraphBuilder":
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"Duplicate vertex name '{name}'")
        if not inputs:
            raise ValueError(f"Vertex '{name}' needs at least one input")
        if isinstance(vertex, LayerVertex) and len(inputs) > 1:
            raise NotImplementedError(
                "a multi-input layer needs the implicit MergeVertex, which is "
                "not ported yet (ROADMAP § A)")
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        from deeplearning4j_tpu_torch.nn.conf.builders import infer_preprocessor

        if not self._inputs:
            raise ValueError("addInputs(...) required")
        if not self._outputs:
            raise ValueError("setOutputs(...) required")
        for o in self._outputs:
            if o not in self._vertices:
                raise ValueError(f"Output '{o}' is not a vertex")
        for name, ins in self._vertex_inputs.items():
            for src in ins:
                if src not in self._inputs and src not in self._vertices:
                    raise ValueError(f"Vertex '{name}' input '{src}' does not exist")
        for v in self._vertices.values():
            if isinstance(v, LayerVertex):
                v.layer.inherit_defaults(self._g)
        if self._input_types is not None:
            if len(self._input_types) != len(self._inputs):
                raise ValueError("set_input_types arity mismatch with add_inputs")
            order = topological_order(self._inputs, self._vertex_inputs)
            types: Dict[str, InputType] = dict(zip(self._inputs, self._input_types))
            for name in order:
                v = self._vertices[name]
                in_types = [types[src] for src in self._vertex_inputs[name]]
                if isinstance(v, LayerVertex):
                    if v.preprocessor is None:
                        v.preprocessor = infer_preprocessor(in_types[0], v.layer)
                    t = v.layer_input_type(in_types[0])
                    v.layer.initialize(t)
                    types[name] = v.layer.get_output_type(t)
                else:
                    types[name] = v.get_output_type(*in_types)
        return ComputationGraphConfiguration(
            global_conf=self._g, network_inputs=self._inputs,
            network_outputs=self._outputs, vertices=self._vertices,
            vertex_inputs=self._vertex_inputs, input_types=self._input_types)
