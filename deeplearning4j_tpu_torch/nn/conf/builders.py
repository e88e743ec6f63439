"""NeuralNetConfiguration builder -> MultiLayerConfiguration or graph.

Counterpart of ``deeplearning4j_tpu/nn/conf/builders.py``: global
hyperparameters set on the builder propagate into layers that do not
override them. ``set_input_type`` runs the reference's shape inference:
it walks the layer list, inserts input preprocessors between layer
families (:func:`infer_preprocessor`, which the graph builder uses too)
and fills each layer's ``nIn``. The configuration dict (``to_dict``/
``to_json``) is the reference's, so a configuration written by either
package loads in the other.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch import updaters as _upd
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import GlobalConf, Layer
from deeplearning4j_tpu_torch.nn.conf.layers.conv import BaseConvLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.layers.core import BaseOutputLayer, DenseLayer
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    FeedForwardToCnnPreProcessor,
    InputPreProcessor,
)
# the module, not the name: importing regularization first loads this
# package part-way (regularization -> nn.conf.serde -> nn.conf -> here)
from deeplearning4j_tpu_torch import regularization as _reg

CONF_FORMAT_VERSION = 1


def infer_preprocessor(input_type: InputType, layer: Layer
                       ) -> Optional[InputPreProcessor]:
    """The preprocessor the reference inserts in front of ``layer`` for
    ``input_type`` (``InputTypeUtil`` / ``setInputType``), or None."""
    kind = input_type.kind
    if isinstance(layer, (BaseConvLayer, SubsamplingLayer)):
        if kind == "convolutional_flat":
            return FeedForwardToCnnPreProcessor(
                input_type.height, input_type.width, input_type.channels)
        if kind == "feedforward":
            raise ValueError(
                f"Cannot feed feedforward input into CNN layer {layer}; "
                "set an explicit preprocessor or input type")
        return None
    if isinstance(layer, DenseLayer):
        if kind == "convolutional":
            return CnnToFeedForwardPreProcessor(
                input_type.height, input_type.width, input_type.channels)
        if kind == "recurrent" and isinstance(layer, BaseOutputLayer):
            raise ValueError(
                "Recurrent input into OutputLayer: use RnnOutputLayer, "
                "LastTimeStep, or a GlobalPoolingLayer first")
        # a dense layer on recurrent input runs per timestep, without the
        # reference's Rnn<->FF reshape round trip
        return None
    if isinstance(layer, BaseRecurrentLayer) or layer.is_recurrent:
        if kind == "feedforward":
            raise ValueError(
                f"Cannot feed feedforward input into recurrent layer {layer}")
    return None


@serde.register
class MultiLayerConfiguration:
    """A network configuration: global defaults, the layer list, the
    preprocessors by layer index and the input type."""

    def __init__(self, global_conf: GlobalConf, layers: List[Layer],
                 preprocessors: Optional[Dict[int, InputPreProcessor]] = None,
                 input_type: Optional[InputType] = None,
                 backprop_type: str = "standard", tbptt_fwd_length: int = 20,
                 tbptt_back_length: int = 20):
        self.global_conf = global_conf
        self.layers = layers
        self.preprocessors = dict(preprocessors or {})
        self.input_type = input_type
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = int(tbptt_fwd_length)
        self.tbptt_back_length = int(tbptt_back_length)

    def to_dict(self) -> dict:
        return {
            "@class": "MultiLayerConfiguration",
            "format_version": CONF_FORMAT_VERSION,
            "global_conf": serde.encode(self.global_conf),
            "layers": [serde.encode(layer) for layer in self.layers],
            "preprocessors": {str(k): serde.encode(v)
                              for k, v in self.preprocessors.items()},
            "input_type": None if self.input_type is None else self.input_type.to_dict(),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MultiLayerConfiguration":
        return cls(
            global_conf=serde.decode(d["global_conf"]),
            layers=[serde.decode(layer) for layer in d["layers"]],
            preprocessors={int(k): serde.decode(v)
                           for k, v in d.get("preprocessors", {}).items()},
            input_type=None if d.get("input_type") is None
            else InputType.from_dict(d["input_type"]),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "MultiLayerConfiguration":
        return cls.from_dict(json.loads(s))

    def __eq__(self, other):
        return (isinstance(other, MultiLayerConfiguration)
                and self.to_dict() == other.to_dict())

    def layer_types(self) -> List[InputType]:
        """The input type each layer sees (after its preprocessor), then the
        network's output type; needs the input type."""
        if self.input_type is None:
            raise ValueError("input_type not set")
        types, ct = [], self.input_type
        for i, layer in enumerate(self.layers):
            if i in self.preprocessors:
                ct = self.preprocessors[i].get_output_type(ct)
            types.append(ct)
            ct = layer.get_output_type(ct)
        types.append(ct)
        return types


class NeuralNetConfiguration:
    """Fluent builder entry point."""

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def __init__(self):
        self._g = GlobalConf()
        self._reg_kwargs: Dict[str, float] = {}

    def seed(self, s: int) -> "NeuralNetConfiguration":
        self._g.seed = int(s)
        return self

    def updater(self, u) -> "NeuralNetConfiguration":
        """An updater config, e.g. ``updaters.Nesterovs(0.1, 0.9)``."""
        if not isinstance(u, _upd.TaggedConf):
            raise NotImplementedError(
                "updater by name is not ported yet (ROADMAP § A); pass an "
                "updaters.* config")
        self._g.updater = u
        return self

    def weight_init(self, w) -> "NeuralNetConfiguration":
        self._g.weight_init = w
        return self

    def l2(self, v: float) -> "NeuralNetConfiguration":
        self._reg_kwargs["l2"] = float(v)
        return self

    def compute_dtype(self, dt: Optional[str]) -> "NeuralNetConfiguration":
        """Mixed precision: activations and conv/matmul operands in ``dt``
        (normally "bfloat16"); params stay ``dtype``. None disables."""
        self._g.compute_dtype = dt
        return self

    def sharded_update(self, b: bool = True) -> "NeuralNetConfiguration":
        """ZeRO-1 sharded weight update for the data-parallel runtime
        (``parallel/zero.py``): gradients reduce-scatter over the ranks, each
        rank applies the updater to its 1/N flat shard, the updated shards
        all-gather back. Only ``ParallelWrapper`` reads it; a plain ``fit``
        ignores it, as the reference's does."""
        self._g.sharded_update = bool(b)
        return self

    def fault_policy(self, policy) -> "NeuralNetConfiguration":
        """Step-level fault tolerance (``train/faults.FaultPolicy``): a
        non-finite gradient guard in the train step (a bad batch skips the
        update instead of poisoning the params) and dynamic loss scaling
        under a ``compute_dtype``. Pass a FaultPolicy, or True for the
        defaults; None disables."""
        from deeplearning4j_tpu_torch.train.faults import FaultPolicy

        if policy is True:
            policy = FaultPolicy()
        self._g.fault_policy = policy
        return self

    def steps_per_call(self, k: int) -> "NeuralNetConfiguration":
        """Bundled train steps (``train/pipeline.py``): ``fit`` stacks ``k``
        consecutive same-shaped batches and takes their ``k`` optimizer
        steps in one call, bit-identical to ``k`` single steps. On the card
        a bundle is one replay of a captured CUDA graph; on the CPU, ``k``
        eager steps in order. Ragged epoch tails and shape changes take
        single steps; tBPTT configurations refuse ``k > 1``."""
        self._g.steps_per_call = int(k)
        return self

    def _global_conf(self) -> GlobalConf:
        if self._reg_kwargs:
            self._g.regularization = _reg.RegularizationConf(**self._reg_kwargs)
            self._reg_kwargs = {}
        return self._g

    def list(self) -> "ListBuilder":
        return ListBuilder(self._global_conf())

    def graph_builder(self):
        from deeplearning4j_tpu_torch.nn.conf.graph_builder import GraphBuilder

        return GraphBuilder(self._global_conf())


class ListBuilder:
    """Builds a :class:`MultiLayerConfiguration` layer by layer."""

    def __init__(self, global_conf: GlobalConf):
        self._g = global_conf
        self._layers: List[Optional[Layer]] = []
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, *args) -> "ListBuilder":
        """``layer(conf)`` appends; ``layer(index, conf)`` places."""
        if len(args) == 1:
            self._layers.append(args[0])
        else:
            idx, conf = args
            while len(self._layers) <= idx:
                self._layers.append(None)
            self._layers[idx] = conf
        return self

    def input_pre_processor(self, idx: int, p: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[int(idx)] = p
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        self._input_type = t
        return self

    def backprop_type(self, t: str, fwd_length: int = 20,
                      back_length: int = 20) -> "ListBuilder":
        """``"standard"`` or ``"tbptt"`` with its forward/backward lengths:
        configuration data (the JSON both packages write). Training with
        it comes with the recurrent training slice (ROADMAP § A)."""
        self._backprop_type = t.lower()
        self._tbptt_fwd = int(fwd_length)
        self._tbptt_back = int(back_length)
        return self

    def tbptt_fwd_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = int(n)
        return self

    def tbptt_back_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = int(n)
        return self

    def build(self) -> MultiLayerConfiguration:
        if any(layer is None for layer in self._layers):
            raise ValueError("Layer list has gaps")
        layers = self._layers
        for layer in layers:
            layer.inherit_defaults(self._g)
        if self._input_type is not None:
            ct = self._input_type
            for i, layer in enumerate(layers):
                if i in self._preprocessors:
                    ct = self._preprocessors[i].get_output_type(ct)
                else:
                    p = infer_preprocessor(ct, layer)
                    if p is not None:
                        self._preprocessors[i] = p
                        ct = p.get_output_type(ct)
                layer.initialize(ct)
                ct = layer.get_output_type(ct)
        return MultiLayerConfiguration(global_conf=self._g, layers=layers,
                                       preprocessors=self._preprocessors,
                                       input_type=self._input_type,
                                       backprop_type=self._backprop_type,
                                       tbptt_fwd_length=self._tbptt_fwd,
                                       tbptt_back_length=self._tbptt_back)
