"""NeuralNetConfiguration builder (slice 1: the graph builder).

Counterpart of ``deeplearning4j_tpu/nn/conf/builders.py``: global
hyperparameters set on the builder propagate into layers that do not
override them. ``list()`` / ``MultiLayerConfiguration`` and automatic
input-preprocessor insertion come with the MultiLayerNetwork slice
(ROADMAP § A); a graph that would need a preprocessor is refused at build.
"""

from __future__ import annotations

from typing import Dict, Optional

from deeplearning4j_tpu_torch import updaters as _upd
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import GlobalConf, Layer
from deeplearning4j_tpu_torch.nn.conf.layers.conv import BaseConvLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.layers.core import DenseLayer


def check_no_preprocessor(input_type: InputType, layer: Layer) -> None:
    """Refuse the layer/input pairs where the reference inserts an input
    preprocessor (CNN <-> feed-forward reshapes)."""
    kind = input_type.kind
    if isinstance(layer, (BaseConvLayer, SubsamplingLayer)) and kind != "convolutional":
        raise NotImplementedError(
            f"{type(layer).__name__} on {kind} input needs an input "
            "preprocessor, not ported yet (ROADMAP § A)")
    if isinstance(layer, DenseLayer) and kind == "convolutional":
        raise NotImplementedError(
            f"{type(layer).__name__} on convolutional input needs "
            "CnnToFeedForwardPreProcessor, not ported yet (ROADMAP § A); "
            "pool first (GlobalPoolingLayer)")


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
        """An updater config (e.g. ``updaters.Nesterovs(0.1, 0.9)``); carried
        as configuration data until the training slice."""
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

    def graph_builder(self):
        from deeplearning4j_tpu_torch.nn.conf.graph_builder import GraphBuilder

        if self._reg_kwargs:
            self._g.regularization = _upd.RegularizationConf(**self._reg_kwargs)
            self._reg_kwargs = {}
        return GraphBuilder(self._g)
