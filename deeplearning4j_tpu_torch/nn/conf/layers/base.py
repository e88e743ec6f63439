"""Layer config/runtime base classes.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/base.py``: the config
object is the runtime, with the same fields (so the configuration dicts
match) and the same methods:

- ``initialize(input_type)`` / ``get_output_type(input_type)``
- ``init_params(gen, input_type, dtype)`` -> dict of tensors (on the CPU)
- ``init_layer_state(input_type, dtype)`` -> dict (BN running stats)
- ``apply(params, x, state=..., train=False, rng=None, mask=None)`` ->
  (y, new_state)

``train=True`` takes batch statistics where a layer has them (BN) and
returns the new running state. ``rng`` is the layer's noise stream
(``nn/conf/dropouts.NoiseSource``) in training, None otherwise; a layer that
draws noise of its own (attention dropout) reads it. The networks apply a
layer's input dropout (:func:`apply_input_dropout`) and weight noise
(:func:`apply_weight_noise`) around its ``apply``, as the reference's
``_forward`` does; its constraints follow each update
(``regularization.apply_constraints``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch import initializers as _init
from deeplearning4j_tpu_torch import updaters as _upd
# the module, not the name: importing regularization first loads this
# package part-way (regularization -> nn.conf.serde -> nn.conf -> here)
from deeplearning4j_tpu_torch import regularization as _reg
from deeplearning4j_tpu_torch.nn.conf import dropouts, serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType

Params = Dict[str, torch.Tensor]
LayerState = Dict[str, torch.Tensor]

# Sentinel: "not set here — inherit the network-level default at build()"
INHERIT = None



class Layer:
    """Base for all layer configs."""

    def __init__(self, name: Optional[str] = None, dropout=0.0,
                 weight_noise=None, constraints: Optional[Sequence] = None,
                 gradient_normalization: Optional[str] = INHERIT,
                 gradient_normalization_threshold: float = 1.0,
                 updater=INHERIT, regularization=INHERIT):
        self.name = name
        self.dropout = dropout if not isinstance(dropout, (int, float)) \
            else float(dropout)
        self.weight_noise = weight_noise
        self.constraints = list(constraints) if constraints else []
        self.gradient_normalization = gradient_normalization
        self.gradient_normalization_threshold = float(
            gradient_normalization_threshold)
        self.updater = updater
        self.regularization = regularization

    def initialize(self, input_type: InputType) -> None:
        """Infer unset shape hyperparameters (nIn) from the incoming type."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    def inherit_defaults(self, defaults: "GlobalConf") -> None:
        if self.updater is INHERIT:
            self.updater = defaults.updater
        if self.regularization is INHERIT:
            self.regularization = defaults.regularization
        if self.gradient_normalization is INHERIT:
            self.gradient_normalization = defaults.gradient_normalization
            self.gradient_normalization_threshold = \
                defaults.gradient_normalization_threshold

    def init_params(self, gen: torch.Generator, input_type: InputType,
                    dtype=torch.float32) -> Params:
        return {}

    def init_layer_state(self, input_type: InputType,
                         dtype=torch.float32) -> LayerState:
        return {}

    def apply(self, params: Params, x: torch.Tensor, *,
              state: Optional[LayerState] = None, train: bool = False, rng=None,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, LayerState]:
        """``mask``: the (b, T) feature mask of recurrent input, or None;
        layers that do not read it ignore it. ``rng``: the layer's noise
        stream in training (read by layers that draw noise themselves)."""
        raise NotImplementedError

    def n_params(self, input_type: InputType) -> int:
        """Parameter count at ``input_type`` (the memory report's)."""
        p = self.init_params(torch.Generator().manual_seed(0), input_type)

        def count(d):
            return sum(count(v) if isinstance(v, dict) else v.numel()
                       for v in d.values())

        return int(count(p))

    is_recurrent = False
    is_output_layer = False
    is_pretrain_layer = False

    def to_dict(self) -> dict:
        return serde.generic_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "Layer":
        actual = serde.lookup(data.get("@class", cls.__name__))
        return serde.generic_from_dict(actual, data)

    def __eq__(self, other):
        return type(self) is type(other) and serde.encode(self) == serde.encode(other)

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items() if v is not None and v != []}
        return f"{type(self).__name__}({fields})"

    def clone(self) -> "Layer":
        """A copy through the configuration dict."""
        return Layer.from_dict(self.to_dict())


class LayerWrapper(Layer):
    """A layer around an inner ``layer`` whose shape inference and
    defaults it forwards."""

    def initialize(self, input_type):
        self.layer.initialize(input_type)

    def inherit_defaults(self, defaults):
        super().inherit_defaults(defaults)
        self.layer.inherit_defaults(defaults)


#: the sub-streams of a layer's noise stream
INPUT_DROPOUT_STREAM, WEIGHT_NOISE_STREAM, LAYER_STREAM = 0, 1, 2


def apply_input_dropout(layer: Layer, x: torch.Tensor, train: bool, rng) -> torch.Tensor:
    """The layer's dropout on its *input* in training (reference
    ``BaseLayer.applyDropOutIfNecessary``): a float is plain inverted dropout
    (the drop probability), an object an ``IDropout``; identity outside
    training. ``rng``: the layer's noise stream."""
    d = layer.dropout
    if not train or d is None:
        return x
    if isinstance(d, (int, float)):
        if d <= 0.0:
            return x
        d = dropouts.Dropout(d)
    if rng is None:
        raise ValueError(f"Layer {layer.name}: dropout requires an rng during training")
    return d.apply(x, rng.child(INPUT_DROPOUT_STREAM))


def apply_weight_noise(layer: Layer, params: Params, train: bool, rng) -> Params:
    """The layer's ``IWeightNoise`` on its params in training (reference
    ``BaseLayer.getParamsWithNoise``), from a sub-stream of the layer's that
    every rank draws alike (the params are the same on every rank)."""
    wn = getattr(layer, "weight_noise", None)
    if not train or wn is None or not params:
        return params
    if rng is None:
        raise ValueError(f"Layer {layer.name}: weight noise requires an rng")
    return wn.apply_to_params(params, rng.child(WEIGHT_NOISE_STREAM).shared())


class GlobalConf:
    """Network-level defaults propagated into layers (same fields as the
    reference's ``GlobalConf``)."""

    def __init__(self, seed: int = 0, updater=None, weight_init="xavier",
                 distribution=None, activation: str = "sigmoid",
                 bias_init: float = 0.0, regularization=None,
                 gradient_normalization: Optional[str] = None,
                 gradient_normalization_threshold: float = 1.0,
                 dtype: str = "float32", compute_dtype: Optional[str] = None,
                 mini_batch: bool = True,
                 max_num_line_search_iterations: int = 5,
                 optimization_algo: str = "stochastic_gradient_descent",
                 remat_policy: Optional[str] = None,
                 sharded_update: bool = False, fault_policy=None,
                 steps_per_call: int = 1, async_queue_size: int = 4,
                 telemetry=None):
        self.seed = int(seed)
        self.updater = updater if updater is not None else _upd.Sgd(1e-1)
        self.weight_init = weight_init
        self.distribution = distribution
        self.activation = activation
        self.bias_init = float(bias_init)
        self.regularization = (regularization if regularization is not None
                               else _reg.RegularizationConf())
        self.gradient_normalization = gradient_normalization
        self.gradient_normalization_threshold = float(
            gradient_normalization_threshold)
        self.dtype = dtype
        # mixed precision: params stay ``dtype``; activations and conv/matmul
        # operands are cast to ``compute_dtype`` (e.g. "bfloat16")
        self.compute_dtype = compute_dtype
        self.remat_policy = remat_policy
        self.sharded_update = bool(sharded_update)
        self.fault_policy = fault_policy
        self.steps_per_call = int(steps_per_call)
        self.async_queue_size = int(async_queue_size)
        self.telemetry = telemetry
        self.mini_batch = bool(mini_batch)
        self.max_num_line_search_iterations = int(max_num_line_search_iterations)
        self.optimization_algo = optimization_algo

    def to_dict(self) -> dict:
        return serde.generic_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "GlobalConf":
        return serde.generic_from_dict(cls, data)

    def __eq__(self, other):
        return isinstance(other, GlobalConf) and serde.encode(self) == serde.encode(other)


serde.register(GlobalConf)


class FeedForwardLayer(Layer):
    """Base for layers with explicit nIn/nOut."""

    def __init__(self, n_out: Optional[int] = None, n_in: Optional[int] = None,
                 activation: Optional[str] = INHERIT, weight_init=INHERIT,
                 distribution=None, bias_init: Optional[float] = INHERIT,
                 **kwargs):
        super().__init__(**kwargs)
        self.n_in = None if n_in is None else int(n_in)
        self.n_out = None if n_out is None else int(n_out)
        self.activation = activation
        self.weight_init = weight_init
        self.distribution = distribution
        self.bias_init = bias_init

    def inherit_defaults(self, defaults: GlobalConf) -> None:
        super().inherit_defaults(defaults)
        if self.activation is INHERIT:
            self.activation = defaults.activation
        if self.weight_init is INHERIT:
            self.weight_init = defaults.weight_init
        if self.distribution is None:
            self.distribution = defaults.distribution
        if self.bias_init is INHERIT:
            self.bias_init = defaults.bias_init

    def initialize(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.size

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def act_fn(self):
        return _act.get(self.activation)

    def _draw_weight(self, gen, shape, fan_in, fan_out, dtype):
        return _init.init_weights(
            gen, shape, fan_in, fan_out,
            self.weight_init if self.weight_init is not None else "xavier",
            dtype=dtype, distribution=self.distribution)

    def _bias(self, shape, dtype):
        b0 = self.bias_init if self.bias_init is not None else 0.0
        return torch.full(tuple(shape), float(b0), dtype=dtype)


serde.register(Layer)
serde.register(FeedForwardLayer)
