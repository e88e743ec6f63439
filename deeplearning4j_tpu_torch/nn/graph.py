"""ComputationGraph: DAG network runtime, inference.

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` (slice 1: ``init``, the
eval-mode forward walk over the topological order, ``output`` and
``output_single``). PyTorch runs the walk eagerly; there is no compiled
program. Parameter and state layout are the reference's:

- ``params_``: dict vertex name -> dict param name -> tensor (``dtype``,
  f32 master weights)
- ``state_``:  dict vertex name -> dict (BN running statistics)

Under ``compute_dtype`` the forward casts float params (except those of
normalization and output layers and a layer's ``keep_fp32_params``) and
float inputs to the compute dtype, as the reference does.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import _dtype_of, resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration,
    LayerVertex,
)
from deeplearning4j_tpu_torch.nn.conf.layers.norm import BatchNormalization

Tensors = Dict[str, torch.Tensor]


def cast_layer_params_for_compute(layer, p: Tensors, cd: torch.dtype, *,
                                  is_output: bool) -> Tensors:
    """Mixed-precision cast of one layer's params: float params -> ``cd``,
    except normalization layers, output layers and ``keep_fp32_params``."""
    if isinstance(layer, BatchNormalization) or is_output:
        return p
    keep = getattr(layer, "keep_fp32_params", ())
    return {k: v.to(cd) if v.is_floating_point() and k not in keep else v
            for k, v in p.items()}


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration):
        # a private copy: layers of the caller's conf are never shared
        self.conf = conf = copy.deepcopy(conf)
        self.topo = conf.topological_order
        self.layer_names: List[str] = [
            n for n in self.topo if isinstance(conf.vertices[n], LayerVertex)]
        self.params_: Optional[Dict[str, Tensors]] = None
        self.state_: Optional[Dict[str, Tensors]] = None
        self.device: Optional[torch.device] = None
        self._compute_dtype = _dtype_of(getattr(conf.global_conf, "compute_dtype", None))
        self._output_layers()

    def _layer(self, name: str):
        return self.conf.vertices[name].layer

    def _output_layers(self) -> List[str]:
        for name in self.conf.network_outputs:
            v = self.conf.vertices[name]
            if not (isinstance(v, LayerVertex) and v.layer.is_output_layer):
                raise ValueError(f"Network output '{name}' is not an output layer")
        return list(self.conf.network_outputs)

    # ------------------------------------------------------------------ init
    def init(self, device=None) -> "ComputationGraph":
        """Draw the params on the CPU from a ``torch.Generator`` seeded with
        the configuration's ``seed``, and place params and state on
        ``device`` (default the CUDA card)."""
        if self.conf.input_types is None:
            raise ValueError("Configuration needs set_input_types(...) before init()")
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(self.conf.global_conf.seed)
        dtype = _dtype_of(self.conf.global_conf.dtype)
        lt = self.conf.layer_input_types()
        params: Dict[str, Tensors] = {}
        state: Dict[str, Tensors] = {}
        for name in self.layer_names:
            layer = self._layer(name)
            params[name] = {k: v.to(device) for k, v in
                            layer.init_params(gen, lt[name], dtype).items()}
            state[name] = {k: v.to(device) for k, v in
                           layer.init_layer_state(lt[name], dtype).items()}
        self.params_, self.state_, self.device = params, state, device
        return self

    def num_params(self) -> int:
        return int(sum(t.numel() for p in self.params_.values() for t in p.values()))

    # -------------------------------------------------------------- forward
    def compute_params(self, params: Optional[Dict[str, Tensors]] = None
                       ) -> Dict[str, Tensors]:
        """``params`` (default ``params_``) cast for the compute dtype."""
        params = self.params_ if params is None else params
        cd = self._compute_dtype
        if cd is None:
            return params
        out = dict(params)
        for name in self.layer_names:
            layer = self._layer(name)
            out[name] = cast_layer_params_for_compute(
                layer, params[name], cd, is_output=layer.is_output_layer)
        return out

    def _forward(self, params, state, inputs, *, train: bool = False,
                 cast_params: bool = True) -> Dict[str, torch.Tensor]:
        """Forward walk over the topological order; returns every vertex's
        activation. ``cast_params=False`` when ``params`` is already the
        output of :meth:`compute_params`."""
        conf = self.conf
        if self._compute_dtype is not None and cast_params:
            params = self.compute_params(params)
        # float inputs take the compute dtype, else the params dtype (the
        # reference runs with x64 off: a float64 array computes in f32)
        in_dt = self._compute_dtype or _dtype_of(conf.global_conf.dtype)
        inputs = [x.to(in_dt) if x.is_floating_point() else x for x in inputs]
        acts: Dict[str, torch.Tensor] = dict(zip(conf.network_inputs, inputs))
        for name in self.topo:
            v = conf.vertices[name]
            in_acts = [acts[s] for s in conf.vertex_inputs[name]]
            if isinstance(v, LayerVertex):
                y, _ = v.layer.apply(params.get(name, {}), in_acts[0],
                                     state=state.get(name, {}), train=train)
                acts[name] = y
            else:
                acts[name] = v.apply(in_acts)
        return acts

    def _as_input(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return t.to(self.device)

    # -------------------------------------------------------------- inference
    def output(self, *inputs) -> List[np.ndarray]:
        """Multi-output inference: one numpy array per network output."""
        if self.params_ is None:
            raise ValueError("init() the graph (or load params) first")
        with torch.inference_mode():
            acts = self._forward(self.params_, self.state_,
                                 [self._as_input(x) for x in inputs])
        out = []
        for name in self.conf.network_outputs:
            y = acts[name]
            if y.dtype in (torch.bfloat16, torch.float16):
                y = y.float()
            out.append(y.cpu().numpy())
        return out

    def output_single(self, *inputs) -> np.ndarray:
        ys = self.output(*inputs)
        if len(ys) != 1:
            raise ValueError(f"Graph has {len(ys)} outputs; use output()")
        return ys[0]
