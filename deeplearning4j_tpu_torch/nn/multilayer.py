"""MultiLayerNetwork: the sequential network runtime, and the per-layer
update pipeline shared by the train steps.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` (slice 3: ``init``,
the eval forward, ``output``, the flat parameter vector and ``summary``).
State layout is the reference's:

- ``params_``: list (per layer) of dicts param name -> tensor (``dtype``,
  f32 master weights)
- ``state_``:  list of dicts (BN running statistics)

Under ``compute_dtype`` the forward casts float params (except those of
normalization layers, the output layer and a layer's ``keep_fp32_params``)
and float inputs to the compute dtype, as the reference does; int8 serving
weights (``W_q8``) stay int8 and their ``W_scale`` is cast like any float
param. ``fit``, ``score``, tBPTT and ``rnn_time_step`` come with the
training and recurrent slices (ROADMAP § A) and raise.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import _dtype_of, resolve_device
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers.norm import BatchNormalization
from deeplearning4j_tpu_torch.regularization import (
    as_regularization,
    normalize_layer_gradients,
)
from deeplearning4j_tpu_torch.updaters import as_updater

Tensors = Dict[str, torch.Tensor]

NOT_PORTED = "not ported yet (ROADMAP § A, slice 4: the rest of the training core)"


def cast_layer_params_for_compute(layer, p: Tensors, cd: torch.dtype, *,
                                  is_output: bool) -> Tensors:
    """Mixed-precision cast of one layer's params: float params -> ``cd``,
    except normalization layers, output layers and ``keep_fp32_params``.
    Shared by MultiLayerNetwork and ComputationGraph."""
    if isinstance(layer, BatchNormalization) or is_output:
        return p
    keep = getattr(layer, "keep_fp32_params", ())
    return {k: v.to(cd) if v.is_floating_point() and k not in keep else v
            for k, v in p.items()}


@torch.no_grad()
def apply_layer_updates(layers, params: List[Tensors], grads: List[Tensors],
                        opt_state: List[Dict[str, Tensors]], t: int,
                        iteration: int, epoch: int
                        ) -> Tuple[List[Tensors], List[Dict[str, Tensors]]]:
    """One optimizer step over every layer, in the reference's order:
    gradient normalization -> l1/l2/weight-decay gradient term -> updater
    -> ``param - update``. (Parameter constraints, which the reference
    applies last, are refused at train time by ``check_trainable``.)
    Returns new params and new updater state; the inputs are not changed."""
    new_params, new_opt = [], []
    for layer, p_i, g_i, o_i in zip(layers, params, grads, opt_state):
        if not p_i:
            new_params.append(p_i)
            new_opt.append(o_i)
            continue
        g_i = normalize_layer_gradients(g_i, layer.gradient_normalization,
                                        layer.gradient_normalization_threshold)
        reg = as_regularization(layer.regularization)
        if reg is not None:
            out = {}
            for k, g in g_i.items():
                term = reg.grad_term(k, p_i[k])
                out[k] = g if term is None else g + term
            g_i = out
        upd = as_updater(layer.updater)
        np_i, no_i = {}, {}
        for name, g in g_i.items():
            delta, new_slot = upd.apply(g, o_i[name], t, iteration, epoch)
            np_i[name] = p_i[name] - delta
            no_i[name] = new_slot
        new_params.append(np_i)
        new_opt.append(no_i)
    return new_params, new_opt


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration):
        # a private copy: layers of the caller's conf are never shared
        self.conf = conf = copy.deepcopy(conf)
        self.layers = conf.layers
        self.params_: Optional[List[Tensors]] = None
        self.state_: Optional[List[Tensors]] = None
        self.device: Optional[torch.device] = None
        self.iteration = 0
        self.epoch = 0
        self._compute_dtype = _dtype_of(getattr(conf.global_conf, "compute_dtype", None))

    # ------------------------------------------------------------------ init
    def init(self, device=None) -> "MultiLayerNetwork":
        """Draw the params on the CPU from a ``torch.Generator`` seeded with
        the configuration's ``seed``, and place params and state on
        ``device`` (default the CUDA card)."""
        if self.conf.input_type is None:
            raise ValueError("Configuration needs set_input_type(...) before init()")
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(self.conf.global_conf.seed)
        dtype = _dtype_of(self.conf.global_conf.dtype)
        types = self.conf.layer_types()
        params, state = [], []
        for i, layer in enumerate(self.layers):
            params.append({k: v.to(device) for k, v in
                           layer.init_params(gen, types[i], dtype).items()})
            state.append({k: v.to(device) for k, v in
                          layer.init_layer_state(types[i], dtype).items()})
        self.params_, self.state_, self.device = params, state, device
        self.iteration = self.epoch = 0
        return self

    def _is_output(self, i: int) -> bool:
        return i == len(self.layers) - 1 and self.layers[i].is_output_layer

    # -------------------------------------------------------------- forward
    def compute_params(self, params: Optional[List[Tensors]] = None
                       ) -> List[Tensors]:
        """``params`` (default ``params_``) cast for the compute dtype."""
        params = self.params_ if params is None else params
        cd = self._compute_dtype
        if cd is None:
            return params
        return [cast_layer_params_for_compute(layer, p, cd, is_output=self._is_output(i))
                for i, (layer, p) in enumerate(zip(self.layers, params))]

    def _forward(self, params, state, x: torch.Tensor, *, train: bool = False,
                 stop_before: Optional[int] = None, cast_params: bool = True
                 ) -> Tuple[torch.Tensor, List[Tensors]]:
        """The eval forward. Returns ``(x, new_states)``: ``x`` is the
        activation into layer ``stop_before`` (after its preprocessor), or
        the network's output when ``stop_before`` is None.
        ``cast_params=False`` when ``params`` is already the output of
        :meth:`compute_params`."""
        if train:
            raise NotImplementedError(f"MultiLayerNetwork training is {NOT_PORTED}")
        if self._compute_dtype is not None and cast_params:
            params = self.compute_params(params)
        # float inputs take the compute dtype, else the params dtype (the
        # reference runs with x64 off: a float64 array computes in f32)
        in_dt = self._compute_dtype or _dtype_of(self.conf.global_conf.dtype)
        if x.is_floating_point():
            x = x.to(in_dt)
        n = len(self.layers)
        stop = n if stop_before is None else stop_before
        new_states: List[Tensors] = []
        for i in range(n):
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i].pre_process(x)
            if i >= stop:
                break
            x, st = self.layers[i].apply(params[i], x, state=state[i], train=False)
            new_states.append(st if st is not None else {})
        return x, new_states

    def _as_input(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return t.to(self.device)

    def output(self, x) -> np.ndarray:
        """Inference: the network's output for ``x`` as a numpy array (f32
        for a bf16 compute dtype)."""
        if self.params_ is None:
            raise ValueError("init() the network (or load params) first")
        with torch.inference_mode():
            y, _ = self._forward(self.params_, self.state_, self._as_input(x))
        if y.dtype in (torch.bfloat16, torch.float16):
            y = y.float()
        return y.cpu().numpy()

    # ------------------------------------------------------- params utilities
    def num_params(self) -> int:
        return int(sum(t.numel() for p in self.params_ for t in p.values()))

    def summary(self) -> str:
        """Layer table: index, layer, input -> output type, #params."""
        types = self.conf.layer_types()
        rows = [("idx", "layer", "input", "output", "params")]
        total = 0
        for i, layer in enumerate(self.layers):
            n = (int(sum(t.numel() for t in self.params_[i].values()))
                 if self.params_ is not None else 0)
            total += n
            rows.append((str(i), type(layer).__name__, str(types[i]),
                         str(layer.get_output_type(types[i])), f"{n:,}"))
        widths = [max(len(r[c]) for r in rows) for c in range(5)]
        lines = ["  ".join(r[c].ljust(widths[c]) for c in range(5)) for r in rows]
        lines.insert(1, "-" * (sum(widths) + 8))
        lines.append(f"Total parameters: {total:,}")
        return "\n".join(lines)

    def params_flat(self) -> np.ndarray:
        """One flat f32 parameter vector: layer index ascending, param name
        sorted ascending (the checkpoint's ``coefficients.bin`` order)."""
        return flatten_tensors(self.params_)

    def set_params_flat(self, vec: np.ndarray) -> None:
        self.params_ = unflatten_tensors(self.params_, vec)

    # --------------------------------------------------------------- refusals
    def fit(self, *args, **kwargs):
        raise NotImplementedError(f"MultiLayerNetwork.fit is {NOT_PORTED}")

    def score(self, *args, **kwargs):
        raise NotImplementedError(f"MultiLayerNetwork.score is {NOT_PORTED}")

    def rnn_time_step(self, *args, **kwargs):
        raise NotImplementedError(
            "rnn_time_step comes with the recurrent slice (ROADMAP § A)")


def flatten_tensors(groups) -> np.ndarray:
    """Tensors of a list of dicts (or a dict of dicts, walked in the caller's
    order) as one f32 vector: group by group, names sorted."""
    groups = groups.values() if isinstance(groups, dict) else groups
    chunks = [g[name].detach().float().cpu().numpy().reshape(-1)
              for g in groups for name in sorted(g)]
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)


def unflatten_tensors(groups, vec: np.ndarray):
    """The inverse of :func:`flatten_tensors`: new tensors of each tensor's
    shape, dtype and device, read from ``vec`` in the same order."""
    vec = np.asarray(vec, np.float32)
    keyed = isinstance(groups, dict)
    items = groups.items() if keyed else enumerate(groups)
    off = 0
    out = {} if keyed else []
    for key, g in items:
        new = {}
        for name in sorted(g):
            t = g[name]
            n = t.numel()
            if off + n > vec.size:
                raise ValueError(f"Param vector length {vec.size} is shorter than "
                                 "the model")
            new[name] = torch.tensor(vec[off:off + n].reshape(tuple(t.shape)),
                                     dtype=t.dtype, device=t.device)
            off += n
        if keyed:
            out[key] = new
        else:
            out.append(new)
    if off != vec.size:
        raise ValueError(f"Param vector length {vec.size} != model size {off}")
    return out
