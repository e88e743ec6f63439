"""MultiLayerNetwork: the sequential network runtime, and the per-layer
update pipeline shared by the train steps.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``, the eval
forward with feature masks and recurrent carries, ``output``, the
streaming ``rnn_time_step`` family, the flat parameter vector and
``summary``.
State layout is the reference's:

- ``params_``: list (per layer) of dicts param name -> tensor (``dtype``,
  f32 master weights)
- ``state_``:  list of dicts (BN running statistics)

Under ``compute_dtype`` the forward casts float params (except those of
normalization layers, the output layer and a layer's ``keep_fp32_params``)
and float inputs to the compute dtype, as the reference does; int8 serving
weights (``W_q8``) stay int8 and their ``W_scale`` is cast like any float
param. ``fit``, ``score`` and tBPTT training come with the training slices
(ROADMAP § A) and raise.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

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
    return {k: (map_tensors(lambda t: t.to(cd) if t.is_floating_point() else t, v)
                if k not in keep else v)
            for k, v in p.items()}


def map_tensors(fn, tree):
    """``fn`` over every tensor of a param dict, nested dicts included (a
    Bidirectional layer keeps its two copies under "fwd"/"bwd")."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree)


def tensor_leaves(tree):
    """The tensors of a param dict in checkpoint order: names sorted,
    nested dicts walked in place."""
    for name in sorted(tree):
        v = tree[name]
        if isinstance(v, dict):
            yield from tensor_leaves(v)
        else:
            yield v


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
        #: the streaming state of :meth:`rnn_time_step`
        self._rnn_carries: Optional[List[Any]] = None
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
            params.append(map_tensors(lambda t: t.to(device),
                                      layer.init_params(gen, types[i], dtype)))
            state.append(map_tensors(lambda t: t.to(device),
                                     layer.init_layer_state(types[i], dtype)))
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
                 stop_before: Optional[int] = None, cast_params: bool = True,
                 fmask: Optional[torch.Tensor] = None,
                 carries: Optional[List[Any]] = None
                 ) -> Tuple[torch.Tensor, List[Tensors], List[Any]]:
        """The eval forward. Returns ``(x, new_states, new_carries)``: ``x``
        is the activation into layer ``stop_before`` (after its
        preprocessor), or the network's output when ``stop_before`` is
        None. ``fmask``: the (b, T) feature mask of recurrent input
        (preprocessors map it, pooling and last-step layers consume it).
        ``carries``: per layer, the recurrent state to start from (None
        entries start from zeros, as :meth:`_init_carries` gives);
        ``new_carries`` holds each recurrent layer's final state where a
        carry was given, else None. ``cast_params=False`` when ``params`` is
        already the output of :meth:`compute_params`."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer

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
        mask = fmask
        new_states: List[Tensors] = []
        new_carries: List[Any] = [None] * n
        for i in range(n):
            layer = self.layers[i]
            if i in self.conf.preprocessors:
                prep = self.conf.preprocessors[i]
                x = prep.pre_process(x, mask)
                mask = prep.feed_forward_mask(mask)
            if i >= stop:
                break
            if (carries is not None and isinstance(layer, BaseRecurrentLayer)
                    and carries[i] is not None):
                x, new_carries[i] = layer.apply_with_carry(params[i], x, carries[i],
                                                           mask=mask)
                st = state[i]
            else:
                x, st = layer.apply(params[i], x, state=state[i], train=False, mask=mask)
            new_states.append(st if st is not None else {})
            if layer.is_recurrent and mask is not None:
                pass  # recurrent layers keep the (b, T) mask
            elif x.dim() == 2 and mask is not None and mask.dim() > 1:
                mask = None  # consumed by a pooling or last-step layer
        return x, new_states, new_carries

    def _init_carries(self, batch: int, dtype=torch.float32) -> List[Any]:
        """Zero recurrent state for ``batch`` rows on the model's device: a
        carry per recurrent layer, None for the others."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer

        return [layer.init_carry(batch, dtype, self.device)
                if isinstance(layer, BaseRecurrentLayer) else None
                for layer in self.layers]

    def _as_input(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return t.to(self.device)

    @staticmethod
    def _host(y: torch.Tensor) -> np.ndarray:
        if y.dtype in (torch.bfloat16, torch.float16):
            y = y.float()
        return y.cpu().numpy()

    def output(self, x, mask=None) -> np.ndarray:
        """Inference: the network's output for ``x`` as a numpy array (f32
        for a bf16 compute dtype). ``mask``: the (b, T) feature mask of
        recurrent input."""
        if self.params_ is None:
            raise ValueError("init() the network (or load params) first")
        with torch.inference_mode():
            m = None if mask is None else self._as_input(mask).float()
            y, _, _ = self._forward(self.params_, self.state_, self._as_input(x), fmask=m)
        return self._host(y)

    # ---------------------------------------------------------- rnn state
    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_get_previous_state(self):
        """Per-layer streaming state as numpy (a tuple ``(h, c)`` for an
        LSTM layer, None for a non-recurrent one); None before any
        :meth:`rnn_time_step`."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import tree_map

        if self._rnn_carries is None:
            return None
        return [None if c is None else tree_map(self._host, c)
                for c in self._rnn_carries]

    def rnn_set_previous_state(self, carries) -> None:
        """Restore state taken by :meth:`rnn_get_previous_state` (e.g. to
        resume streaming after a restart)."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import tree_map

        self._rnn_carries = None if carries is None else [
            None if c is None else tree_map(
                lambda a: torch.as_tensor(np.asarray(a)).to(self.device), c)
            for c in carries]

    def rnn_time_step(self, x) -> np.ndarray:
        """Stateful streaming inference: ``x`` (b, T, size) or one step (b,
        size), continuing from the state the last call left."""
        x = self._as_input(x)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        if self._rnn_carries is None:
            # the input's dtype, as the reference (which has no float64)
            dt = torch.float32 if x.dtype == torch.float64 else x.dtype
            self._rnn_carries = self._init_carries(x.shape[0], dt)
        with torch.inference_mode():
            y, _, self._rnn_carries = self._forward(self.params_, self.state_, x,
                                                    carries=self._rnn_carries)
        y = self._host(y)
        return y[:, -1, :] if squeeze else y

    # ------------------------------------------------------- params utilities
    def num_params(self) -> int:
        return int(sum(t.numel() for p in self.params_ for t in tensor_leaves(p)))

    def summary(self) -> str:
        """Layer table: index, layer, input -> output type, #params."""
        types = self.conf.layer_types()
        rows = [("idx", "layer", "input", "output", "params")]
        total = 0
        for i, layer in enumerate(self.layers):
            n = (int(sum(t.numel() for t in tensor_leaves(self.params_[i])))
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



def flatten_tensors(groups) -> np.ndarray:
    """Tensors of a list of dicts (or a dict of dicts, walked in the caller's
    order) as one f32 vector: group by group, names sorted (nested dicts
    in place, :func:`tensor_leaves`)."""
    groups = groups.values() if isinstance(groups, dict) else groups
    chunks = [t.detach().float().cpu().numpy().reshape(-1)
              for g in groups for t in tensor_leaves(g)]
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)


def unflatten_tensors(groups, vec: np.ndarray):
    """The inverse of :func:`flatten_tensors`: new tensors of each tensor's
    shape, dtype and device, read from ``vec`` in the same order."""
    vec = np.asarray(vec, np.float32)
    off = 0

    def take(t: torch.Tensor) -> torch.Tensor:
        nonlocal off
        n = t.numel()
        if off + n > vec.size:
            raise ValueError(f"Param vector length {vec.size} is shorter than "
                             "the model")
        out = torch.tensor(vec[off:off + n].reshape(tuple(t.shape)),
                           dtype=t.dtype, device=t.device)
        off += n
        return out

    def rebuild(g):
        return {name: rebuild(g[name]) if isinstance(g[name], dict) else take(g[name])
                for name in sorted(g)}

    if isinstance(groups, dict):
        out = {key: rebuild(g) for key, g in groups.items()}
    else:
        out = [rebuild(g) for g in groups]
    if off != vec.size:
        raise ValueError(f"Param vector length {vec.size} != model size {off}")
    return out
