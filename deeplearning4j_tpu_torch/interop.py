"""Carry weights between the JAX package and the port, both ways.

The two packages draw different random numbers from the same seed, so a
model moves between them by its arrays, never by its seed. Arrays travel as
the model's own layout of numpy arrays: for a ComputationGraph nested dicts
(vertex name -> param name -> array), for a MultiLayerNetwork a list (per
layer) of dicts (recurrent layers: ``Wx``, ``Wh``, ``b`` and a GravesLSTM's
``pI``/``pF``/``pO``; a Bidirectional layer nests its two copies under
``"fwd"``/``"bwd"``), for a TransformerLM the reference's nested dict
(``embed``, ``pos``, ``blocks`` of ``(n_layers, ...)`` stacks, ``lnf_g``,
``lnf_b``, ``head``; no state, so ``state`` is None); updater state one
level deeper (param name -> slot name -> array; a TransformerLM's Adam
slots ``{"m", "v"}`` under each leaf of its params' layout). On the reference's side
that is e.g. ``jax.tree_util.tree_map(np.asarray, net.params_)``. Layouts are the same in
both packages (HWIO conv weights, (nIn, nOut) dense weights, NHWC
flattening), so no array is transposed.

- :func:`load_jax_params` fills the port's model with the reference's
  ``params_``, ``state_`` and optionally its ``opt_state_`` and
  ``iteration`` (to continue a run; a MultiLayerNetwork, a graph or a
  TransformerLM).
- :func:`export_params`, :func:`export_state`, :func:`export_opt_state`
  give the port's arrays in that form, for the reference or a test.
- :func:`export_serving_params` gives an engine's serving snapshot (int8
  heads as ``W_q8``/``W_scale``), to hold against the reference's
  ``quantize_model_params``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _fill(name: str, mine, theirs) -> None:
    """Replace every tensor of the nested dict/list ``mine`` with the array
    at the same path of ``theirs``; the keys (lengths) and shapes must
    agree."""
    if isinstance(mine, list):
        if len(mine) != len(theirs):
            raise KeyError(f"{name}: {len(mine)} layers in the port, "
                           f"{len(theirs)} in the reference")
        for i, m in enumerate(mine):
            _fill(f"{name}[{i}]", m, theirs[i])
        return
    if set(mine) != set(theirs):
        raise KeyError(f"{name}: keys differ: port-only {sorted(set(mine) - set(theirs))}, "
                       f"reference-only {sorted(set(theirs) - set(mine))}")
    for key, t in mine.items():
        where = f"{name}[{key!r}]"
        if isinstance(t, dict):
            _fill(where, t, theirs[key])
            continue
        a = np.asarray(theirs[key])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{where}: shape {tuple(a.shape)} != {tuple(t.shape)}")
        # a copy: the model never aliases the caller's arrays
        mine[key] = torch.tensor(a, dtype=t.dtype, device=t.device)


def load_jax_params(model, params, state, opt_state: Optional[Mapping] = None,
                    iteration: Optional[int] = None) -> None:
    """Replace ``model.params_``/``state_`` (and, when given, the updater
    state and the iteration count) with the reference's arrays: same layer
    or vertex names, param names, slot names and shapes, or it raises."""
    if model.params_ is None:
        raise ValueError("init() the port's model first: it fixes the device "
                         "and the expected names and shapes")
    _fill("params", model.params_, params)
    if model.state_ is not None or state is not None:
        _fill("state", model.state_, state)
    if opt_state is not None:
        _fill("opt_state", model._ensure_opt_state(), opt_state)
    if iteration is not None:
        model.iteration = int(iteration)


def _numpy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.detach().float().cpu().numpy() if tree.is_floating_point() \
        else tree.detach().cpu().numpy()


def export_params(model):
    """``model.params_`` as numpy (float tensors as f32)."""
    return _numpy(model.params_)


def export_state(model):
    return _numpy(model.state_)


def export_opt_state(model):
    """The updater slots (made now if no train step ran yet: zeros)."""
    return _numpy(model._ensure_opt_state())


def export_serving_params(engine):
    """The params of ``engine``'s live snapshot as numpy, in the model's
    layout: int8 ``W_q8`` as int8, every float (``W_scale`` too) as f32."""
    return _numpy(engine._snap.params)
