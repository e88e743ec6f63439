"""Carry weights between the JAX package and the port, both ways.

The two packages draw different random numbers from the same seed, so a
model moves between them by its arrays, never by its seed. Arrays travel as
nested dicts of numpy arrays (vertex name -> param name -> array; updater
state one level deeper, param name -> slot name -> array), e.g.
``jax.tree_util.tree_map(np.asarray, graph.params_)`` on the reference's
side. Layouts are the same in both packages (HWIO conv weights, (nIn, nOut)
dense weights), so no array is transposed.

- :func:`load_jax_params` fills the port's graph with the reference's
  ``params_``, ``state_`` and, optionally, its ``opt_state_`` and
  ``iteration`` (to continue a run).
- :func:`export_params`, :func:`export_state`, :func:`export_opt_state`
  give the port's arrays in that form, for the reference or a test.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _fill(name: str, mine: dict, theirs: Mapping) -> None:
    """Replace every tensor of the nested dict ``mine`` with the array at
    the same path of ``theirs``; the key sets and shapes must agree."""
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
    state and the iteration count) with the reference's arrays: same vertex
    names, param names, slot names and shapes, or it raises."""
    if model.params_ is None:
        raise ValueError("init() the port's model first: it fixes the device "
                         "and the expected names and shapes")
    _fill("params", model.params_, params)
    _fill("state", model.state_, state)
    if opt_state is not None:
        _fill("opt_state", model._ensure_opt_state(), opt_state)
    if iteration is not None:
        model.iteration = int(iteration)


def _numpy(tree) -> dict:
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy() if tree.is_floating_point() \
        else tree.detach().cpu().numpy()


def export_params(model) -> dict:
    """``model.params_`` as nested numpy dicts (float tensors as f32)."""
    return _numpy(model.params_)


def export_state(model) -> dict:
    return _numpy(model.state_)


def export_opt_state(model) -> dict:
    """The updater slots (made now if no train step ran yet: zeros)."""
    return _numpy(model._ensure_opt_state())
