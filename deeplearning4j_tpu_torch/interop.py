"""Carry weights across from the JAX package.

The two packages draw different random numbers from the same seed, so a
model moves between them by its parameters, never by its seed.
:func:`load_jax_params` takes a reference ComputationGraph's ``params_`` and
``state_`` as nested dicts of numpy arrays (vertex name -> param name ->
array; e.g. ``jax.tree_util.tree_map(np.asarray, graph.params_)``) and
fills the port's graph with them. Layouts are the same in both packages
(HWIO conv weights, (nIn, nOut) dense weights), so no array is transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _fill(name: str, mine: Dict[str, Dict[str, torch.Tensor]],
          theirs: Mapping[str, Mapping[str, np.ndarray]]) -> None:
    if set(mine) != set(theirs):
        raise KeyError(f"{name}: vertex sets differ: port-only "
                       f"{sorted(set(mine) - set(theirs))}, reference-only "
                       f"{sorted(set(theirs) - set(mine))}")
    for vertex, tensors in mine.items():
        src = theirs[vertex]
        if set(tensors) != set(src):
            raise KeyError(f"{name}[{vertex!r}]: names differ: {sorted(tensors)} "
                           f"vs {sorted(src)}")
        for k, t in tensors.items():
            a = np.asarray(src[k])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{name}[{vertex!r}][{k!r}]: shape "
                                 f"{tuple(a.shape)} != {tuple(t.shape)}")
            # a copy: the model never aliases the caller's arrays
            tensors[k] = torch.tensor(a, dtype=t.dtype, device=t.device)


def load_jax_params(model, params, state) -> None:
    """Replace ``model.params_``/``model.state_`` values with the reference's
    arrays (same vertex names, param names and shapes, or it raises)."""
    if model.params_ is None:
        raise ValueError("init() the port's model first: it fixes the device "
                         "and the expected names and shapes")
    _fill("params", model.params_, params)
    _fill("state", model.state_, state)
