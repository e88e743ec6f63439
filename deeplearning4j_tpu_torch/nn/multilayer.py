"""The per-layer update pipeline shared by the train steps.

Counterpart of the part of ``deeplearning4j_tpu/nn/multilayer.py`` that
``ComputationGraph`` uses (``_apply_layer_updates``). ``MultiLayerNetwork``
itself comes with its own slice (ROADMAP § A).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from deeplearning4j_tpu_torch.regularization import (
    as_regularization,
    normalize_layer_gradients,
)
from deeplearning4j_tpu_torch.updaters import as_updater

Tensors = Dict[str, torch.Tensor]


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
