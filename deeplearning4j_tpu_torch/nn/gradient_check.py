"""Numerical gradient checking.

Counterpart of ``deeplearning4j_tpu/nn/gradient_check.py`` (reference
``gradientcheck/GradientCheckUtil.java:109`` for a MultiLayerNetwork,
``:331`` for a ComputationGraph): every parameter is perturbed by ±ε in
float64 and the central difference is compared with the analytic gradient
(autograd) by relative error. The whole computation runs in float64 on the
model's device: params, layer state, features and labels are copied to
float64 and the forward keeps float inputs in float64 (the model's
``_input_dtype``; an ordinary forward casts them to the params' dtype,
which is f32 even for a ``"float64"`` configuration, as the reference's with
x64 off). Every evaluation uses the same noise source (seed ``rng_seed``,
position 0), so dropout and weight-noise layers see the same masks each
time, as the reference requires deterministic layers. Meant for tiny nets:
the check runs two forwards per parameter element.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.dropouts import NoiseSource

DEFAULT_EPS = 1e-6
DEFAULT_MAX_REL_ERROR = 1e-3
DEFAULT_MIN_ABS_ERROR = 1e-8

F64 = torch.float64


def _to64(tree, device):
    if isinstance(tree, dict):
        return {k: _to64(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to64(v, device) for v in tree)
    if tree is None:
        return None
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.asarray(tree))
    t = t.detach().to(device)
    return t.to(F64) if t.is_floating_point() else t


def _central_difference_check(loss_fn: Callable, params64, keys: Iterable, eps: float,
                              max_rel_error: float, min_abs_error: float,
                              print_results: bool) -> bool:
    """The shared ±ε loop over ``params64[key][name]`` for each key in
    ``keys`` (a layer index or a vertex name). ``loss_fn(params)`` returns a
    0-dim float64 tensor."""
    keys = list(keys)
    leaves = [(key, name) for key in keys for name in params64[key]]
    diff = {(key, name): params64[key][name].detach().clone().requires_grad_()
            for key, name in leaves}

    def with_leaves(values):
        out = (type(params64)(params64) if isinstance(params64, dict)
               else list(params64))
        for key in keys:
            out[key] = dict(params64[key])
        for (key, name), v in values.items():
            out[key][name] = v
        return out

    loss = loss_fn(with_leaves(diff))
    grads = torch.autograd.grad(loss, list(diff.values()), allow_unused=True)
    analytic = {leaf: (torch.zeros_like(diff[leaf]) if g is None else g).detach()
                for leaf, g in zip(leaves, grads)}
    total = failed = 0
    max_err_seen = 0.0
    with torch.no_grad():
        for key, name in leaves:
            base = params64[key][name].detach()
            flat = base.reshape(-1).clone()
            g_flat = analytic[(key, name)].reshape(-1).cpu().numpy()
            for j in range(flat.numel()):
                orig = flat[j].item()
                flat[j] = orig + eps
                s_plus = float(loss_fn(with_leaves({(key, name): flat.reshape(base.shape)})))
                flat[j] = orig - eps
                s_minus = float(loss_fn(with_leaves({(key, name): flat.reshape(base.shape)})))
                flat[j] = orig
                numeric = (s_plus - s_minus) / (2 * eps)
                analytic_g = float(g_flat[j])
                denom = abs(numeric) + abs(analytic_g)
                rel = abs(numeric - analytic_g) / denom if denom > 0 else 0.0
                total += 1
                if rel > max_rel_error and abs(numeric - analytic_g) > min_abs_error:
                    failed += 1
                    if print_results:
                        print(f"FAIL {key} param {name}[{j}]: analytic={analytic_g:.8g} "
                              f"numeric={numeric:.8g} rel={rel:.4g}")
                max_err_seen = max(max_err_seen, rel)
    if print_results:
        print(f"Gradient check: {total - failed}/{total} passed; max rel err "
              f"{max_err_seen:.3g}")
    return failed == 0


class _Float64Inputs:
    """The model's forward keeps float inputs in float64 inside the block."""

    def __init__(self, net):
        self.net = net

    def __enter__(self):
        self.prev, self.net._input_dtype = self.net._input_dtype, F64

    def __exit__(self, *exc):
        self.net._input_dtype = self.prev


def check_gradients(net, ds, eps: float = DEFAULT_EPS,
                    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                    print_results: bool = False, rng_seed: int = 12345) -> bool:
    """Analytic vs numerical gradients of a MultiLayerNetwork on DataSet
    ``ds`` (train-mode loss plus the regularization score). Returns True if
    every parameter passes."""
    dev = net.device
    params64: List[Dict[str, torch.Tensor]] = _to64(net.params_, dev)
    state64 = _to64(net.state_, dev)
    f, lab, fm, lm = (_to64(a, dev) for a in (ds.features, ds.labels, ds.features_mask,
                                               ds.labels_mask))
    noise = NoiseSource(rng_seed, 0)

    def loss_fn(p):
        loss, _ = net._loss_and_new_state(p, state64, f, lab, fm, lm, train=True, noise=noise)
        return loss + net._reg_score(p)

    with _Float64Inputs(net):
        return _central_difference_check(loss_fn, params64, range(len(params64)), eps,
                                         max_rel_error, min_abs_error, print_results)


def check_gradients_graph(net, mds, eps: float = DEFAULT_EPS,
                          max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                          min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                          print_results: bool = False, rng_seed: int = 12345) -> bool:
    """The ComputationGraph analog (reference ``GradientCheckUtil.java:331``);
    ``mds`` is a MultiDataSet or a DataSet."""
    from deeplearning4j_tpu_torch.nn.graph import _as_multi

    mds = _as_multi(mds)
    dev = net.device
    params64 = _to64(net.params_, dev)
    state64 = _to64(net.state_, dev)
    feats = [_to64(a, dev) for a in mds.features]
    labels = [_to64(a, dev) for a in mds.labels]
    fmasks = [_to64(a, dev) for a in mds.features_masks]
    lmasks = [_to64(a, dev) for a in mds.labels_masks]
    noise = NoiseSource(rng_seed, 0)

    def loss_fn(p):
        loss, _ = net._loss_and_new_state(p, state64, feats, labels, fmasks, lmasks,
                                          train=True, noise=noise)
        return loss + net._reg_score(p)

    with _Float64Inputs(net):
        return _central_difference_check(loss_fn, params64, list(net.layer_names), eps,
                                         max_rel_error, min_abs_error, print_results)
