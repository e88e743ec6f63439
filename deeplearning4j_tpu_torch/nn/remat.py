"""Rematerialization of a train step's forward (``remat_policy``).

The reference wraps its whole loss in ``jax.checkpoint(policy=...)``
(``deeplearning4j_tpu/nn/multilayer.py`` ``_resolve_remat_policy``); XLA
then keeps what the policy saves and recomputes the rest in the backward.
Here the train-mode forward checkpoints each layer (each layer vertex of a
graph) as its own region, through ``torch.utils.checkpoint`` without
reentry: a region keeps its inputs, and the first time the backward needs
one of its tensors it reruns the region's forward. A region is one layer
because a non-reentrant region recomputes all of itself at once: one region
over the network would hold every recomputed activation together and the
peak would not fall.

The policies, as the reference's:

- ``"nothing"`` (``nothing_saveable``): a region keeps only its inputs.
- ``"dots"`` (``dots_saveable``): the outputs of the matrix products and
  convolutions (``aten`` ``mm``, ``addmm``, ``bmm``, ``convolution``, ...)
  are kept, everything else is recomputed. As in the reference, no
  hand-written kernel's output is kept: the kernels are bound through
  ``ctypes``, so a dispatch-level policy sees only the ``empty`` tensors
  they fill; the kernel's whole autograd function (the fused conv, flash
  attention) reruns in the recompute, as JAX reruns a ``pallas_call``.
- ``"save_conv_outputs"`` (``save_only_these_names("conv_out")``): only
  what the layers name ``"conv_out"`` is kept (:func:`checkpoint_name`:
  ``ConvolutionLayer``'s raw convolution, before its bias and activation).
  Nothing else is named, so a ``FusedResNetBottleneck`` is recomputed.

The two selective policies run their regions under
``create_selective_checkpoint_contexts``. A kept op is not rerun in the
recompute (its output comes from the cache), so :func:`checkpoint_name`
names the op that makes the tensor, where the reference names the tensor
after it is made: the same tensor is kept.

What a region recomputes is what its first run computed, bit for bit: the
dropout draws are counter-based (``nn/conf/dropouts.NoiseSource``), so no
generator state is saved or restored (``preserve_rng_state=False``, which
a captured CUDA graph also needs); a layer's new state (BN's running
statistics) is returned, never written in place, and the step keeps the
first run's. The recompute runs in a copy of the context the region was
entered in (it may run on autograd's device thread), so inside a
data-parallel step it takes the cross-rank batch statistics again
(``nn/batch_stats.py``): every rank recomputes the same regions in the same
order, and repeats their statistics collectives.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Callable, FrozenSet, Optional

import torch
from torch.utils import checkpoint as _ckpt

#: the environment variable that overrides every configuration's policy
ENV = "DL4J_TPU_REMAT"

#: the ops whose outputs ``"dots"`` keeps (the reference's ``dot_general``
#: and ``conv_general_dilated``)
_DOT_OPS = frozenset(getattr(torch.ops.aten, n) for n in (
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "convolution"))

#: the name of the tensor the ops in scope make (:func:`checkpoint_name`)
_scope: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "remat_checkpoint_name", default=None)


class RematPolicy:
    """A resolved ``remat_policy``: ``name``, whether matrix products and
    convolutions are kept (``dots``) and the names kept (``saved_names``).
    One instance a policy (:data:`POLICIES`), so they compare by identity."""

    def __init__(self, name: str, dots: bool = False, saved_names: FrozenSet[str] = frozenset()):
        self.name, self.dots, self.saved_names = name, bool(dots), frozenset(saved_names)

    def __repr__(self):
        return f"RematPolicy({self.name!r})"

    def selective(self, layer) -> bool:
        """Whether ``layer``'s region keeps anything but its inputs."""
        return self.dots or bool(self.saved_names & set(getattr(layer, "checkpoint_names", ())))

    def _keep(self, ctx, op, *args, **kwargs):
        keep = (self.dots and op.overloadpacket in _DOT_OPS) or _scope.get() in self.saved_names
        return _ckpt.CheckpointPolicy.MUST_SAVE if keep else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    def region(self, layer, fn: Callable, *args):
        """``fn(*args)`` as one checkpointed region of ``layer``: its
        outputs, with what the backward needs recomputed under this
        policy."""
        ctx = contextvars.copy_context()
        kw = {}
        if self.selective(layer):
            kw["context_fn"] = lambda: _ckpt.create_selective_checkpoint_contexts(self._keep)
        return _ckpt.checkpoint(lambda *a: ctx.run(fn, *a), *args, use_reentrant=False,
                                preserve_rng_state=False, **kw)


POLICIES = {
    "save_conv_outputs": RematPolicy("save_conv_outputs", saved_names=frozenset({"conv_out"})),
    "dots": RematPolicy("dots", dots=True),
    "nothing": RematPolicy("nothing"),
}


def resolve(name) -> Optional[RematPolicy]:
    """``name`` (a configuration's ``remat_policy``), or the ``DL4J_TPU_REMAT``
    environment variable when it is set, as a :class:`RematPolicy`; None
    (or "none") is no rematerialization. Any other name raises
    ``ValueError``, as the reference's."""
    name = os.environ.get(ENV) or name
    if not name or name == "none":
        return None
    if name not in POLICIES:
        raise ValueError(f"unknown remat_policy: {name!r}")
    return POLICIES[name]


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the tensors the ops inside make (the reference's
    ``checkpoint_name(y, name)``): a region whose policy keeps ``name``
    keeps them; elsewhere this changes nothing."""
    token = _scope.set(name)
    try:
        yield
    finally:
        _scope.reset(token)
