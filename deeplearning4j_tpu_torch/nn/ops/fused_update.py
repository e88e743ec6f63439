"""One-pass Adam for the ZeRO-1 sharded update: a hand-written CUDA kernel
for Hopper beside its plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/nn/ops/fused_update.py``::

    m' = b1*m + (1-b1)*g
    v' = b2*v + ((1-b2)*g)*g
    p' = p - (alpha*m') / (sqrt(v') + eps)     alpha = lr*sqrt(1-b2^t)/(1-b1^t)

over a flat f32 group of the sharded update (``parallel/zero.py``). The
eager composition reads and writes the whole group once per operation (~10
passes); the kernel (``csrc/fused_update.cu``, which replaces the
reference's ``_adam_kernel``) reads p, g, m, v once and writes p', m', v'
once. alpha is computed outside the kernel by exactly the eager updater's
scalar pipeline (:meth:`updaters.Adam.alpha`, which is the reference's
``_adam_alpha``), so the kernel is bit-exact against ``Adam.apply``: the
contract the reference's probe asserts (``array_equal`` on params and both
slots, zero padding lanes included).

Dispatch: :func:`fused_adam_apply` takes the plain version
(:func:`fused_adam_plain`, the eager composition of ``Adam.apply``) for CPU
tensors, and for CUDA tensors launches the kernel or raises: there is no
fallback, no probe and no switch (the port has no kernel registry, ROADMAP §
B0). Each launch adds one to ``launch_counts["fused_adam"]`` (``launch.py``).
:func:`resolve_group_impls` gives the sharded step one impl per layout
group: exact-type ``Adam`` groups in f32 take the fused update, every other
group ``None`` (the reference's ``updater.apply``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.ops.launch import (
    KernelLibrary,
    check_kernel_args,
    launch,
    ptrs,
    sm_count,
)

OP = "fused_adam"

#: grid cap of the one-pass kernel: blocks per SM (grid-stride beyond it)
BLOCKS_PER_SM = 8

_LIB = KernelLibrary("fused_update", {"dl4j_fused_adam": (7, 2, 6)},
                     "dl4j_fused_adam_tile", tile_keys="tv")

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fused_adam_plain(p, g, m, v, alpha, *, b1: float, b2: float,
                     eps: float) -> Triple:
    """The eager composition of ``Adam.apply`` and ``param - update``, in
    its order of operations (the CPU path, and the oracle the kernel is
    held to)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return p - alpha * m / (torch.sqrt(v) + eps), m, v


def _kernel(p, g, m, v, alpha, b1: float, b2: float, eps: float) -> Triple:
    shape = tuple(p.shape)
    check_kernel_args(OP, p, tuple((name, t, torch.float32, shape)
                                   for name, t in (("p", p), ("g", g), ("m", m), ("v", v))))
    n = p.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{OP}: {n} elements; the kernel takes fewer than 2^31")
    lib = _LIB.get()
    with torch.cuda.device(p.device):
        out = tuple(torch.empty_like(p) for _ in range(3))
        if n:
            # the scalars as torch hands Python floats to its f32 kernels:
            # 1-b1, 1-b2 in double, each rounded once to f32 by ctypes
            launch(lib.dl4j_fused_adam, OP,
                   (*ptrs(p, g, m, v, *out), n,
                    sm_count(p.device.index or 0) * BLOCKS_PER_SM,
                    float(alpha), float(b1), float(1 - b1), float(b2), float(1 - b2),
                    float(eps)))
    return out


def fused_adam_apply(p, g, m, v, alpha, *, b1: float, b2: float,
                     eps: float) -> Triple:
    """One-pass Adam over same-shaped f32 tensors (the flat chunk of a
    sharded update group). ``alpha`` is the bias-corrected step size (a
    0-dim f32 tensor or a float holding an f32 value). Returns fresh ``(p',
    m', v')``; the inputs are not changed. CPU tensors take the plain
    version; CUDA tensors the kernel (contiguous f32 on one device), or it
    raises."""
    if p.device.type == "cpu":
        return fused_adam_plain(p, g, m, v, alpha, b1=b1, b2=b2, eps=eps)
    return _kernel(p, g, m, v, alpha, b1, b2, eps)


# ---------------------------------------------------------------------------
# group-level impl (wired from parallel/zero.py)
# ---------------------------------------------------------------------------
def _make_impl() -> Callable:
    def impl(upd, p2d, g2d, state, t, iteration, epoch):
        # EXACTLY Adam.apply's scalar pipeline: both call Adam.alpha
        alpha = upd.alpha(t, iteration, epoch)
        new_p, m, v = fused_adam_apply(p2d, g2d, state["m"], state["v"], alpha,
                                       b1=upd["beta1"], b2=upd["beta2"],
                                       eps=upd["epsilon"])
        return new_p, {"m": m, "v": v}
    return impl


def resolve_group_impls(layout) -> List[Optional[Callable]]:
    """One fused-update impl (or None: the reference ``updater.apply``) per
    layout group, resolved once when the step is built: exact-type ``Adam``
    groups in f32 take the fused update. (The reference also takes its
    mesh, to run its probe under it, and an opt-out; the port has neither.)"""
    from deeplearning4j_tpu_torch.updaters import Adam, as_updater

    return [_make_impl() if type(as_updater(grp.updater)) is Adam
            and grp.dtype == torch.float32 else None
            for grp in layout.groups]
