"""The data axis of a data-parallel run, over a ``torch.distributed``
process group.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py`` (``TrainingMesh``,
its "data" axis). The reference runs one program over a device mesh and
XLA inserts the collectives; here one process drives one device (a rank),
and the collectives are ``torch.distributed`` calls on the default process
group: NCCL between cards, gloo between CPU processes. A run over several
cards starts one process per rank (``torchrun``, or any launcher that sets
up the default group first); without a group, ``TrainingMesh(workers=1)``
makes a one-rank group in this process (from a ``HashStore``), so even a
single-card run goes through the same ``all_reduce``, ``reduce_scatter``
and ``all_gather`` as a multi-card one.

Batch statistics: the reference's program takes a train-mode BN layer's
statistics over the global batch. Here a train step runs its loss and
gradient half inside :meth:`TrainingMesh.batch_stats`, which on more than
one rank hands :meth:`TrainingMesh.all_reduce_sum` to the layers with
batch statistics (``BatchNormalization``, the fused ResNet bottleneck,
through ``nn/batch_stats.py``); they sum their per-channel sums over the
ranks before they divide by the global row count. On one rank the sum is
the identity, so no collective runs and the layers take their own rows'
statistics, the global batch's.

A default group whose backend is gloo also takes CUDA tensors, if the
caller set it up (two ranks sharing one card, where NCCL refuses): gloo
then stages each ``all_reduce`` through the host, and has no
``reduce_scatter`` or ``all_gather`` for CUDA tensors, nor a collective a
CUDA graph can capture. Such a mesh serves the replicated update only; the
sharded and bundled paths refuse it (:meth:`TrainingMesh.refuse_host_staged`).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn import batch_stats as _batch_stats
from deeplearning4j_tpu_torch.nn.ops import launch as _launch

# torch renamed the single-tensor collectives; the machines differ in version
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


#: ``launch_counts`` names of the batch-statistics collectives: the forward
#: sum and the backward sum of its cotangent, one each per site and step
STATS_FORWARD = "stats_all_reduce"
STATS_BACKWARD = "stats_all_reduce_grad"


class MeshInitError(RuntimeError):
    """The process group could not be set up, or does not fit the run."""


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward is the same sum of the cotangent.

    Rank r's loss L_r (the mean over its rows) reads the sums S = Σ_q s_q.
    The backward hands rank r Σ_q ∂L_q/∂S for its own s_r, so the ranks'
    gradients add up to d(Σ_q L_q)/dθ, and the wrapper's mean of them is the
    gradient of the global batch's loss (1/n) Σ_q L_q."""

    @staticmethod
    def forward(ctx, flat):
        out = flat.clone()
        dist.all_reduce(out)
        _launch.launch_counts[STATS_FORWARD] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        _launch.launch_counts[STATS_BACKWARD] += 1
        return grad


class TrainingMesh:
    """This process's rank on the data axis: ``rank``, ``n_data`` (the
    world size) and ``device`` (the rank's device, where the model lives).
    ``workers``: the number of ranks the caller expects (None: whatever the
    group has)."""

    def __init__(self, workers: Optional[int] = None, device=None):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        backend = "nccl" if device.type == "cuda" else "gloo"
        if not dist.is_initialized():
            if workers not in (None, 1):
                raise MeshInitError(
                    f"workers={workers} needs {workers} processes, one per rank, "
                    "with the default process group set up first (torchrun)")
            kw = {"device_id": device} if device.type == "cuda" else {}
            try:
                dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                        world_size=1, **kw)
            except Exception as e:  # noqa: BLE001 — any init failure is typed here
                raise MeshInitError(f"cannot set up a one-rank {backend} group: {e}") from e
        have = str(dist.get_backend())
        #: gloo on CUDA tensors: every collective staged through the host
        self.host_staged = device.type == "cuda" and "gloo" in have
        if backend not in have and not self.host_staged:
            raise MeshInitError(f"the process group's backend is {have!r}; tensors on "
                                f"{device.type} need {backend}")
        self.rank = dist.get_rank()
        self.n_data = dist.get_world_size()
        if workers is not None and workers != self.n_data:
            raise MeshInitError(f"workers={workers}, but the process group has "
                                f"{self.n_data} ranks")
        self.device = device
        # the group must come up here, not at the first train step
        try:
            dist.all_reduce(torch.zeros(1, device=device))
        except Exception as e:  # noqa: BLE001
            raise MeshInitError(f"{backend} collective failed on {device}: {e}") from e

    def refuse_host_staged(self, what: str, lacking: str) -> None:
        """Raise :class:`MeshInitError` where ``what`` needs ``lacking``,
        which gloo does not have for CUDA tensors."""
        if self.host_staged:
            raise MeshInitError(
                f"{what} needs {lacking}, which gloo lacks for CUDA tensors; with two "
                "ranks on one card only the replicated update runs (one card per rank "
                "takes NCCL)")

    def batch_stats(self):
        """A context inside which train-mode layers take their batch
        statistics over the global batch of this mesh's ranks; on one rank
        their own rows are that batch, and the context sets nothing."""
        if self.n_data == 1:
            return contextlib.nullcontext()
        return _batch_stats.across_ranks(self.all_reduce_sum, self.n_data)

    # -- collectives (every rank calls each, in the same order) -------------
    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the ranks of each tensor, differentiable (the
        backward is the sum of the cotangent over the ranks, see
        :class:`_AllReduceSum`): one collective for all of them, in their
        common dtype."""
        flat = _AllReduceSum.apply(torch.cat([t.reshape(-1) for t in tensors]))
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
        return out

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each tensor (one f32 collective for
        all of them); the inputs are not changed."""
        if not tensors:
            return []
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        dist.all_reduce(flat)
        if self.n_data > 1:
            flat.div_(self.n_data)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
        return out

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-dim bool that is true iff ``flag`` is true on every rank (one
        collective on more than one rank; on one rank, ``flag``)."""
        if self.n_data == 1:
            return flag
        bad = (~flag).to(torch.float32).reshape(1)
        dist.all_reduce(bad)
        return bad[0] == 0

    def reduce_scatter_mean(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows`` (n_data, chunk): this rank's row of the mean over the
        ranks, as (1, chunk)."""
        self.refuse_host_staged("reduce_scatter_mean", "reduce_scatter")
        out = torch.empty((1,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
        _reduce_scatter(out, rows.contiguous())
        if self.n_data > 1:
            out.div_(self.n_data)
        return out

    def all_gather(self, row: torch.Tensor) -> torch.Tensor:
        """Each rank's (1, chunk) row, stacked in rank order: (n_data, chunk)."""
        self.refuse_host_staged("all_gather", "all_gather")
        out = torch.empty((self.n_data,) + tuple(row.shape[1:]), dtype=row.dtype,
                          device=row.device)
        _all_gather(out, row.contiguous())
        return out

    def __repr__(self):
        return f"TrainingMesh(rank={self.rank}, n_data={self.n_data}, device={self.device})"
