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
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import resolve_device

# torch renamed the single-tensor collectives; the machines differ in version
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class MeshInitError(RuntimeError):
    """The process group could not be set up, or does not fit the run."""


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
        have = dist.get_backend()
        if backend not in str(have):
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

    # -- collectives (every rank calls each, in the same order) -------------
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

    def reduce_scatter_mean(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows`` (n_data, chunk): this rank's row of the mean over the
        ranks, as (1, chunk)."""
        out = torch.empty((1,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
        _reduce_scatter(out, rows.contiguous())
        if self.n_data > 1:
            out.div_(self.n_data)
        return out

    def all_gather(self, row: torch.Tensor) -> torch.Tensor:
        """Each rank's (1, chunk) row, stacked in rank order: (n_data, chunk)."""
        out = torch.empty((self.n_data,) + tuple(row.shape[1:]), dtype=row.dtype,
                          device=row.device)
        _all_gather(out, row.contiguous())
        return out

    def __repr__(self):
        return f"TrainingMesh(rank={self.rank}, n_data={self.n_data}, device={self.device})"
