"""Batch statistics over the global batch of a data-parallel step.

The reference's data-parallel step is one program over the batch sharded
across devices, so a train-mode layer with batch statistics
(``BatchNormalization``, the fused ResNet bottleneck) takes them over the
global batch. Here each rank runs its own rows; a train step that spans
several ranks runs its loss and gradient half inside :func:`across_ranks`,
handing it a differentiable sum over the ranks, and the layers pass their
per-channel sums through :func:`global_sums` before they divide by the
global row count. Outside such a step the layers take their own rows'
statistics, as in a one-process ``fit``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, Optional, Sequence, Tuple

import torch

#: (sum over the ranks of a list of tensors, number of ranks), or None
_ranks: "contextvars.ContextVar[Optional[Tuple[Callable, int]]]" = contextvars.ContextVar(
    "batch_stats_ranks", default=None)


@contextlib.contextmanager
def across_ranks(all_reduce_sum: Callable[[Sequence[torch.Tensor]], List[torch.Tensor]],
                 n_ranks: int):
    """Inside: train-mode layers sum their statistics over ``n_ranks``
    ranks with ``all_reduce_sum`` (each rank calls it at the same sites, in
    the same order; its backward sums the cotangent over the ranks)."""
    token = _ranks.set((all_reduce_sum, int(n_ranks)))
    try:
        yield
    finally:
        _ranks.reset(token)


def crosses_ranks() -> bool:
    """Whether the statistics are taken over more than this rank's rows."""
    return _ranks.get() is not None


def global_sums(sums: Sequence[torch.Tensor], rows: int) -> Tuple[List[torch.Tensor], int]:
    """This rank's per-channel ``sums`` over its ``rows`` rows -> the sums
    and the row count of the global batch (unchanged outside
    :func:`across_ranks`)."""
    ranks = _ranks.get()
    if ranks is None:
        return list(sums), rows
    all_reduce_sum, n_ranks = ranks
    return all_reduce_sum(sums), rows * n_ranks
