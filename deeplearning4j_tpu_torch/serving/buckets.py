"""Shape-bucket policy: pad dispatched batches onto a fixed shape set.

A near-copy of ``deeplearning4j_tpu/serving/buckets.py`` (numpy only), for
the batch axis: every dispatched batch is rounded up to one of a small set
of batch **buckets**, the tail padded with zero rows, and the results
sliced back. Under XLA each shape is a compiled program; on the card a
fixed shape set keeps the kernel launch shapes and allocator blocks bounded
(and, in a later slice, the captured CUDA graphs). Sequence-length buckets,
which need feature masks, come with the recurrent slice (ROADMAP § A).

Padding rows never leak into real results: an eval forward is
row-independent (no cross-batch statistics).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _pow2_buckets(limit: int) -> List[int]:
    out, b = [], 1
    limit = max(int(limit), 1)
    while b < limit:
        out.append(b)
        b *= 2
    out.append(limit)
    return out


class BucketPolicy:
    """Quantizes dispatched batches onto a fixed shape set.

    - ``batch_buckets``: explicit ascending batch sizes, or None for powers
      of two up to ``max_batch``; when both are given ``max_batch`` is
      unioned in.
    - Oversized requests round up to the next power of two beyond the list
      and the grown bucket is remembered. The policy never truncates data.
    """

    def __init__(self, batch_buckets: Optional[Sequence[int]] = None,
                 max_batch: Optional[int] = None):
        if batch_buckets is not None:
            bb = sorted({int(b) for b in batch_buckets})
            if not bb or bb[0] < 1:
                raise ValueError(f"batch_buckets must be positive: {batch_buckets}")
            if max_batch is not None and bb[-1] < int(max_batch):
                bb.append(int(max_batch))
        else:
            bb = _pow2_buckets(32 if max_batch is None else max_batch)
        self.batch_buckets: List[int] = bb

    def copy(self) -> "BucketPolicy":
        return BucketPolicy(batch_buckets=self.batch_buckets)

    def bucket_for(self, n: int) -> int:
        """Smallest batch bucket >= n (grows the list past its top)."""
        n = int(n)
        for b in self.batch_buckets:
            if n <= b:
                return b
        b = self.batch_buckets[-1]
        while b < n:
            b *= 2
        self.batch_buckets.append(b)
        return b

    def pad_batch(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad ``x`` with zero rows up to its bucket; returns
        ``(x_padded, n_real_rows)``."""
        x = np.asarray(x)
        if x.ndim < 1:
            raise ValueError("pad_batch needs a batched array, got a scalar")
        n = x.shape[0]
        nb = self.bucket_for(n)
        if nb == n:
            return x, n
        xp = np.zeros((nb,) + x.shape[1:], x.dtype)
        xp[:n] = x
        return xp, n

    def warmup_shapes(self, example_shape: Sequence[int]) -> List[Tuple[int, ...]]:
        """Every input shape this policy can emit for the per-example shape
        ``example_shape``."""
        example_shape = tuple(int(d) for d in example_shape)
        return [(nb,) + example_shape for nb in self.batch_buckets]

    def __repr__(self):
        return f"BucketPolicy(batch={self.batch_buckets})"
