"""Shape-bucket policy: pad dispatched batches onto a fixed shape set.

A near-copy of ``deeplearning4j_tpu/serving/buckets.py`` (numpy only):
every dispatched batch is rounded up to one of a small set of batch
**buckets**, the tail padded with zero rows, and rank-3 sequences are
padded along time to a **sequence bucket** under a feature mask; the
results are sliced back (:func:`slice_result`). Under XLA each shape is a
compiled program; on the card a fixed shape set keeps the kernel launch
shapes and allocator blocks bounded (and, in a later slice, the captured
CUDA graphs).

Padding never leaks into real results: an eval forward is row-independent
(no cross-batch statistics), and masked timesteps hold the recurrent
state and output zeros.
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
    - ``seq_buckets``: ascending sequence-length buckets for rank>=3 inputs
      ``(b, T, ...)``; None disables time padding.
    - Oversized requests (more rows than the top bucket, or longer than the
      top seq bucket) round up to the next power of two beyond the list and
      the grown bucket is remembered. The policy never truncates data.
    """

    def __init__(self, batch_buckets: Optional[Sequence[int]] = None,
                 max_batch: Optional[int] = None,
                 seq_buckets: Optional[Sequence[int]] = None):
        if batch_buckets is not None:
            bb = sorted({int(b) for b in batch_buckets})
            if not bb or bb[0] < 1:
                raise ValueError(f"batch_buckets must be positive: {batch_buckets}")
            if max_batch is not None and bb[-1] < int(max_batch):
                bb.append(int(max_batch))
        else:
            bb = _pow2_buckets(32 if max_batch is None else max_batch)
        self.batch_buckets: List[int] = bb
        self.seq_buckets: Optional[List[int]] = (
            None if seq_buckets is None else sorted({int(t) for t in seq_buckets}))
        if self.seq_buckets is not None and (
                not self.seq_buckets or self.seq_buckets[0] < 1):
            raise ValueError(f"seq_buckets must be positive: {seq_buckets}")

    def copy(self) -> "BucketPolicy":
        return BucketPolicy(batch_buckets=self.batch_buckets,
                            seq_buckets=self.seq_buckets)

    @staticmethod
    def _round_up(n: int, buckets: List[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        # oversized: grow by powers of two past the top bucket, remembered
        b = buckets[-1]
        while b < n:
            b *= 2
        buckets.append(b)
        return b

    def bucket_for(self, n: int) -> int:
        """Smallest batch bucket >= n (grows the list past its top)."""
        return self._round_up(int(n), self.batch_buckets)

    def seq_bucket_for(self, t: int) -> int:
        """Smallest sequence bucket >= t (t itself when seq bucketing is
        off)."""
        if self.seq_buckets is None:
            return int(t)
        return self._round_up(int(t), self.seq_buckets)

    def pad_batch(self, x: np.ndarray, mask: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
        """Pad ``x`` (and ``mask``) up to the bucketed shape; returns
        ``(x_padded, mask_padded, n_real_rows)``. When sequence bucketing
        applies (rank>=3 input) a mask of ones is made when none is given,
        even at an exact fit, so that every rank-3 dispatch carries one and
        the padded steps are masked out; batch-only padding leaves a None
        mask None (padded rows are sliced away)."""
        x = np.asarray(x)
        if x.ndim < 1:
            raise ValueError("pad_batch needs a batched array, got a scalar")
        n = x.shape[0]
        nb = self.bucket_for(n)
        pad_seq = self.seq_buckets is not None and x.ndim >= 3
        if pad_seq:
            tb = self.seq_bucket_for(x.shape[1])
            if mask is None:
                mask = np.ones((n, x.shape[1]), np.float32)
        if nb == n and (not pad_seq or tb == x.shape[1]):
            return x, mask, n
        shape = list(x.shape)
        shape[0] = nb
        if pad_seq:
            shape[1] = tb
        xp = np.zeros(shape, x.dtype)
        if pad_seq:
            xp[:n, :x.shape[1]] = x
        else:
            xp[:n] = x
        mp = mask
        if mask is not None:
            mask = np.asarray(mask)
            mshape = list(mask.shape)
            mshape[0] = nb
            if pad_seq and mask.ndim >= 2:
                mshape[1] = tb
            mp = np.zeros(mshape, mask.dtype)
            if pad_seq and mask.ndim >= 2:
                mp[:n, :mask.shape[1]] = mask
            else:
                mp[:n] = mask
        return xp, mp, n

    def warmup_shapes(self, example_shape: Sequence[int]
                      ) -> List[Tuple[Tuple[int, ...], bool]]:
        """Every ``(input_shape, with_mask)`` this policy can emit for the
        per-example shape ``example_shape``: with seq bucketing the time
        axis (``example_shape[0]``) takes each seq bucket, with a mask."""
        example_shape = tuple(int(d) for d in example_shape)
        seq = self.seq_buckets is not None and len(example_shape) >= 2
        shapes: List[Tuple[Tuple[int, ...], bool]] = []
        for nb in list(self.batch_buckets):
            if seq:
                shapes += [((nb, tb) + example_shape[1:], True)
                           for tb in list(self.seq_buckets)]
            else:
                shapes.append(((nb,) + example_shape, False))
        return shapes

    def __repr__(self):
        return f"BucketPolicy(batch={self.batch_buckets}, seq={self.seq_buckets})"


def slice_result(y: np.ndarray, n: int, t_orig: Optional[int],
                 t_padded: Optional[int]) -> np.ndarray:
    """Undo bucket padding on a model output: the batch axis back to ``n``
    rows; the time axis back to ``t_orig`` when it was padded and the output
    still carries it (per-step outputs ``(b, T, ...)``; time-pooled outputs
    have no padded axis left, and the mask kept them right)."""
    y = np.asarray(y)[:n]
    if (t_orig is not None and t_padded is not None and t_padded != t_orig
            and y.ndim >= 3 and y.shape[1] == t_padded):
        y = y[:, :t_orig]
    return y
