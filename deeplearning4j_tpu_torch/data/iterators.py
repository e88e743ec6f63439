"""DataSetIterator protocol and the iterators ``fit`` consumes.

Counterpart of ``deeplearning4j_tpu/data/iterators.py`` (the subset the
fit loops need): ``has_next()/next()/reset()/batch()`` plus Python
iteration, and the batch stacker of the bundled train step
(:class:`BatchBundle`, :func:`iter_grouped`, :func:`iter_bundled`).
Pre-processors, async prefetch (and its ``bundle_size`` stage) and the
other combinators come with the data slice (ROADMAP § A8).
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Base protocol (reference nd4j ``DataSetIterator``)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        """Configured minibatch size (0 if unknown)."""
        return 0

    def __iter__(self) -> Iterator[DataSet]:
        while self.has_next():
            yield self.next()


class ListDataSetIterator(DataSetIterator):
    """Iterate a host DataSet in minibatches; ``drop_last`` leaves out a
    ragged last batch, as the reference does."""

    def __init__(self, data: DataSet, batch_size: int = 32, drop_last: bool = False):
        self._data = data
        self._batch = int(batch_size)
        self._drop_last = bool(drop_last)
        self._pos = 0

    def has_next(self) -> bool:
        remaining = self._data.num_examples() - self._pos
        if remaining <= 0:
            return False
        return not (self._drop_last and remaining < self._batch)

    def next(self) -> DataSet:
        lo = self._pos
        hi = min(lo + self._batch, self._data.num_examples())
        self._pos = hi

        def cut(a):
            return None if a is None else a[lo:hi]

        d = self._data
        return DataSet(d.features[lo:hi], cut(d.labels), cut(d.features_mask),
                       cut(d.labels_mask))

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self._batch


class ExistingDataSetIterator(DataSetIterator):
    """Iterate a list of prepared DataSets (reference
    ``ExistingDataSetIterator``)."""

    def __init__(self, datasets: List[DataSet]):
        self._ds = list(datasets)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._ds)

    def next(self) -> DataSet:
        d = self._ds[self._pos]
        self._pos += 1
        return d

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self._ds[0].num_examples() if self._ds else 0


class MultiDataSetIterator:
    """Iterator over MultiDataSet minibatches for ComputationGraph training."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self):
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next()

    @staticmethod
    def from_list(datasets) -> "ExistingMultiDataSetIterator":
        return ExistingMultiDataSetIterator(list(datasets))


class ExistingMultiDataSetIterator(MultiDataSetIterator):
    def __init__(self, datasets: List):
        self._data = list(datasets)
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._data)

    def next(self):
        d = self._data[self._pos]
        self._pos += 1
        return d

    def reset(self):
        self._pos = 0


class BatchBundle:
    """K consecutive same-layout minibatches stacked on a new leading axis
    (features ``(K, B, ...)``, host numpy): one call of the bundled train
    step (``train/pipeline.py``) consumes the whole object and takes K
    optimizer steps."""

    __slots__ = ("features", "labels", "features_mask", "labels_mask", "k")

    def __init__(self, features, labels, features_mask, labels_mask, k: int):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask
        self.k = int(k)

    @staticmethod
    def compat_key(ds: DataSet) -> tuple:
        """Batches may share a bundle iff these match: shapes, dtypes and
        mask presence (the K steps of one bundle need one operand layout)."""
        return (_sig(ds.features), _sig(ds.labels), _sig(ds.features_mask),
                _sig(ds.labels_mask))

    @classmethod
    def stack(cls, datasets: List[DataSet], device_put=False) -> "BatchBundle":
        """The K batches stacked as host numpy; ``device_put``: as tensors on
        a device instead (True: the default device, the CUDA card; or a
        device), the host-to-device copy paid here rather than in the
        step."""
        dev = None if device_put is False else resolve_device(
            None if device_put is True else device_put)

        def st(key):
            arrs = [getattr(d, key) for d in datasets]
            if arrs[0] is None:
                return None
            out = np.stack([np.asarray(a) for a in arrs])
            return out if dev is None else torch.from_numpy(out).to(dev)

        return cls(st("features"), st("labels"), st("features_mask"),
                   st("labels_mask"), len(datasets))

    def unstack(self) -> List[DataSet]:
        """Back to K single batches (views): the single-step path, for a
        consumer that cannot run the bundle (a data-parallel wrapper that
        must pad this batch size)."""
        def cut(a, j):
            return None if a is None else a[j]

        return [DataSet(self.features[j], cut(self.labels, j), cut(self.features_mask, j),
                        cut(self.labels_mask, j)) for j in range(self.k)]


def _sig(a):
    return None if a is None else (tuple(a.shape), str(a.dtype))


def multi_compat_key(mds) -> tuple:
    """MultiDataSet analog of :meth:`BatchBundle.compat_key`: shapes, dtypes
    and mask presence per slot."""
    return (tuple(_sig(f) for f in mds.features), tuple(_sig(lab) for lab in mds.labels),
            tuple(_sig(m) for m in mds.features_masks),
            tuple(_sig(m) for m in mds.labels_masks))


def iter_grouped(stream: Iterable, k: int, key: Callable) -> Iterator:
    """Group consecutive ``key``-compatible items of ``stream`` into
    length-``k`` lists. The ragged tail, and any run broken by a key
    change, is yielded item by item (callers route lists to the bundled
    step and bare items to the single step). A stream is one epoch, so a
    group never crosses an epoch boundary."""
    buf: List = []
    cur = None
    for item in stream:
        ik = key(item)
        if buf and ik != cur:
            yield from buf
            buf = []
        buf.append(item)
        cur = ik
        if len(buf) == k:
            yield buf
            buf = []
    yield from buf


def iter_bundled(stream: Iterable[DataSet], k: int, device_put=False) -> Iterator:
    """Group consecutive compatible DataSets of ``stream`` into
    :class:`BatchBundle` objects of exactly ``k`` steps (``device_put``: as
    :meth:`BatchBundle.stack`); the ragged tail and any run broken by a
    shape, dtype or mask-layout change are yielded as single DataSets."""
    for item in iter_grouped(stream, k, BatchBundle.compat_key):
        yield (BatchBundle.stack(item, device_put=device_put) if isinstance(item, list)
               else item)
