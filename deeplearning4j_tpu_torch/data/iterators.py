"""DataSetIterator protocol and the iterators ``fit`` consumes.

Counterpart of ``deeplearning4j_tpu/data/iterators.py`` (the subset the
training slices need): ``has_next()/next()/reset()`` plus Python
iteration. Pre-processors, async prefetch and the other combinators come
with the data slice (ROADMAP § A).
"""

from __future__ import annotations

from typing import Iterator, List

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Base protocol (reference nd4j ``DataSetIterator``)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        while self.has_next():
            yield self.next()


class ListDataSetIterator(DataSetIterator):
    """Iterate a host DataSet in minibatches."""

    def __init__(self, data: DataSet, batch_size: int = 32):
        self._data = data
        self._batch = int(batch_size)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < self._data.num_examples()

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
