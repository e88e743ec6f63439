"""Host-side data containers and iterators (numpy), as ``fit`` consumes them."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.data.iterators import (  # noqa: F401
    DataSetIterator,
    ExistingDataSetIterator,
    ExistingMultiDataSetIterator,
    ListDataSetIterator,
    MultiDataSetIterator,
)
