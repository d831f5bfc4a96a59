"""Minibatch containers, iterators and the Iris / MNIST fetchers of the port
(mirrors ``deeplearning4j_tpu/datasets``)."""

from .dataset import DataSet, MultiDataSet
from .iterators import (AsyncDataSetIterator, DataSetIterator,
                        EarlyTerminationDataSetIterator, KFoldIterator,
                        ListDataSetIterator, MultipleEpochsIterator,
                        SamplingDataSetIterator)

__all__ = ["AsyncDataSetIterator", "DataSet", "DataSetIterator",
           "EarlyTerminationDataSetIterator", "KFoldIterator",
           "ListDataSetIterator", "MultiDataSet", "MultipleEpochsIterator",
           "SamplingDataSetIterator"]
