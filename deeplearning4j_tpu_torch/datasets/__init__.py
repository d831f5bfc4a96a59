"""Minibatch containers, iterators, normalizers, record readers, remote
storage, the device prefetch ring, the native loader and the fetchers of
the port (mirrors ``deeplearning4j_tpu/datasets``)."""

from .dataset import DataSet, MultiDataSet
from .device_prefetch import DevicePrefetchIterator, device_put_batch
from .iterators import (AsyncDataSetIterator, DataSetIterator,
                        EarlyTerminationDataSetIterator, KFoldIterator,
                        ListDataSetIterator, MultipleEpochsIterator,
                        SamplingDataSetIterator)
from .normalizers import (ImagePreProcessingScaler, NormalizerMinMaxScaler,
                          NormalizerStandardize)
from .records import (CSVRecordReader, CSVSequenceRecordReader, ImageRecordReader,
                      ImageRecordReaderDataSetIterator, RecordReaderDataSetIterator,
                      SequenceRecordReaderDataSetIterator)
from .remote import (LocalProvider, RemoteDataSetIterator, S3Provider, StorageProvider,
                     load_dataset, register_provider, save_dataset)

__all__ = ["AsyncDataSetIterator", "CSVRecordReader", "CSVSequenceRecordReader",
           "DataSet", "DataSetIterator", "DevicePrefetchIterator",
           "EarlyTerminationDataSetIterator", "ImagePreProcessingScaler",
           "ImageRecordReader", "ImageRecordReaderDataSetIterator", "KFoldIterator",
           "ListDataSetIterator", "LocalProvider", "MultiDataSet",
           "MultipleEpochsIterator", "NormalizerMinMaxScaler", "NormalizerStandardize",
           "RecordReaderDataSetIterator", "RemoteDataSetIterator", "S3Provider",
           "SamplingDataSetIterator", "SequenceRecordReaderDataSetIterator",
           "StorageProvider", "device_put_batch", "load_dataset", "register_provider",
           "save_dataset"]
