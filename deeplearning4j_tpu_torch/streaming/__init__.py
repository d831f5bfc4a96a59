"""Tensor pub-sub streaming (the port of ``deeplearning4j_tpu/streaming``)."""

from .pubsub import (
    NDArrayConsumer,
    NDArrayPublisher,
    StreamingDataSetIterator,
    TensorBroker,
)

__all__ = ["NDArrayConsumer", "NDArrayPublisher", "StreamingDataSetIterator",
           "TensorBroker"]
