"""Minibatch containers of the port (mirrors ``deeplearning4j_tpu/datasets``)."""

from .dataset import DataSet

__all__ = ["DataSet"]
