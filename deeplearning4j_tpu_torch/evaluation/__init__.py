"""Evaluation of the port (mirrors ``deeplearning4j_tpu/evaluation``;
classification only, the rest is still to port)."""

from .evaluation import ConfusionMatrix, Evaluation

__all__ = ["ConfusionMatrix", "Evaluation"]
