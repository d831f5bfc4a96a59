"""Evaluation of the port (mirrors ``deeplearning4j_tpu/evaluation``):
classification, regression, ROC, binary and calibration metrics, numpy on
the host."""

from .binary import EvaluationBinary
from .calibration import EvaluationCalibration
from .evaluation import ConfusionMatrix, Evaluation
from .regression import RegressionEvaluation
from .roc import ROC, ROCBinary, ROCMultiClass

__all__ = ["ConfusionMatrix", "Evaluation", "EvaluationBinary", "EvaluationCalibration",
           "ROC", "ROCBinary", "ROCMultiClass", "RegressionEvaluation"]
