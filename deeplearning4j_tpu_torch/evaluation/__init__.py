"""Evaluation suite: classification, binary, calibration, regression and
ROC metrics, merge-able across batches and processes.

Counterpart of ``deeplearning4j_tpu/evaluation/`` (reference
``deeplearning4j-nn eval/``). The accumulators are numpy on the host, as
the reference's: the networks hand them numpy outputs, and ``eval`` takes
torch tensors as well (moved to the host first).
"""

from deeplearning4j_tpu_torch.evaluation.binary import EvaluationBinary
from deeplearning4j_tpu_torch.evaluation.calibration import EvaluationCalibration
from deeplearning4j_tpu_torch.evaluation.classification import ConfusionMatrix, Evaluation
from deeplearning4j_tpu_torch.evaluation.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.evaluation.roc import ROC, ROCBinary, ROCMultiClass

__all__ = [
    "Evaluation", "ConfusionMatrix", "RegressionEvaluation", "ROC",
    "ROCBinary", "ROCMultiClass", "EvaluationBinary", "EvaluationCalibration",
]
