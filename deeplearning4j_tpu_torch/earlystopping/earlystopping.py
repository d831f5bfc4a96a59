"""Early stopping, a configuration-driven training loop (mirrors
``deeplearning4j_tpu/earlystopping/earlystopping.py``): score
calculators, epoch and iteration termination conditions, in-memory and
on-disk model savers, and the trainer that runs epochs, scores them,
keeps the best model and restores it at the end.  One trainer serves a
``MultiLayerNetwork`` and a ``ComputationGraph`` alike.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, List, Optional

import torch

from ..nn.layers.base import tree_apply


# -- score calculators -----------------------------------------------------------------


class DataSetLossCalculator:
    """The loss on validation data, averaged over examples (minimized)."""

    minimize_score = True

    def __init__(self, data):
        self.data = data

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        for ds in model._as_iterator(self.data):
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / max(n, 1)


class AccuracyScoreCalculator:
    """Accuracy on validation data (maximized)."""

    minimize_score = False

    def __init__(self, data):
        self.data = data

    def calculate_score(self, model) -> float:
        return model.evaluate(self.data).accuracy()


# -- termination conditions ---------------------------------------------------------------


class MaxEpochsTerminationCondition:
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float, best_score: float) -> bool:
        return epoch >= self.max_epochs


class ScoreImprovementEpochTerminationCondition:
    """Stop after more than N epochs without improvement."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._epochs_since_best = 0

    def on_epoch(self, improved: bool) -> None:
        self._epochs_since_best = 0 if improved else self._epochs_since_best + 1

    def terminate(self, epoch, score, best_score) -> bool:
        return self._epochs_since_best > self.patience


class MaxScoreIterationTerminationCondition:
    """Stop when the training score is not finite or exceeds a bound."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate_iteration(self, score: float) -> bool:
        return (not math.isfinite(score)) or score > self.max_score


class MaxTimeIterationTerminationCondition:
    """Stop once ``max_seconds`` have passed since the first iteration."""

    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start: Optional[float] = None

    def terminate_iteration(self, score: float) -> bool:
        if self._start is None:
            self._start = time.monotonic()
            return False
        return (time.monotonic() - self._start) > self.max_seconds


class InvalidScoreIterationTerminationCondition:
    """Stop at once on a NaN or infinite training score."""

    def terminate_iteration(self, score: float) -> bool:
        return not math.isfinite(score)


class BestScoreEpochTerminationCondition:
    """Stop once the validation score is at least as good as a target;
    ``minimize=None`` takes the score calculator's direction."""

    def __init__(self, best_expected_score: float, minimize: Optional[bool] = None):
        self.best_expected_score = best_expected_score
        self.minimize = minimize

    def terminate(self, epoch, score, best_score) -> bool:
        minimize = True if self.minimize is None else self.minimize
        if minimize:
            return score <= self.best_expected_score
        return score >= self.best_expected_score


# -- model savers ---------------------------------------------------------------------------


class InMemoryModelSaver:
    """Clones of the best (and latest) parameters, state and updater
    state (clones: a ``fit_batches`` graph writes the network's tensors in
    place)."""

    def __init__(self):
        self._best = None
        self._latest = None

    @staticmethod
    def _snapshot(model):
        return tuple(tree_apply(torch.Tensor.clone, t)
                     for t in (model.params, model.state, model.opt_state))

    def save_best(self, model) -> None:
        self._best = self._snapshot(model)

    def save_latest(self, model) -> None:
        self._latest = self._snapshot(model)

    def restore_best(self, model) -> None:
        if self._best is not None:
            model.params, model.state, model.opt_state = self._best


class LocalFileModelSaver:
    """``bestModel.zip`` and ``latestModel.zip`` in a directory."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.best_path = os.path.join(directory, "bestModel.zip")
        self.latest_path = os.path.join(directory, "latestModel.zip")

    def save_best(self, model) -> None:
        model.save(self.best_path)

    def save_latest(self, model) -> None:
        model.save(self.latest_path)

    def restore_best(self, model) -> None:
        if os.path.exists(self.best_path):
            restored = type(model).load(self.best_path, device=model.device)
            model.params, model.state, model.opt_state = (
                restored.params, restored.state, restored.opt_state)


# -- configuration and trainer ------------------------------------------------------------


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: Any = None
    epoch_terminations: List[Any] = dataclasses.field(default_factory=list)
    iteration_terminations: List[Any] = dataclasses.field(default_factory=list)
    model_saver: Any = dataclasses.field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    score_vs_epoch: List[float]
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


class EarlyStoppingTrainer:
    """Epochs of ``fit_batch`` with the iteration terminations checked
    after every step; then the score, the best model saved, and the epoch
    terminations.  At the end the best model is restored into ``model``."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_data):
        self.config = config
        self.model = model
        self.train_data = train_data

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        minimize = getattr(cfg.score_calculator, "minimize_score", True)
        for t in cfg.epoch_terminations:
            if getattr(t, "minimize", False) is None:
                t.minimize = minimize
        best_score = float("inf") if minimize else float("-inf")
        best_epoch = -1
        scores: List[float] = []
        epoch = 0
        reason, details = "MaxEpochs", ""
        while True:
            aborted = False
            for ds in self.model._as_iterator(self.train_data):
                loss = self.model.fit_batch(ds)
                for t in cfg.iteration_terminations:
                    if t.terminate_iteration(loss):
                        reason = "IterationTermination"
                        details = f"{type(t).__name__} at loss {loss}"
                        aborted = True
                        break
                if aborted:
                    break
            self.model.epoch += 1
            epoch += 1
            if aborted:
                break
            improved = False
            if cfg.score_calculator is not None and epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model)
                scores.append(score)
                improved = score < best_score if minimize else score > best_score
                if improved:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best(self.model)
            if cfg.save_last_model:
                cfg.model_saver.save_latest(self.model)
            stop = False
            for t in cfg.epoch_terminations:
                if hasattr(t, "on_epoch"):
                    t.on_epoch(improved)
                if t.terminate(epoch, scores[-1] if scores else float("nan"), best_score):
                    reason = "EpochTermination"
                    details = type(t).__name__
                    stop = True
                    break
            if stop:
                break
        cfg.model_saver.restore_best(self.model)
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=scores, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch, best_model=self.model)
