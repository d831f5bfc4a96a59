"""sklearn-style estimator wrappers (the port of
``deeplearning4j_tpu/wrappers.py``).

Parity target: the reference ecosystem's ScikitLearn-ish wrappers
(deeplearning4j-scaleout/dl4j-streaming's simple wrappers + the
community's Keras-like fit/predict surface).  ``NeuralNetClassifier`` /
``NeuralNetRegressor`` adapt any MultiLayerConfiguration (or a builder
thereof) to fit(X, y) / predict(X) / predict_proba(X) / score(X, y) with
numpy in, numpy out — so framework models drop into sklearn pipelines,
grid searches, and cross-validation loops.

The port's wrappers take one more keyword, ``device`` (``"cuda"`` by
default, ``"cpu"`` to train and predict on the CPU), which ``get_params``
returns like every other constructor argument, so sklearn's ``clone``
rebuilds an estimator on the same device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np

from .datasets import DataSet, ListDataSetIterator
from .nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from .utils.device import DeviceLike


class _BaseWrapper:
    def __init__(self, conf: Union[MultiLayerConfiguration, Callable[[], MultiLayerConfiguration]],
                 epochs: int = 10, batch_size: int = 128, seed: int = 12345,
                 shuffle: bool = True, device: DeviceLike = "cuda"):
        self.conf = conf
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.device = device
        self.net_: Optional[MultiLayerNetwork] = None
        self.losses_: List[float] = []

    # sklearn contract
    def get_params(self, deep: bool = True) -> dict:
        return {"conf": self.conf, "epochs": self.epochs,
                "batch_size": self.batch_size, "seed": self.seed,
                "shuffle": self.shuffle, "device": self.device}

    def set_params(self, **params) -> "_BaseWrapper":
        valid = set(self.get_params())
        for k, v in params.items():
            if k not in valid:  # sklearn contract: constructor params only
                raise ValueError(f"unknown parameter {k} — valid: {sorted(valid)}")
            setattr(self, k, v)
        return self

    def _materialize(self) -> MultiLayerNetwork:
        conf = self.conf() if callable(self.conf) else self.conf
        if not isinstance(conf, MultiLayerConfiguration):
            raise TypeError("conf must be a MultiLayerConfiguration or a "
                            "zero-arg factory returning one")
        net = MultiLayerNetwork(conf, device=self.device)
        net.init()
        return net

    def _fit(self, X: np.ndarray, y2d: np.ndarray) -> "_BaseWrapper":
        self.net_ = self._materialize()
        ds = DataSet(np.asarray(X, np.float32), np.asarray(y2d, np.float32))
        if self.shuffle:
            ds = ds.shuffle(self.seed)
        it = ListDataSetIterator(ds.batch_by(self.batch_size))
        self.losses_ = self.net_.fit(it, epochs=self.epochs)
        return self

    def _check_fitted(self) -> MultiLayerNetwork:
        if self.net_ is None:
            raise RuntimeError("call fit(X, y) before predicting")
        return self.net_

    def _output(self, X) -> np.ndarray:
        """The fitted network's output on ``X`` as a host array."""
        return self._check_fitted().output(np.asarray(X, np.float32)).detach().cpu().numpy()


class NeuralNetClassifier(_BaseWrapper):
    """fit(X, y) with integer class labels (or one-hot); predict returns
    class indices, predict_proba the softmax outputs, score the accuracy."""

    def fit(self, X, y) -> "NeuralNetClassifier":
        y = np.asarray(y)
        if y.ndim == 1:
            self.classes_ = np.unique(y)
            index = {c: i for i, c in enumerate(self.classes_)}
            onehot = np.zeros((len(y), len(self.classes_)), np.float32)
            onehot[np.arange(len(y)), [index[c] for c in y]] = 1.0
        else:
            self.classes_ = np.arange(y.shape[1])
            onehot = y.astype(np.float32)
        return self._fit(X, onehot)

    def predict_proba(self, X) -> np.ndarray:
        return self._output(X)

    def predict(self, X) -> np.ndarray:
        idx = np.argmax(self.predict_proba(X), axis=-1)
        return self.classes_[idx]

    def score(self, X, y) -> float:
        y = np.asarray(y)
        if y.ndim == 2:  # one-hot labels (fit accepts them too)
            y = self.classes_[np.argmax(y, axis=1)]
        return float(np.mean(self.predict(X) == y))


class NeuralNetRegressor(_BaseWrapper):
    """fit(X, y) with continuous targets; predict returns raw outputs,
    score the R² coefficient (sklearn convention)."""

    def fit(self, X, y) -> "NeuralNetRegressor":
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        return self._fit(X, y)

    def predict(self, X) -> np.ndarray:
        out = self._output(X)
        return out[:, 0] if out.shape[-1] == 1 else out

    def score(self, X, y) -> float:
        """R², sklearn convention: per-output means, uniform average."""
        y = np.asarray(y, np.float32)
        pred = np.asarray(self.predict(X), np.float32)
        y2 = y.reshape(len(y), -1)
        p2 = pred.reshape(len(pred), -1)
        if y2.shape != p2.shape:
            raise ValueError(f"target shape {y.shape} incompatible with "
                             f"predictions {pred.shape}")
        ss_res = np.sum((y2 - p2) ** 2, axis=0)
        ss_tot = np.sum((y2 - y2.mean(axis=0)) ** 2, axis=0)
        return float(np.mean(1.0 - ss_res / np.maximum(ss_tot, 1e-12)))
