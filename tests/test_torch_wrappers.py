"""The port's sklearn-style wrappers (``deeplearning4j_tpu_torch.wrappers``)
against the reference package's: the reference test file's cases, each
pair of estimators starting from the reference's initial weights (carried
with ``utils.params.params_from_numpy``), so the fits see the same weights,
batches and order; predictions within 1e-5.  The port's one extra
constructor keyword, ``device``, is in ``get_params`` (sklearn's ``clone``
needs every constructor argument there)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import wrappers as jwrappers
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.updaters import Adam
from deeplearning4j_tpu_torch import wrappers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.utils.params import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clf_conf():
    return (NeuralNetConfiguration.builder().seed(0).updater(Adam(lr=0.02))
            .layer(Dense(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())


def reg_conf():
    return (NeuralNetConfiguration.builder().seed(0).updater(Adam(lr=0.02))
            .layer(Dense(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=1, activation="identity", loss="mse"))
            .set_input_type(InputType.feed_forward(3)).build())


def _pair(kind, conf, **kw):
    """(reference estimator, port estimator on the CPU), the port's network
    built from the reference's config dict and given the reference's
    initial weights."""
    ref = getattr(jwrappers, kind)(conf, **kw)
    port = getattr(wrappers, kind)(lambda: MultiLayerConfiguration.from_dict(conf().to_dict()),
                                   device="cpu", **kw)
    init = [{k: np.asarray(v) for k, v in p.items()} for p in ref._materialize().params]
    build = port._materialize

    def carried():
        net = build()
        net.params = params_from_numpy(init, device="cpu")
        return net
    port._materialize = carried
    return ref, port


def _blobs(seed, n, d=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, d)) * 4
    y = rng.integers(0, 3, n)
    return (centers[y] + rng.normal(size=(n, d))).astype(np.float32), y


def test_fit_predict_score_with_index_labels():
    X, y = _blobs(0, 300)
    ref, port = _pair("NeuralNetClassifier", clf_conf, epochs=20, batch_size=64)
    ref.fit(X, y)
    port.fit(X, y)
    np.testing.assert_allclose(port.predict_proba(X), ref.predict_proba(X), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    assert port.score(X, y) == ref.score(X, y) and port.score(X, y) > 0.95
    proba = port.predict_proba(X[:8])
    assert isinstance(proba, np.ndarray) and proba.shape == (8, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose([float(l) for l in port.losses_],
                               [float(l) for l in ref.losses_], rtol=1e-5)


def test_string_class_labels_round_trip():
    rng = np.random.default_rng(1)
    names = np.asarray(["cat", "dog", "fox"])
    y = names[rng.integers(0, 3, 150)]
    centers = {"cat": -4, "dog": 0, "fox": 4}
    X = np.stack([rng.normal(centers[c], 1, 5) for c in y]).astype(np.float32)
    ref, port = _pair("NeuralNetClassifier", clf_conf, epochs=20, batch_size=64)
    ref.fit(X, y)
    port.fit(X, y)
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    np.testing.assert_allclose(port.predict_proba(X), ref.predict_proba(X), rtol=1e-5,
                               atol=1e-5)
    assert set(port.predict(X[:10])) <= set(names) and port.score(X, y) > 0.9


def test_sklearn_param_contract():
    ref = jwrappers.NeuralNetClassifier(clf_conf, epochs=3)
    port = wrappers.NeuralNetClassifier(clf_conf, epochs=3)
    assert {k: v for k, v in port.get_params().items() if k != "device"} == ref.get_params()
    port.set_params(epochs=7)
    assert port.epochs == 7
    for est in (ref, port):
        with pytest.raises(ValueError, match="unknown"):
            est.set_params(nope=1)
        with pytest.raises(RuntimeError, match="fit"):
            est.predict(np.zeros((2, 5), np.float32))


def test_device_is_a_constructor_parameter():
    """The port's divergence: ``device`` (default ``"cuda"``) is a
    constructor argument in ``get_params``, so ``clone`` keeps it; a fit
    without a card raises unless it is ``"cpu"``."""
    from sklearn.base import clone

    port = wrappers.NeuralNetRegressor(
        lambda: MultiLayerConfiguration.from_dict(reg_conf().to_dict()), epochs=2,
        device="cpu")
    assert port.get_params()["device"] == "cpu"
    twin = clone(port)
    assert twin.get_params() == port.get_params() and twin is not port
    assert wrappers.NeuralNetClassifier(clf_conf).get_params()["device"] == "cuda"
    X = np.zeros((4, 3), np.float32)
    twin.fit(X, np.zeros(4, np.float32))
    assert twin.net_.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            twin.set_params(device="cuda").fit(X, np.zeros(4, np.float32))


def test_fit_predict_r2():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 3)).astype(np.float32)
    y = (2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] + rng.normal(0, 0.05, 400)).astype(np.float32)
    ref, port = _pair("NeuralNetRegressor", reg_conf, epochs=40, batch_size=64)
    ref.fit(X, y)
    port.fit(X, y)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5, atol=1e-5)
    assert port.predict(X[:7]).shape == (7,)
    np.testing.assert_allclose(port.score(X, y), ref.score(X, y), rtol=1e-5)
    assert port.score(X, y) > 0.95
    # column-vector y must score identically to the flat form
    np.testing.assert_allclose(port.score(X, y[:, None]), port.score(X, y), rtol=1e-6)
    with pytest.raises(ValueError, match="incompatible"):
        port.score(X, np.zeros((400, 2), np.float32))


def test_classifier_scores_onehot_labels():
    X, yi = _blobs(2, 150)
    onehot = np.eye(3, dtype=np.float32)[yi]
    ref, port = _pair("NeuralNetClassifier", clf_conf, epochs=15, batch_size=64)
    ref.fit(X, onehot)
    port.fit(X, onehot)
    np.testing.assert_allclose(port.predict_proba(X), ref.predict_proba(X), rtol=1e-5,
                               atol=1e-5)
    assert abs(port.score(X, onehot) - port.score(X, yi)) < 1e-9
    assert port.score(X, onehot) == ref.score(X, onehot)
