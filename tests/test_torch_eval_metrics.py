"""The port's evaluation metrics (``evaluation/{binary,roc,regression,
calibration}.py``) against the reference on the same labels and
predictions, and ``MultiLayerNetwork.evaluate`` / ``ComputationGraph
.evaluate`` with each of them on weights carried across from the
reference (1e-6)."""

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.evaluation as jev
import deeplearning4j_tpu_torch.evaluation as tev


def _class_data(n=200, c=4, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    logits = rng.normal(size=(n, c)) + 2.0 * y
    p = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    m = (rng.random(n) > 0.2).astype(np.float32) if mask else None
    return y, p, m


def _binary_data(n=150, c=3, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    y = (rng.random((n, c)) > 0.5).astype(np.float32)
    p = np.clip(0.6 * y + 0.5 * rng.random((n, c)), 0, 1).astype(np.float32)
    m = (rng.random((n, c)) > 0.1).astype(np.float32) if mask else None
    return y, p, m


def _both(name, *a, **kw):
    return getattr(tev, name)(*a, **kw), getattr(jev, name)(*a, **kw)


def _feed(objs, data, batches=3):
    y, p, m = data
    for idx in np.array_split(np.arange(len(y)), batches):
        for o in objs:
            o.eval(y[idx], p[idx], mask=None if m is None else m[idx])


@pytest.mark.parametrize("mask", [False, True])
def test_roc_is_the_references(mask):
    t, j = _both("ROC", threshold_steps=100)
    data = _binary_data(c=1, mask=mask)
    _feed((t, j), (data[0][:, 0], data[1][:, 0], None if data[2] is None else data[2][:, 0]))
    assert t.calculate_auc() == j.calculate_auc()
    assert t.calculate_auprc() == j.calculate_auprc()
    for a, b in zip(t.get_roc_curve(), j.get_roc_curve()):
        np.testing.assert_array_equal(a, b)
    t2, j2 = _both("ROC", threshold_steps=100)
    _feed((t2, j2), (_binary_data(c=1, seed=9)[0][:, 0], _binary_data(c=1, seed=9)[1][:, 0],
                     None))
    t.merge(t2)
    j.merge(j2)
    assert t.calculate_auc() == j.calculate_auc()


@pytest.mark.parametrize("mask", [False, True])
def test_roc_binary_is_the_references(mask):
    t, j = _both("ROCBinary")
    _feed((t, j), _binary_data(mask=mask))
    for c in range(3):
        assert t.calculate_auc(c) == j.calculate_auc(c)
    assert t.calculate_average_auc() == j.calculate_average_auc()


@pytest.mark.parametrize("mask", [False, True])
def test_roc_multiclass_is_the_references(mask):
    t, j = _both("ROCMultiClass", threshold_steps=50)
    _feed((t, j), _class_data(mask=mask))
    for c in range(4):
        assert t.calculate_auc(c) == j.calculate_auc(c)
    assert t.calculate_average_auc() == j.calculate_average_auc()


@pytest.mark.parametrize("mask", [False, True])
def test_evaluation_binary_is_the_references(mask):
    t, j = _both("EvaluationBinary", decision_threshold=0.4)
    _feed((t, j), _binary_data(mask=mask))
    for c in range(3):
        for m in ("accuracy", "precision", "recall", "f1"):
            assert getattr(t, m)(c) == getattr(j, m)(c)
    assert t.stats() == j.stats()
    t2, j2 = _both("EvaluationBinary", decision_threshold=0.4)
    _feed((t2, j2), _binary_data(seed=5))
    t.merge(t2)
    j.merge(j2)
    assert t.stats() == j.stats()


@pytest.mark.parametrize("mask", [False, True])
def test_regression_evaluation_is_the_references(mask):
    rng = np.random.default_rng(3)
    y = rng.normal(size=(120, 2)).astype(np.float32)
    p = (y + 0.3 * rng.normal(size=y.shape)).astype(np.float32)
    m = (rng.random(120) > 0.25).astype(np.float32) if mask else None
    t, j = _both("RegressionEvaluation")
    _feed((t, j), (y, p, m))
    for c in range(2):
        for name in ("mean_squared_error", "mean_absolute_error", "root_mean_squared_error",
                     "relative_squared_error", "pearson_correlation", "r_squared"):
            assert getattr(t, name)(c) == getattr(j, name)(c), name
    assert t.average_mean_squared_error() == j.average_mean_squared_error()
    assert t.stats() == j.stats()


@pytest.mark.parametrize("mask", [False, True])
def test_calibration_is_the_references(mask):
    t, j = _both("EvaluationCalibration", reliability_bins=8, histogram_bins=20)
    _feed((t, j), _class_data(mask=mask))
    for c in range(4):
        for a, b in zip(t.reliability_diagram(c), j.reliability_diagram(c)):
            np.testing.assert_array_equal(a, b)
        assert t.expected_calibration_error(c) == j.expected_calibration_error(c)


def test_the_packages_export_the_same_metric_names():
    for name in ("Evaluation", "ConfusionMatrix", "RegressionEvaluation", "ROC", "ROCBinary",
                 "ROCMultiClass", "EvaluationBinary", "EvaluationCalibration"):
        assert hasattr(jev, name) and name in tev.__all__


# -- evaluate() with each metric, on carried weights --------------------------------------


def _nets():
    """The same 2-layer classifier in both packages, the reference's
    weights carried to the port."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration as TConf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
    from deeplearning4j_tpu_torch.utils.params import params_from_numpy

    conf = (NeuralNetConfiguration.builder().seed(3)
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    j = MultiLayerNetwork(conf)
    j.init()
    t = TNet(TConf.from_dict(conf.to_dict()), device="cpu")
    t.init()
    t.params = params_from_numpy(jax.tree_util.tree_map(np.asarray, j.params), device="cpu")
    return t, j


def _eval_batches(pkg_dataset, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(96, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 96)]
    return [pkg_dataset(x[i:i + 32], y[i:i + 32]) for i in range(0, 96, 32)]


@pytest.mark.parametrize("metric", ["ROCMultiClass", "EvaluationCalibration",
                                    "RegressionEvaluation", "EvaluationBinary", "Evaluation"])
def test_net_evaluate_takes_each_metric_within_1e6_of_the_reference(metric):
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.datasets import ListDataSetIterator as JList
    from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator as TList

    t, j = _nets()
    got = t.evaluate(TList(_eval_batches(TDataSet)), getattr(tev, metric)())
    want = j.evaluate(JList(_eval_batches(JDataSet)), getattr(jev, metric)())
    assert type(got) is getattr(tev, metric)
    if metric == "ROCMultiClass":
        vals = [(got.calculate_auc(c), want.calculate_auc(c)) for c in range(4)]
        vals.append((got.calculate_average_auc(), want.calculate_average_auc()))
    elif metric == "EvaluationCalibration":
        vals = [(got.expected_calibration_error(c), want.expected_calibration_error(c))
                for c in range(4)]
    elif metric == "RegressionEvaluation":
        vals = [(got.mean_squared_error(c), want.mean_squared_error(c)) for c in range(4)]
    elif metric == "EvaluationBinary":
        vals = [(got.accuracy(c), want.accuracy(c)) for c in range(4)]
    else:
        vals = [(got.accuracy(), want.accuracy()), (got.f1(), want.f1())]
    np.testing.assert_allclose([a for a, _ in vals], [b for _, b in vals], rtol=0, atol=1e-6)


def test_graph_evaluate_takes_roc_multiclass():
    from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer

    conf = (GraphBuilder().seed(1)
            .add_inputs("in").set_input_types(**{"in": InputType.feed_forward(6)})
            .add_layer("h", Dense(n_out=8, activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_out=4, activation="softmax", loss="mcxent"), "h")
            .set_outputs("out").build())
    net = ComputationGraph(conf, device="cpu")
    net.init()
    batches = _eval_batches(TDataSet)
    roc = net.evaluate(batches, tev.ROCMultiClass())
    ref = tev.ROCMultiClass()
    for b in batches:
        ref.eval(b.labels, net.output(b.features)[0].numpy())
    assert [roc.calculate_auc(c) for c in range(4)] == [ref.calculate_auc(c) for c in range(4)]
