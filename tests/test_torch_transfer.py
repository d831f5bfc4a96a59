"""The port's transfer learning (``nn/transferlearning.py``: the
``TransferLearning`` builder and ``TransferLearningHelper``) against the
JAX package's on the CPU, on LeNet and an MLP.

Each case builds the source network in the reference and carries its
weights into the port, applies the same surgery in both packages, and
checks: the configuration JSON equal to the reference's; every carried
parameter bitwise the source's; then (with the freshly drawn layers
copied from the reference, since each package draws its own) 3 steps
(the MLP's Adam; LeNet fine-tuned with Nesterovs, which the
configuration swaps in: under Adam a ReLU unit whose gradient is ~0 takes
an update of ~lr from rounding alone) with losses and parameters within
1e-5, and the frozen layers' parameters bitwise unchanged.  The helper: ``featurize`` →
``fit_featurized`` against the reference's helper, and against
fine-tuning the whole network in the port, within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import models as jmodels
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import transferlearning as tl
from deeplearning4j_tpu_torch.nn.layers import Dense, FrozenLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy

TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_of(jnet):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jnet.conf.to_dict()), device="cpu")
    net.params = params_from_numpy(_np_tree(jnet.params), device="cpu")
    net.state = params_from_numpy(_np_tree(jnet.state), device="cpu")
    net.opt_state = net.init_opt_state(net.params)
    return net


def _close(port_tree, ref_tree, atol=TOL):
    a = jax.tree_util.tree_leaves(params_to_numpy(port_tree))
    b = jax.tree_util.tree_leaves(_np_tree(ref_tree))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def _lenet():
    return jmodels.LeNet(height=12, width=12, channels=1, num_classes=10)


def _mlp():
    conf = (JBuilder.builder().seed(4).updater(JAdam(lr=1e-2))
            .layer(jff.Dense(n_out=8, activation="tanh"))
            .layer(jff.Dense(n_out=6, activation="relu"))
            .layer(jff.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(5)).build())
    net = JNet(conf)
    net.init()
    return net


def _data(kind, n=8, seed=0, classes=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 12, 12, 1) if kind == "lenet" else (n, 5)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


# (source, surgery on a builder of either package, frozen layer indices, classes)
CASES = {
    "lenet_freeze_and_replace_nout": (
        _lenet, lambda b, m: b.fine_tune_configuration(
            updater=m.Nesterovs(lr=1e-2, momentum=0.9))
        .set_feature_extractor(3).n_out_replace(5, 5), [0, 2], 5),
    "mlp_remove_and_add": (
        _mlp, lambda b, m: b.set_feature_extractor(0).remove_last_layers(2)
        .add_layer(m.Dense(n_out=4, activation="tanh"))
        .add_layer(m.OutputLayer(n_out=2, activation="softmax", loss="mcxent")), [0], 2),
    "mlp_replace_a_hidden_nout": (
        _mlp, lambda b, m: b.n_out_replace(0, 7).fine_tune_configuration(seed=9), [], 3),
    "mlp_remove_output_layer": (
        _mlp, lambda b, m: b.set_feature_extractor(1).remove_output_layer()
        .add_layer(m.OutputLayer(n_out=4, activation="softmax", loss="mcxent")), [0, 1], 4),
}


class _J:
    Dense, Nesterovs, OutputLayer = jff.Dense, JNesterovs, jff.OutputLayer


class _T:
    Dense, Nesterovs, OutputLayer = Dense, Nesterovs, OutputLayer


@pytest.mark.parametrize("case", list(CASES))
def test_transfer_learning_matches_the_reference(case):
    make, surgery, frozen, classes = CASES[case]
    jsrc = make()
    src = _port_of(jsrc)
    jnet = surgery(jtl.TransferLearning(jsrc), _J).build()
    net = surgery(tl.TransferLearning(src), _T).build()
    assert net.conf.to_dict() == jnet.conf.to_dict()
    kind = "lenet" if case.startswith("lenet") else "mlp"
    fresh = set(range(len(net.params)))
    for i, p in enumerate(net.params):
        if i < len(src.params) and p and all(
                k in src.params[i] and src.params[i][k].shape == v.shape for k, v in p.items()):
            if all(torch.equal(v, src.params[i][k]) for k, v in p.items()):
                fresh.discard(i)
    # the carried layers are bitwise the source's; only the new ones differ
    for i in frozen:
        assert i not in fresh and isinstance(net.conf.layers[i], FrozenLayer)
    for i in fresh:
        net.params[i] = params_from_numpy(_np_tree(jnet.params[i]), device="cpu")
    net.opt_state = net.init_opt_state(net.params)
    _close(net.params, jnet.params, 0.0)
    before = [{k: v.clone() for k, v in net.params[i].items()} for i in frozen]
    for step in range(3):
        x, y = _data(kind, seed=step, classes=classes)
        assert abs(float(net.fit_batch(DataSet(x, y)))
                   - float(jnet.fit_batch(JDataSet(x, y)))) < TOL
    _close(net.params, jnet.params)
    for i, b in zip(frozen, before):
        for k, v in b.items():
            assert torch.equal(net.params[i][k], v), (i, k)


def _helper_pair():
    """The mlp_remove_output_layer surgery in both packages, the new head
    copied from the reference."""
    _, surgery, _, _ = CASES["mlp_remove_output_layer"]
    jsrc = _mlp()
    jnet = surgery(jtl.TransferLearning(jsrc), _J).build()
    net = surgery(tl.TransferLearning(_port_of(jsrc)), _T).build()
    net.params[2] = params_from_numpy(_np_tree(jnet.params[2]), device="cpu")
    net.opt_state = net.init_opt_state(net.params)
    return net, jnet


def test_helper_featurize_and_fit_featurized_match_the_reference():
    net, jnet = _helper_pair()
    helper, jhelper = tl.TransferLearningHelper(net, 1), jtl.TransferLearningHelper(jnet, 1)
    for step in range(3):
        x, y = _data("mlp", seed=10 + step, classes=4)
        feat, jfeat = helper.featurize(DataSet(x, y)), jhelper.featurize(JDataSet(x, y))
        np.testing.assert_allclose(feat.features.numpy(), np.asarray(jfeat.features),
                                   rtol=0, atol=TOL)
        got = [float(v) for v in helper.fit_featurized(feat)]
        want = [float(v) for v in jhelper.fit_featurized(jfeat)]
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _close(net.params, jnet.params)
    x, _ = _data("mlp", seed=20, classes=4)
    np.testing.assert_allclose(helper.output(x).numpy(), np.asarray(jhelper.output(x)),
                               rtol=0, atol=TOL)


def test_fit_featurized_equals_fine_tuning_the_whole_network():
    net, _ = _helper_pair()
    whole, _ = _helper_pair()
    helper = tl.TransferLearningHelper(net, 1)
    for step in range(3):
        x, y = _data("mlp", seed=30 + step, classes=4)
        a = float(helper.fit_featurized(helper.featurize(DataSet(x, y)))[0])
        b = float(whole.fit_batch(DataSet(x, y)))
        assert abs(a - b) < TOL
    _close(net.params, params_to_numpy(whole.params))
