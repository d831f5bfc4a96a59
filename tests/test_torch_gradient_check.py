"""The port's ``utils/gradient_check.check_gradients``: the reference's
gradient-check cases (``tests/test_gradientcheck.py``) built in the port
in float64 must pass it, as must the layers of this slice (center-loss,
YOLOv2 and VAE heads, in a MultiLayerNetwork and a ComputationGraph).

Thresholds are the reference test's: epsilon 1e-6, maximum relative
error 1e-4 (below 1e-8 absolute any error passes), at most 16 sampled
entries an array.  For two networks the port's analytic gradients are
also held to the reference's (the same float64 weights carried across)
within 1e-10, and a deliberately wrong gradient must fail the check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.multilayer import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.jax_compat import enable_x64
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder, L2NormalizeVertex
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.updaters import NoOp
from deeplearning4j_tpu_torch.utils.gradient_check import check_gradients
from deeplearning4j_tpu_torch.utils.params import params_to_numpy


def _net(layers, input_type):
    b = (NeuralNetConfiguration.builder().seed(0).updater(NoOp())
         .dtype("float64", "float64"))
    for layer in layers:
        b.layer(layer)
    net = MultiLayerNetwork(b.set_input_type(input_type).build(), device="cpu")
    net.init()
    return net


def _ff(n=4, f=6, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(n, f)), np.eye(c)[rng.integers(0, c, n)])


def _img(n=3, h=8, w=8, c=1, classes=2, seed=3):
    """Images from a seed at which no 2x2 max-pool window of the conv
    cases holds two values closer than 1e-3: at seed 1 one window's top
    two are 6e-7 apart, a kink that an epsilon of 1e-6 straddles, so the
    central difference there is not the derivative (in either package)."""
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(n, h, w, c)), np.eye(classes)[rng.integers(0, classes, n)])


def _seq(n=3, t=5, f=4, c=2, per_step=True, mask=None, seed=2):
    rng = np.random.default_rng(seed)
    y = np.eye(c)[rng.integers(0, c, (n, t) if per_step else n)]
    return DataSet(rng.normal(size=(n, t, f)), y, features_mask=mask, labels_mask=mask)


def _yolo_data(seed=3):
    from tests.test_torch_special_layers import yolo_labels

    rng = np.random.default_rng(seed)
    lab = yolo_labels(rng, 2, 3, 3, boxes=2, classes=3, per_image=2)
    return DataSet(rng.normal(size=(2, 6, 6, 2)), {k: v.astype(np.float64)
                                                  for k, v in lab.items()})


def _masked():
    m = np.ones((3, 5))
    m[0, 3:] = 0
    m[2, 1:] = 0
    return m


def _center_net():
    net = _net([L.Dense(n_out=5, activation="tanh"),
                L.CenterLossOutputLayer(n_out=3, activation="softmax", lambda_=0.5)],
               InputType.feed_forward(6))
    rng = np.random.default_rng(9)
    net.state[1]["centers"] = torch.from_numpy(rng.normal(size=(3, 5)))
    return net


def _yolo_net():
    return _net([L.Convolution2D(n_out=4, kernel=(3, 3), activation="tanh",
                                 convolution_mode="same"),
                 L.Subsampling2D(pooling="max", kernel=(2, 2), stride=(2, 2)),
                 L.Convolution2D(n_out=2 * 8, kernel=(1, 1), activation="identity"),
                 L.Yolo2OutputLayer(anchors=[[1.0, 1.5], [2.0, 0.8]], n_classes=3)],
                InputType.convolutional(6, 6, 2))


CASES = {
    # the reference's tests/test_gradientcheck.py
    "mlp_mcxent": (lambda: _net([L.Dense(n_out=8, activation="tanh"),
                                 L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
                                InputType.feed_forward(6)), _ff),
    "mlp_mse_sigmoid": (lambda: _net([L.Dense(n_out=8, activation="sigmoid"),
                                      L.OutputLayer(n_out=3, activation="sigmoid", loss="mse")],
                                     InputType.feed_forward(6)), _ff),
    "mlp_l1_l2": (lambda: _net([L.Dense(n_out=8, activation="elu", l1=0.01, l2=0.02),
                                L.OutputLayer(n_out=3, activation="softmax", loss="mcxent",
                                              l2=0.01)], InputType.feed_forward(6)), _ff),
    "elementwise_mult": (lambda: _net([L.ElementWiseMultiplication(activation="tanh"),
                                       L.OutputLayer(n_out=3, activation="softmax",
                                                     loss="mcxent")],
                                      InputType.feed_forward(6)), _ff),
    "conv_pool_dense": (lambda: _net([L.Convolution2D(n_out=3, kernel=(3, 3), activation="tanh"),
                                      L.Subsampling2D(pooling="max", kernel=(2, 2),
                                                      stride=(2, 2)),
                                      L.OutputLayer(n_out=2, activation="softmax",
                                                    loss="mcxent")],
                                     InputType.convolutional(8, 8, 1)), _img),
    "conv_avg_pool": (lambda: _net([L.Convolution2D(n_out=3, kernel=(3, 3), activation="sigmoid",
                                                    convolution_mode="same"),
                                    L.Subsampling2D(pooling="avg", kernel=(2, 2), stride=(2, 2)),
                                    L.OutputLayer(n_out=2, activation="softmax",
                                                  loss="mcxent")],
                                   InputType.convolutional(8, 8, 1)), _img),
    "batchnorm": (lambda: _net([L.Convolution2D(n_out=3, kernel=(3, 3), activation="identity"),
                                L.BatchNormalization(), L.GlobalPooling(pooling="avg"),
                                L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                               InputType.convolutional(8, 8, 1)), _img),
    "lrn": (lambda: _net([L.Convolution2D(n_out=4, kernel=(3, 3), activation="relu"),
                          L.LocalResponseNormalization(),
                          L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                         InputType.convolutional(8, 8, 1)), _img),
    "lstm": (lambda: _net([L.LSTM(n_out=6),
                           L.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                          InputType.recurrent(4)), _seq),
    "graves_lstm_peephole": (lambda: _net([L.GravesLSTM(n_out=6),
                                           L.RnnOutputLayer(n_out=2, activation="softmax",
                                                            loss="mcxent")],
                                          InputType.recurrent(4)), _seq),
    "bidirectional_lstm": (lambda: _net([L.GravesBidirectionalLSTM(n_out=5),
                                         L.RnnOutputLayer(n_out=2, activation="softmax",
                                                          loss="mcxent")],
                                        InputType.recurrent(4)), _seq),
    "simple_rnn": (lambda: _net([L.SimpleRnn(n_out=6),
                                 L.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                                InputType.recurrent(4)), _seq),
    "masked_rnn": (lambda: _net([L.LSTM(n_out=6),
                                 L.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                                InputType.recurrent(4)), lambda: _seq(mask=_masked())),
    "lstm_global_pooling": (lambda: _net([L.LSTM(n_out=6), L.GlobalPooling(pooling="max"),
                                          L.OutputLayer(n_out=2, activation="softmax",
                                                        loss="mcxent")],
                                         InputType.recurrent(4)),
                            lambda: _seq(per_step=False)),
    # the layers of this slice
    "center_loss": (_center_net, _ff),
    "yolo2": (_yolo_net, _yolo_data),
    "vae_supervised": (lambda: _net([L.VariationalAutoencoder(n_out=3, encoder_layer_sizes=[5],
                                                              decoder_layer_sizes=[5],
                                                              activation="tanh"),
                                     L.OutputLayer(n_out=3, activation="softmax",
                                                   loss="mcxent")],
                                    InputType.feed_forward(6)), _ff),
}

LOSSES = [("xent", "sigmoid"), ("l1", "tanh"), ("hinge", "identity"),
          ("squared_hinge", "identity"), ("poisson", "softplus"),
          ("kl_divergence", "sigmoid"), ("cosine_proximity", "identity")]


def _check(net, ds):
    assert check_gradients(net, ds, epsilon=1e-6, max_rel_error=1e-4, verbose=True)


@pytest.mark.parametrize("case", list(CASES))
def test_port_gradients_pass_the_check(case):
    make, data = CASES[case]
    _check(make(), data())


@pytest.mark.parametrize("loss,act", LOSSES, ids=[l for l, _ in LOSSES])
def test_loss_function_gradients_pass_the_check(loss, act):
    rng = np.random.default_rng(5)
    if loss in ("xent", "kl_divergence"):
        y = rng.uniform(0.1, 0.9, size=(4, 3))
    elif loss == "poisson":
        y = rng.uniform(0.5, 3.0, size=(4, 3))
    else:
        y = np.eye(3)[rng.integers(0, 3, 4)]
    net = _net([L.Dense(n_out=8, activation="tanh"),
                L.OutputLayer(n_out=3, activation=act, loss=loss)], InputType.feed_forward(6))
    _check(net, DataSet(rng.normal(size=(4, 6)), y))


def test_a_center_loss_graph_passes_the_check():
    conf = (GraphBuilder().seed(0).updater(NoOp())
            .add_inputs("in").set_input_types(**{"in": InputType.feed_forward(6)})
            .add_layer("d", L.Dense(n_out=5, activation="tanh"), "in")
            .add_vertex("l2", L2NormalizeVertex(), "d")
            .add_layer("out", L.CenterLossOutputLayer(n_out=3, activation="softmax",
                                                      lambda_=0.5), "l2")
            .set_outputs("out").build())
    conf.param_dtype = conf.compute_dtype = "float64"
    net = ComputationGraph(conf, device="cpu")
    net.init()
    net.state["out"]["centers"] = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 5)))
    _check(net, _ff())


def test_a_wrong_gradient_fails_the_check(monkeypatch):
    net = CASES["mlp_mcxent"][0]()
    real = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad",
                        lambda *a, **k: tuple(None if g is None else g * 1.01
                                              for g in real(*a, **k)))
    assert not check_gradients(net, _ff(), epsilon=1e-6, max_rel_error=1e-4)


@pytest.mark.parametrize("case", ["center_loss", "yolo2"])
def test_analytic_gradients_match_the_reference(case):
    make, data = CASES[case]
    net, ds = make(), data()
    x, y, _, _ = net._batch(ds)
    live = [[t.detach().clone().requires_grad_(True) for t in jax.tree_util.tree_leaves(p)]
            for p in net.params]
    from deeplearning4j_tpu_torch.nn.updaters import tree_unflatten
    params = [tree_unflatten(p, ls) for p, ls in zip(net.params, live)]
    loss = net._loss(params, net.state, x, y, train=False)[0]
    flat = [t for ls in live for t in ls]
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    with enable_x64(True):
        jnet = JNet(JConf.from_dict(net.conf.to_dict()))
        jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(net.params))
        js = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(net.state))
        jy = jax.tree_util.tree_map(jnp.asarray, ds.labels)
        jl, jg = jax.value_and_grad(lambda p: jnet._loss(p, js, jnp.asarray(ds.features), jy,
                                                         train=False, rng=None)[0])(jp)
        jflat = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    assert abs(float(loss) - float(jl)) < 1e-10
    assert len(jflat) == len(grads)
    for g, jgl in zip(grads, jflat):
        np.testing.assert_allclose(g.numpy(), jgl, rtol=0, atol=1e-10)
