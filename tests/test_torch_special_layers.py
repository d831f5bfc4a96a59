"""The port's FrozenLayer, CenterLossOutputLayer, Yolo2OutputLayer and
VariationalAutoencoder (``nn/layers/special.py``, ``objdetect.py``,
``variational.py``) against the JAX package's on the CPU.

Weights and inputs come from a numpy seed; both packages get the same
arrays.  The VAE's noise: the port's ``regularizers.normal`` and the
reference's ``jax.random.normal`` are replaced, for a test, by one numpy
stream each, seeded alike and handed out in call order.

Tolerances: forwards, scores, gradients and decoded predictions 1e-5
(float32, the same ops summed in other orders); the centre update 1e-6;
a frozen layer's gradient exactly zero and its BatchNorm state bitwise
unchanged; the JSON of each class equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import base as jbase
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import objdetect as jobj
from deeplearning4j_tpu.nn.layers import special as jspecial
from deeplearning4j_tpu.nn.layers import variational as jvae
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import regularizers as tR
from deeplearning4j_tpu_torch.nn.layers import base as tbase
from deeplearning4j_tpu_torch.nn.layers import (CenterLossOutputLayer, FrozenLayer,
                                                VariationalAutoencoder, Yolo2OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, atol):
    for x, y in zip(jax.tree_util.tree_leaves(_tree_np(a)), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(_np(x), np.asarray(y), rtol=0, atol=atol)


class Stream:
    """N(0, 1) draws from a numpy stream, in call order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def norm(self, shape):
        return self.rng.standard_normal(tuple(shape)).astype(np.float32)


@pytest.fixture
def one_noise(monkeypatch):
    """``arm()`` feeds both packages' normal draws from one stream each,
    seeded alike.  Arm after drawing the weights: the reference's init
    draws through ``jax.random.normal`` too."""
    def arm():
        port, ref = Stream(77), Stream(77)
        monkeypatch.setattr(tR, "normal", lambda gen, shape: torch.from_numpy(port.norm(shape)))
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
                                ref.norm(shape), dtype))
    return arm


# -- FrozenLayer --------------------------------------------------------------------------

FROZEN = {
    "dense": (lambda m: m.Dense(n_out=5, activation="tanh"), JInputType.feed_forward(6), (4, 6)),
    "batchnorm": (lambda m: m.BatchNormalization(activation="relu"),
                  JInputType.feed_forward(6), (4, 6)),
    "conv": (lambda m: m.Convolution2D(n_out=3, kernel=(3, 3), activation="relu"),
             JInputType.convolutional(6, 6, 2), (4, 6, 6, 2)),
}


def _frozen_pair(inner):
    make, itype, shape = FROZEN[inner]
    jinner = make(jnorm if inner == "batchnorm" else (jconv if inner == "conv" else jff))
    jconf = (JBuilder.builder().seed(3)
             .layer(jspecial.FrozenLayer(layer=jinner))
             .layer(jff.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
             .set_input_type(itype).build())
    jnet = JNet(jconf)
    jnet.init()
    rng = np.random.default_rng(11)
    if inner == "batchnorm":   # running statistics away from 0 / 1
        jnet.state[0] = {"mean": jnp.asarray(rng.normal(size=6).astype(np.float32)),
                         "var": jnp.asarray(rng.uniform(0.5, 2, size=6).astype(np.float32))}
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf.to_dict()), device="cpu")
    net.params = params_from_numpy(_tree_np(jnet.params), device="cpu")
    net.state = params_from_numpy(_tree_np(jnet.state), device="cpu")
    net.opt_state = net.init_opt_state(net.params)
    x = rng.normal(size=shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, shape[0])]
    return net, jnet, x, y


@pytest.mark.parametrize("inner", list(FROZEN))
def test_frozen_layer_forward_is_the_inner_layers_inference_forward(inner):
    net, jnet, x, _ = _frozen_pair(inner)
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(jnet.output(x)), rtol=0, atol=1e-5)
    acts = net.feed_forward(x, train=True)
    jacts = jnet.feed_forward(x, train=False)
    np.testing.assert_allclose(_np(acts[0]), np.asarray(jacts[0]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("inner", list(FROZEN))
def test_frozen_layer_takes_a_zero_gradient_and_keeps_its_state(inner):
    net, jnet, x, y = _frozen_pair(inner)
    before = [dict(s) for s in net.state]
    loss, grads, _ = net._loss_and_grads(DataSet(x, y))
    jgrads = jax.grad(lambda p: jnet._loss(p, jnet.state, jnp.asarray(x), jnp.asarray(y),
                                           train=True, rng=jax.random.PRNGKey(0))[0])(jnet.params)
    for k, g in grads[0].items():
        assert torch.count_nonzero(g) == 0, k
        assert not np.any(np.asarray(jgrads[0][k])), k
    _close(grads[1], jgrads[1], 1e-5)
    frozen = {k: v.clone() for k, v in net.params[0].items()}
    for _ in range(2):
        net.fit_batch(DataSet(x, y))
    for k, v in frozen.items():
        assert torch.equal(net.params[0][k], v), k
    for k, v in before[0].items():
        assert torch.equal(net.state[0][k], v), k
    assert float(net.conf.layers[0].regularization_score(net.params[0])) == 0.0


# -- CenterLossOutputLayer ------------------------------------------------------------------


def _center_case():
    rng = np.random.default_rng(5)
    mb, n_in, c = 6, 4, 5
    x = rng.normal(size=(mb, n_in)).astype(np.float32)
    cls = np.array([0, 1, 1, 3, 0, 3])         # classes 2 and 4 are absent
    y = np.eye(c, dtype=np.float32)[cls]
    p = {"W": rng.normal(size=(n_in, c)).astype(np.float32),
         "b": rng.normal(size=c).astype(np.float32)}
    s = {"centers": rng.normal(size=(c, n_in)).astype(np.float32)}
    kw = dict(n_in=n_in, n_out=c, activation="softmax", alpha=0.3, lambda_=0.7)
    return CenterLossOutputLayer(**kw), jspecial.CenterLossOutputLayer(**kw), x, y, p, s


@pytest.mark.parametrize("fn", ["score", "score_examples"])
def test_center_loss_scores_match_the_reference(fn):
    layer, jlayer, x, y, p, s = _center_case()
    got = getattr(layer, fn)({k: _t(v) for k, v in p.items()}, {k: _t(v) for k, v in s.items()},
                             _t(x), _t(y))
    want = getattr(jlayer, fn)(p, s, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)


def test_center_update_matches_the_reference_and_keeps_absent_classes():
    layer, jlayer, x, y, _, s = _center_case()
    got = layer.update_centers({"centers": _t(s["centers"])}, _t(x), _t(y))["centers"]
    want = np.asarray(jlayer.update_centers(s, jnp.asarray(x), jnp.asarray(y))["centers"])
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
    for absent in (2, 4):
        np.testing.assert_array_equal(_np(got)[absent], s["centers"][absent])
    assert not np.allclose(_np(got)[0], s["centers"][0])


# -- Yolo2OutputLayer -----------------------------------------------------------------------


def yolo_labels(rng, n, gh, gw, boxes=5, classes=20, per_image=3):
    """The reference's label dict: ``per_image`` objects an image at
    random cells and anchors."""
    b = (rng.normal(size=(n, gh, gw, boxes, 4)) * 0.3).astype(np.float32)
    b[..., :2] = rng.random((n, gh, gw, boxes, 2))
    obj = np.zeros((n, gh, gw, boxes), np.float32)
    cls = np.zeros((n, gh, gw, classes), np.float32)
    for i in range(n):
        for _ in range(per_image):
            r, c, k = rng.integers(0, gh), rng.integers(0, gw), rng.integers(0, boxes)
            obj[i, r, c, k] = 1
            cls[i, r, c] = 0
            cls[i, r, c, rng.integers(0, classes)] = 1
    return {"boxes": b, "obj": obj, "cls": cls}


def _yolo_case():
    rng = np.random.default_rng(9)
    anchors = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38]]
    kw = dict(anchors=anchors, n_classes=4, lambda_coord=5.0, lambda_noobj=0.5)
    x = rng.normal(size=(3, 4, 5, 3 * 9)).astype(np.float32)
    return (Yolo2OutputLayer(**kw), jobj.Yolo2OutputLayer(**kw), x,
            yolo_labels(rng, 3, 4, 5, boxes=3, classes=4, per_image=4))


def test_yolo_score_and_its_input_gradient_match_the_reference():
    layer, jlayer, x, y = _yolo_case()
    xt = _t(x).requires_grad_(True)
    loss = layer.score({}, {}, xt, {k: _t(v) for k, v in y.items()})
    (g,) = torch.autograd.grad(loss, xt)
    loss = loss.detach()
    jy = {k: jnp.asarray(v) for k, v in y.items()}
    jloss, jg = jax.value_and_grad(lambda a: jlayer.score({}, {}, a, jy))(jnp.asarray(x))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=0, atol=1e-5)


def test_yolo_decode_predictions_match_the_reference():
    layer, jlayer, x, _ = _yolo_case()
    got = layer.decode_predictions(_t(x), conf_threshold=0.4)
    want = jlayer.decode_predictions(jnp.asarray(x), conf_threshold=0.4)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "detect":
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0, atol=1e-5)
    assert got["class_probs"].shape == (3, 4, 5, 3, 4)


# -- VariationalAutoencoder -------------------------------------------------------------------

VAE_KINDS = ["bernoulli", "gaussian"]


def _vae_case(kind):
    kw = dict(n_in=10, n_out=3, encoder_layer_sizes=[8, 7], decoder_layer_sizes=[6],
              activation="tanh", reconstruction=kind, num_samples=2)
    jlayer = jvae.VariationalAutoencoder(**kw)
    jp = _tree_np(jlayer.init_params(jax.random.PRNGKey(4), JInputType.feed_forward(10)))
    rng = np.random.default_rng(8)
    x = (rng.random((5, 10)) < 0.4).astype(np.float32) if kind == "bernoulli" else \
        rng.normal(size=(5, 10)).astype(np.float32)
    return VariationalAutoencoder(**kw), jlayer, jp, x


@pytest.mark.parametrize("kind", VAE_KINDS)
def test_vae_elbo_and_its_gradients_match_the_reference(kind, one_noise):
    layer, jlayer, jp, x = _vae_case(kind)
    one_noise()
    p = params_from_numpy(jp, device="cpu")
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(p)]
    loss = layer.elbo_score(p, _t(x), generator=torch.Generator())
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    jloss, jg = jax.value_and_grad(
        lambda q: jlayer.elbo_score(q, jnp.asarray(x), rng=jax.random.PRNGKey(0)))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6, atol=1e-5)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", VAE_KINDS)
def test_vae_forward_and_generate_match_the_reference(kind):
    layer, jlayer, jp, x = _vae_case(kind)
    p = params_from_numpy(jp, device="cpu")
    np.testing.assert_allclose(_np(layer.forward(p, {}, _t(x)).y),
                               np.asarray(jlayer.forward(jp, {}, jnp.asarray(x)).y),
                               rtol=0, atol=1e-5)
    z = np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)
    got = layer.generate(p, _t(z))
    np.testing.assert_allclose(_np(got), np.asarray(jlayer.generate(jp, jnp.asarray(z))),
                               rtol=0, atol=1e-5)
    assert got.shape == (4, 10)


@pytest.mark.parametrize("kind", VAE_KINDS)
def test_vae_reconstruction_log_probability_matches_the_reference(kind, one_noise):
    layer, jlayer, jp, x = _vae_case(kind)
    one_noise()
    p = params_from_numpy(jp, device="cpu")
    got = layer.reconstruction_log_probability(p, _t(x), generator=torch.Generator(),
                                               num_samples=4)
    want = jlayer.reconstruction_log_probability(jp, jnp.asarray(x), rng=jax.random.PRNGKey(1),
                                                 num_samples=4)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-5)
    prob = layer.reconstruction_probability(p, _t(x), generator=torch.Generator(), num_samples=4)
    assert prob.shape == (5,) and bool(torch.all(prob >= 0))


# -- JSON ----------------------------------------------------------------------------------

JSON_CASES = {
    "frozen_dense": lambda m: m.FrozenLayer(layer=m.Dense(n_out=4, activation="relu", l2=0.1)),
    "frozen_batchnorm": lambda m: m.FrozenLayer(layer=m.BatchNormalization(decay=0.8)),
    "center_loss": lambda m: m.CenterLossOutputLayer(n_out=7, activation="softmax", alpha=0.1,
                                                     lambda_=0.01),
    "yolo2": lambda m: m.Yolo2OutputLayer(anchors=[[1.0, 2.0], [3.0, 4.5]], n_classes=3,
                                          lambda_noobj=0.25),
    "vae": lambda m: m.VariationalAutoencoder(n_out=5, encoder_layer_sizes=[16, 8],
                                              decoder_layer_sizes=[8], reconstruction="gaussian",
                                              num_samples=3),
}


class _JaxLayers:
    Dense = jff.Dense
    BatchNormalization = jnorm.BatchNormalization
    FrozenLayer = jspecial.FrozenLayer
    CenterLossOutputLayer = jspecial.CenterLossOutputLayer
    Yolo2OutputLayer = jobj.Yolo2OutputLayer
    VariationalAutoencoder = jvae.VariationalAutoencoder


class _PortLayers:
    from deeplearning4j_tpu_torch.nn.layers import BatchNormalization, Dense  # noqa: F401
    FrozenLayer = FrozenLayer
    CenterLossOutputLayer = CenterLossOutputLayer
    Yolo2OutputLayer = Yolo2OutputLayer
    VariationalAutoencoder = VariationalAutoencoder


@pytest.mark.parametrize("case", list(JSON_CASES))
def test_layer_json_round_trips_the_reference(case):
    jd = jbase.layer_to_dict(JSON_CASES[case](_JaxLayers))
    layer = tbase.layer_from_dict(jd)
    assert type(layer).__name__ == jd["type"]
    assert tbase.layer_to_dict(layer) == jd
    assert tbase.layer_to_dict(JSON_CASES[case](_PortLayers)) == jd
    assert jbase.layer_to_dict(jbase.layer_from_dict(tbase.layer_to_dict(layer))) == jd


# -- checkpoints and the weight bridge ------------------------------------------------------


def _nested_net():
    """FrozenLayer(Dense) → VAE → CenterLossOutputLayer: a nested layer
    config, the VAE's nested parameter lists and the centres in state."""
    jconf = (JBuilder.builder().seed(2)
             .layer(jspecial.FrozenLayer(layer=jff.Dense(n_out=8, activation="tanh")))
             .layer(jvae.VariationalAutoencoder(n_out=4, encoder_layer_sizes=[6, 5],
                                                decoder_layer_sizes=[5]))
             .layer(jspecial.CenterLossOutputLayer(n_out=3, activation="softmax"))
             .set_input_type(JInputType.feed_forward(7)).build())
    jnet = JNet(jconf)
    jnet.init()
    rng = np.random.default_rng(6)
    jnet.state[2] = {"centers": jnp.asarray(rng.normal(size=(3, 4)).astype(np.float32))}
    return jnet, rng.normal(size=(5, 7)).astype(np.float32)


def _leaves_np(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(_tree_np(tree))]


def test_checkpoints_of_the_new_layers_round_trip_both_ways(tmp_path):
    from deeplearning4j_tpu.utils.serializer import load_model as jload
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    jnet, x = _nested_net()
    jnet.save(str(tmp_path / "jax.zip"))
    net = load_model(str(tmp_path / "jax.zip"), device="cpu")
    assert isinstance(net.conf.layers[0], FrozenLayer)
    assert isinstance(net.params[1]["enc"], list) and len(net.params[1]["enc"]) == 2
    for a, b in ((net.params, jnet.params), (net.state, jnet.state),
                 (net.opt_state, jnet.opt_state)):
        for u, v in zip(_leaves_np(params_to_numpy(a)), _leaves_np(b)):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(jnet.output(x)), rtol=0, atol=1e-5)
    net.save(str(tmp_path / "port.zip"))
    back = jload(str(tmp_path / "port.zip"))
    assert back.conf.to_dict() == jnet.conf.to_dict()
    for a, b in ((back.params, jnet.params), (back.state, jnet.state)):
        for u, v in zip(_leaves_np(a), _leaves_np(b)):
            np.testing.assert_array_equal(u, v)


def test_the_weight_bridge_carries_nested_trees():
    jnet, _ = _nested_net()
    p = params_from_numpy(_tree_np(jnet.params), device="cpu")
    assert isinstance(p[1]["dec"], list) and p[1]["dec"][0]["W"].shape == (4, 5)
    for u, v in zip(_leaves_np(params_to_numpy(p)), _leaves_np(jnet.params)):
        np.testing.assert_array_equal(u, v)
