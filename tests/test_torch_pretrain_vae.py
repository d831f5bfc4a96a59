"""Layerwise pretraining of a VariationalAutoencoder in both containers,
and the network's ``reconstruction_log_probability``, against the JAX
package on the CPU.

Each network is built by the reference, and the port's from its
configuration JSON with its weights.  Both packages' normal draws come
from one numpy stream each, seeded alike (the port's
``regularizers.normal``, the reference's ``jax.random.normal``), armed
after the weights are drawn; the reference runs under
``jax.disable_jit()`` so it draws at every step, as the port does.

Tolerances: per-step pretraining losses (negative ELBO), the VAE's
parameters and Adam moments after them, the IWAE log-probabilities, and
the supervised steps after pretraining, all 1e-5 (float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.nn import graph as jg
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import variational as jvae
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import regularizers as tR
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.params import params_from_numpy

TOL = 1e-5


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port_tree, ref_tree, atol=TOL):
    a = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), port_tree))
    b = jax.tree_util.tree_leaves(_tree_np(ref_tree))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


@pytest.fixture
def one_noise(monkeypatch):
    """``arm()``: both packages' normal draws from one numpy stream each."""
    def arm():
        port, ref = np.random.default_rng(31), np.random.default_rng(31)
        monkeypatch.setattr(tR, "normal", lambda gen, shape: torch.from_numpy(
            port.standard_normal(tuple(shape)).astype(np.float32)))
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
                                ref.standard_normal(tuple(shape)).astype(np.float32), dtype))
    return arm


def _vae(kind="bernoulli"):
    return jvae.VariationalAutoencoder(n_out=4, encoder_layer_sizes=[16, 12],
                                       decoder_layer_sizes=[12], activation="tanh",
                                       reconstruction=kind, num_samples=2)


def _data(n=16, f=20, classes=3, seed=2, binary=True):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, f)) < 0.3).astype(np.float32) if binary else \
        rng.normal(size=(n, f)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _mln_pair(kind, dense_first=False):
    b = JBuilder.builder().seed(5).updater(JAdam(lr=1e-2))
    if dense_first:
        b.layer(jff.Dense(n_out=20, activation="sigmoid"))
    jconf = (b.layer(_vae(kind))
             .layer(jff.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
             .set_input_type(JInputType.feed_forward(20)).build())
    jnet = JNet(jconf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf.to_dict()), device="cpu")
    net.params = params_from_numpy(_tree_np(jnet.params), device="cpu")
    net.state = [{} for _ in net.params]
    net.opt_state = params_from_numpy(_tree_np(jnet.opt_state), device="cpu")
    return net, jnet


@pytest.mark.parametrize("kind", ["bernoulli", "gaussian"])
def test_mln_pretrain_of_a_vae_matches_the_reference(kind, one_noise):
    net, jnet = _mln_pair(kind)
    assert net.pretrainable_layers() == jnet.pretrainable_layers() == [0]
    batches = [_data(seed=s, binary=kind == "bernoulli") for s in range(3)]
    one_noise()
    losses = [float(v) for v in net.pretrain([DataSet(x, y) for x, y in batches], epochs=1)[0]]
    with jax.disable_jit():
        jlosses = [float(v) for v in jnet.pretrain(JList([JDataSet(x, y) for x, y in batches]),
                                                   epochs=1)[0]]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=TOL)
    _close(net.params[0], jnet.params[0])
    _close(net.opt_state[0], jnet.opt_state[0])
    # then supervised steps from the pretrained weights
    for x, y in batches:
        assert abs(float(net.fit_batch(DataSet(x, y)))
                   - float(jnet.fit_batch(JDataSet(x, y)))) < TOL
    _close(net.params, jnet.params)


def test_graph_pretrain_of_a_vae_matches_the_reference(one_noise):
    jconf = (jg.GraphBuilder().seed(6).updater(JAdam(lr=1e-2))
             .add_inputs("in").set_input_types(**{"in": JInputType.feed_forward(20)})
             .add_layer("vae", _vae(), "in")
             .add_layer("out", jff.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                        "vae")
             .set_outputs("out").build())
    jnet = jg.ComputationGraph(jconf)
    jnet.init()
    net = ComputationGraph(ComputationGraphConfiguration.from_dict(jconf.to_dict()),
                           device="cpu")
    net.params = params_from_numpy(_tree_np(jnet.params), device="cpu")
    net.state = {n: {} for n in net.params}
    net.opt_state = params_from_numpy(_tree_np(jnet.opt_state), device="cpu")
    assert net.pretrainable_layers() == jnet.pretrainable_layers() == ["vae"]
    batches = [_data(seed=10 + s) for s in range(3)]
    one_noise()
    losses = [float(v) for v in net.pretrain([DataSet(x, y) for x, y in batches])["vae"]]
    with jax.disable_jit():
        jlosses = [float(v) for v in
                   jnet.pretrain(JList([JDataSet(x, y) for x, y in batches]))["vae"]]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=TOL)
    _close(net.params["vae"], jnet.params["vae"])


@pytest.mark.parametrize("layer_index", [None, 1])
def test_network_reconstruction_log_probability_matches_the_reference(layer_index, one_noise):
    """Through a Dense layer below the VAE: the input is featurized first."""
    net, jnet = _mln_pair("bernoulli", dense_first=True)
    x, _ = _data(n=7, seed=4)
    one_noise()
    got = net.reconstruction_log_probability(x, layer_index=layer_index, num_samples=5)
    prob = net.reconstruction_probability(x, layer_index=layer_index, num_samples=5)
    with jax.disable_jit():
        want = jnet.reconstruction_log_probability(x, layer_index=layer_index, num_samples=5)
        jprob = jnet.reconstruction_probability(x, layer_index=layer_index, num_samples=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=TOL)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), rtol=1e-5, atol=0)
    assert got.shape == (7,)


def test_reconstruction_log_probability_errors():
    net, _ = _mln_pair("bernoulli", dense_first=True)
    with pytest.raises(ValueError, match="not a VariationalAutoencoder"):
        net.reconstruction_log_probability(np.zeros((2, 20), np.float32), layer_index=0)
    with pytest.raises(ValueError, match="no unsupervised objective"):
        net.pretrain_layer(2, [DataSet(*_data())])
