"""The port's MLP path against the JAX package on the CPU: the two MLP
checkpoint gates, the five feed-forward layers that were missing, the
weight-init schemes, layerwise pretraining and the input preprocessors.

Weights go from the reference to the port with ``params_from_numpy``;
random numbers that both must share (the pretraining's corruption and
Gibbs samples) come from one numpy stream through the draw functions
each package calls (``nn/conf/regularizers.bernoulli`` in the port,
``jax.random.bernoulli`` in the reference), the reference run with jit
off so it draws at every step.

Tolerances: the checkpoint gates 1e-6 (outputs, and every parameter
after the golden zip's 5 steps; 5e-6 after the Iris zip's 20, see its
test); layer forwards and gradients 1e-6 (f32, the same ops); pretraining
1e-5 over 3 steps; preprocessors 1e-6; init schemes: the deterministic
one exact, the random ones' scale equal to the reference's formula (to
float32, as its draw returns it) and a [512, 512] draw's mean and
variance within 3 standard errors of the scheme's.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JListIterator
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.ops import initializers as jinit
from deeplearning4j_tpu.utils.serializer import load_model as j_load
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre
from deeplearning4j_tpu_torch.nn.conf import regularizers as tR
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import initializers as tinit
from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.utils.serializer import load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
IRIS_ZIP = os.path.join(REPO, "deeplearning4j_tpu", "models", "weights", "iris_mlp_iris.zip")


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested list/dict tree."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def _assert_trees(port_tree, ref_tree, atol):
    a, b = _flat(port_tree), _flat(ref_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


# -- the two MLP gates --------------------------------------------------------------


def test_mln_golden_zip_output_matches_the_pinned_output():
    net = load_model(os.path.join(FIX, "mln_golden.zip"), device="cpu")
    x = np.random.default_rng(99).normal(size=(4, 8)).astype(np.float32)
    want = np.load(os.path.join(FIX, "mln_golden_output.npy"))
    np.testing.assert_allclose(net.output(x).numpy(), want, rtol=0, atol=1e-6)


def test_mln_golden_zip_adam_steps_match_the_reference():
    path = os.path.join(FIX, "mln_golden.zip")
    net, jnet = load_model(path, device="cpu"), j_load(path)
    _assert_trees(net.opt_state, jnet.opt_state, 0)
    rng = np.random.default_rng(7)
    for _ in range(5):
        x = rng.normal(size=(16, 8)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
        lt, lj = float(net.fit_batch(DataSet(x, y))), float(jnet.fit_batch(JDataSet(x, y)))
        assert abs(lt - lj) <= 1e-6
    assert net.iteration == jnet.iteration
    _assert_trees(net.params, jnet.params, 1e-6)


def test_iris_zip_output_and_adam_steps_match_the_reference():
    """The shipped Iris MLP (trained 1,200 Adam steps on the 150 rows) and
    20 more full-batch steps from its updater state.  The output at load
    agrees within 1e-6.  After the steps the parameters agree within 5e-6,
    not 1e-6: XLA's float32 tanh differs from torch's by 1-2 spacings on
    most inputs, and Adam carries such differences of the gradients of
    this trained net (raw features up to 7.9) into the first layer's
    weights (measured: 2.18e-6 max, on a weight of 0.27)."""
    from deeplearning4j_tpu_torch.datasets.fetchers import load_iris

    net, jnet = load_model(IRIS_ZIP, device="cpu"), j_load(IRIS_ZIP)
    xs, ys = load_iris()
    np.testing.assert_allclose(net.output(xs).numpy(), np.asarray(jnet.output(xs)),
                               rtol=0, atol=1e-6)
    labels = np.eye(3, dtype=np.float32)[ys]
    for _ in range(20):
        lt = float(net.fit_batch(DataSet(xs, labels)))
        lj = float(jnet.fit_batch(JDataSet(xs, labels)))
        assert abs(lt - lj) <= 1e-6
    assert net.iteration == jnet.iteration == 1220
    _assert_trees(net.params, jnet.params, 5e-6)
    _assert_trees(net.opt_state, jnet.opt_state, 5e-6)


# -- the fetchers ------------------------------------------------------------------------


def _idx(path, magic, dims, data):
    import gzip
    import struct

    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I" + "I" * len(dims), magic, *dims))
        f.write(data.astype(np.uint8).tobytes())


@pytest.mark.parametrize("source", ["idx", "synthetic"])
def test_load_mnist_and_iris_give_the_references_arrays(source, tmp_path, monkeypatch):
    from deeplearning4j_tpu.datasets import fetchers as jf
    from deeplearning4j_tpu_torch.datasets import fetchers as tf

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    if source == "idx":
        rng = np.random.default_rng(17)
        _idx(tmp_path / "t10k-images-idx3-ubyte.gz", 2051, (5, 28, 28),
             rng.integers(0, 256, (5, 28, 28)))
        _idx(tmp_path / "t10k-labels-idx1-ubyte.gz", 2049, (5,), rng.integers(0, 10, 5))
    got, want = tf.load_mnist(train=False, synthetic_n=64), jf.load_mnist(train=False,
                                                                           synthetic_n=64)
    assert got[0].shape == (5 if source == "idx" else 64, 28, 28, 1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tf.load_iris(), jf.load_iris()):
        np.testing.assert_array_equal(a, b)
    if source == "synthetic":
        with pytest.raises(FileNotFoundError, match="MNIST IDX files not found"):
            tf.load_mnist(allow_synthetic=False)


# -- the five feed-forward layers ------------------------------------------------------


def _layer_pair(name, **kw):
    return getattr(tff, name)(**kw), getattr(jff, name)(**kw)


LAYER_CASES = [
    ("ActivationLayer", dict(activation="tanh"), None),
    ("DropoutLayer", dict(dropout=0.5), None),
    ("ElementWiseMultiplication", dict(n_in=6, activation="sigmoid"), 6),
    ("AutoEncoder", dict(n_in=6, n_out=4, activation="sigmoid"), 6),
    ("RBM", dict(n_in=6, n_out=4), 6),
]


@pytest.mark.parametrize("name,kw,n_in", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_feed_forward_layer_forward_and_gradients_match(name, kw, n_in):
    tl, jl = _layer_pair(name, **kw)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    w = rng.normal(size=(5, getattr(tl, "n_out", 0) or 6)).astype(np.float32)
    jp = jl.init_params(jax.random.PRNGKey(0), JInputType.feed_forward(6))
    # give the parameters non-trivial values so every gradient is exercised
    jp = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in jp.items()}
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    assert tl.has_params() == jl.has_params() and sorted(tp) == sorted(jp)

    def jloss(p, xx):
        return jnp.sum(jl.forward(p, {}, xx).y * w)
    jy = jl.forward(jp, {}, jnp.asarray(x)).y
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = tl.forward(live, {}, xt).y
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum(),
                                [xt] + [live[k] for k in sorted(live)], allow_unused=True)
    # a parameter the forward does not read (the visible bias) has no
    # gradient here and a zero one in the reference
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, [xt] + [live[k] for k in sorted(live)])]
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=0, atol=1e-6)
    for k, g in zip(sorted(live), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=0, atol=1e-6, err_msg=k)


def test_dropout_layer_is_identity_outside_training_and_drops_in_it():
    layer = tff.DropoutLayer(dropout=0.5)
    x = torch.ones(64, 64)
    assert torch.equal(layer.forward({}, {}, x).y, x)
    y = layer.forward({}, {}, x, train=True, generator=torch.Generator().manual_seed(0)).y
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.05 and torch.all((y == 0) | (y == 2.0))
    with pytest.raises(ValueError, match="generator"):
        layer.forward({}, {}, x, train=True)


def test_output_layers_score_examples_match_the_reference():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    for name in ("LossLayer",):
        tl, jl = _layer_pair(name, activation="softmax", loss="mcxent")
        got = tl.score_examples({}, {}, torch.from_numpy(x), torch.from_numpy(y))
        want = jl.score_examples({}, {}, jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# -- init schemes ------------------------------------------------------------------------

#: the random schemes ported here, with the distribution each draws from
NEW_SCHEMES = {"xavier_fan_in": "normal", "relu_uniform": "uniform",
               "sigmoid_uniform": "uniform", "lecun_normal": "normal",
               "lecun_uniform": "uniform", "var_scaling_normal_fan_in": "normal",
               "var_scaling_normal_fan_out": "normal", "var_scaling_normal_fan_avg": "normal",
               "var_scaling_uniform_fan_in": "uniform",
               "var_scaling_uniform_fan_out": "uniform",
               "var_scaling_uniform_fan_avg": "uniform"}


def test_identity_init_is_exactly_the_reference():
    got = tinit.init_weight((7, 7), "identity", 7, 7, torch.float32, torch.Generator())
    want = jinit.init_weight(jax.random.PRNGKey(0), (7, 7), "identity", 7, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="square"):
        tinit.init_weight((3, 4), "identity", 3, 4)


@pytest.mark.parametrize("scheme", NEW_SCHEMES)
def test_random_init_scheme_scale_and_moments(scheme, monkeypatch):
    fi, fo = 300.0, 120.0
    # the scale the port passes to its draw ...
    seen = {}

    def rec_normal(shape, std, generator):
        seen["kind"], seen["scale"] = "normal", std
        return torch.zeros(shape)

    def rec_uniform(shape, limit, generator):
        seen["kind"], seen["scale"] = "uniform", limit
        return torch.zeros(shape)
    with monkeypatch.context() as m:
        m.setattr(tinit, "draw_normal", rec_normal)
        m.setattr(tinit, "draw_uniform", rec_uniform)
        tinit.init_weight((4, 4), scheme, fi, fo)
    # ... equals the reference's: its normal draw replaced by ones gives
    # the std, its uniform draw replaced by maxval gives the limit
    with monkeypatch.context() as m:
        m.setattr(jinit.jax.random, "normal",
                  lambda key, shape, dtype=jnp.float32: jnp.ones(shape, dtype))
        m.setattr(jinit.jax.random, "uniform",
                  lambda key, shape, minval, maxval, dtype=jnp.float32:
                  jnp.full(shape, maxval, dtype))
        want = float(np.asarray(jinit.init_weight(jax.random.PRNGKey(0), (4, 4),
                                                  scheme, fi, fo))[0, 0])
    # (the reference's draw gives the scale rounded to float32)
    assert seen["kind"] == NEW_SCHEMES[scheme]
    assert np.float32(seen["scale"]) == np.float32(want)
    # and a real [512, 512] draw has the scheme's moments
    w = tinit.init_weight((512, 512), scheme, fi, fo, torch.float64,
                          torch.Generator().manual_seed(1)).double()
    n = w.numel()
    var = want ** 2 if seen["kind"] == "normal" else want ** 2 / 3.0
    kurt = 3.0 if seen["kind"] == "normal" else 1.8
    assert abs(w.mean().item()) <= 3 * math.sqrt(var / n)
    assert abs(w.var(unbiased=False).item() - var) <= 3 * var * math.sqrt((kurt - 1) / n)


# -- pretraining -------------------------------------------------------------------------


class SharedDraws:
    """One numpy stream of bernoulli draws, handed out in call order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def bern(self, p, shape):
        p = np.asarray(p, np.float64)
        shape = tuple(shape) if shape is not None else p.shape
        return self.rng.random(shape) < p


def _patch_bernoulli(monkeypatch, seed):
    port, ref = SharedDraws(seed), SharedDraws(seed)
    monkeypatch.setattr(tR, "bernoulli", lambda gen, p, shape: torch.from_numpy(
        port.bern(p.detach().numpy() if isinstance(p, torch.Tensor) else p, shape)))
    monkeypatch.setattr(jff.jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(ref.bern(np.asarray(p), shape)))


def _pretrain_pair(layer_t, layer_j):
    jconf = (JBuilder.builder().seed(5).updater(JAdam(lr=0.05))
             .layer(jff.Dense(n_in=6, n_out=6, activation="tanh"))
             .layer(layer_j).layer(jff.OutputLayer(n_out=3, activation="softmax"))
             .set_input_type(JInputType.feed_forward(6)).build())
    jnet = JNet(jconf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf.to_dict()), device="cpu")
    net.params = params_from_numpy([jax.tree_util.tree_map(np.asarray, p) for p in jnet.params],
                                   device="cpu")
    net.state = [{} for _ in net.params]
    net.opt_state = params_from_numpy(
        [jax.tree_util.tree_map(np.asarray, o) for o in jnet.opt_state], device="cpu")
    return net, jnet


@pytest.mark.parametrize("kind", ["AutoEncoder", "RBM"])
def test_pretrain_layer_matches_the_reference_under_shared_draws(kind, monkeypatch):
    kw = dict(n_out=4, corruption_level=0.3, activation="sigmoid") if kind == "AutoEncoder" \
        else dict(n_out=4, k=2)
    net, jnet = _pretrain_pair(getattr(tff, kind)(**kw), getattr(jff, kind)(**kw))
    assert net.pretrainable_layers() == jnet.pretrainable_layers() == [1]
    rng = np.random.default_rng(13)
    data = [DataSet(rng.random((8, 6)).astype(np.float32)) for _ in range(3)]
    _patch_bernoulli(monkeypatch, 21)
    lt = [float(v) for v in net.pretrain_layer(1, data)]
    with jax.disable_jit():
        lj = [float(v) for v in jnet.pretrain_layer(
            1, JListIterator([JDataSet(d.features) for d in data]))]
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    _assert_trees(net.params, jnet.params, 1e-5)
    _assert_trees(net.opt_state, jnet.opt_state, 1e-5)


def test_pretrain_refuses_a_layer_without_an_objective():
    net, _ = _pretrain_pair(tff.RBM(n_out=4), jff.RBM(n_out=4))
    with pytest.raises(ValueError, match="unsupervised"):
        net.pretrain_layer(0, [DataSet(np.zeros((2, 6), np.float32))])
    assert sorted(net.pretrain([DataSet(np.full((2, 6), 0.5, np.float32))])) == [1]


# -- preprocessors -----------------------------------------------------------------------

PRE_CASES = [
    ("RnnToFeedForward", {}, (3, 4, 5)),
    ("FeedForwardToRnn", {"timesteps": 4}, (12, 5)),
    ("UnitVariance", {}, (3, 4, 5)),
    ("ZeroMean", {}, (3, 20)),
    ("ZeroMean", {"unit_variance": True}, (3, 4, 5)),
]


@pytest.mark.parametrize("name,kw,shape", PRE_CASES,
                         ids=[f"{c[0]}{'_uv' if c[1].get('unit_variance') else ''}"
                              for c in PRE_CASES])
def test_preprocessor_matches_the_reference(name, kw, shape):
    x = np.random.default_rng(14).normal(size=shape).astype(np.float32)
    tp, jp = getattr(tpre, name)(**kw), getattr(jpre, name)(**kw)
    np.testing.assert_allclose(tp.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(jp.apply(jnp.asarray(x))), rtol=0, atol=1e-6)
    t_in = InputType.recurrent(5, 4) if len(shape) == 3 else InputType.feed_forward(shape[-1])
    j_in = JInputType.recurrent(5, 4) if len(shape) == 3 else JInputType.feed_forward(shape[-1])
    assert tp.output_type(t_in).to_dict() == jp.output_type(j_in).to_dict()


def test_composable_and_binomial_sampling_match_the_reference(monkeypatch):
    x = np.random.default_rng(15).random((4, 6)).astype(np.float32)
    steps = [tpre.ZeroMean(), tpre.UnitVariance()]
    got = tpre.Composable(steps).apply(torch.from_numpy(x))
    want = jpre.Composable([jpre.ZeroMean(), jpre.UnitVariance()]).apply(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    port, ref = SharedDraws(3), SharedDraws(3)
    monkeypatch.setattr(tR, "bernoulli", lambda gen, p, shape: torch.from_numpy(
        port.bern(p.numpy(), shape)))
    monkeypatch.setattr(jpre.jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(ref.bern(np.asarray(p), shape)))
    got = tpre.BinomialSampling().apply(torch.from_numpy(x))
    want = jpre.BinomialSampling().apply(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_a_network_with_preprocessors_matches_the_reference():
    """An explicit FeedForwardToRnn preprocessor before an RNN layer, and
    ``_infer_types``' own choices: no adapter for recurrent input into a
    Dense layer (it runs time-distributed), flattening of cnn_flat input."""
    from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer as JRnnOut
    from deeplearning4j_tpu.nn.layers.recurrent import SimpleRnn as JSimpleRnn

    jconf = (JBuilder.builder().seed(2)
             .layer(jff.Dense(n_out=6, activation="tanh"))
             .layer(JSimpleRnn(n_out=5))
             .layer(jff.Dense(n_out=4, activation="relu"))
             .layer(JRnnOut(n_out=3, activation="softmax"))
             .preprocessor(1, jpre.FeedForwardToRnn(timesteps=4))
             .preprocessor(0, jpre.ZeroMean())
             .set_input_type(JInputType.feed_forward(5)).build())
    jnet = JNet(jconf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf.to_dict()), device="cpu")
    assert [t.to_dict() for t in net.input_types] == [t.to_dict() for t in jnet.input_types]
    net.params = params_from_numpy([jax.tree_util.tree_map(np.asarray, p) for p in jnet.params],
                                   device="cpu")
    net.state = [{} for _ in net.params]
    x = np.random.default_rng(16).normal(size=(8, 5)).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=1e-6)
    # cnn_flat input into a Dense layer flattens without a preprocessor
    flat = (JBuilder.builder().layer(jff.Dense(n_out=3))
            .layer(jff.OutputLayer(n_out=2))
            .set_input_type(JInputType.convolutional_flat(2, 3, 1)).build())
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_dict(flat.to_dict()), device="cpu")
    assert tnet.conf.layers[0].n_in == JNet(flat).conf.layers[0].n_in == 6
    assert not tnet.conf.preprocessors


@pytest.mark.parametrize("in_type,layer", [
    (InputType.convolutional(4, 4, 2), "Dense"),
    (InputType.convolutional(4, 4, 2), "SimpleRnn"),
])
def test_convolutional_adapters_raise_naming_queue_5(in_type, layer):
    """The convolutional adapters once raised, naming the queue that ported
    them; they are ported now, so the network inserts the reference's
    adapter and its output is the reference's (1e-6)."""
    from deeplearning4j_tpu.nn.layers import recurrent as jrec

    jfirst = jff.Dense(n_out=3) if layer == "Dense" else jrec.SimpleRnn(n_out=3)
    jhead = (jff.OutputLayer(n_out=2) if layer == "Dense"
             else jrec.RnnOutputLayer(n_out=2, activation="softmax"))
    jconf = (JBuilder.builder().layer(jfirst).layer(jhead)
             .set_input_type(JInputType.convolutional(4, 4, 2)).build())
    jnet = JNet(jconf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf.to_dict()), device="cpu")
    want = tpre.CnnToFeedForward if layer == "Dense" else tpre.CnnToRnn
    assert isinstance(net.conf.preprocessors[0], want)
    assert type(jnet.conf.preprocessors[0]).__name__ == want.__name__
    net.params = params_from_numpy([jax.tree_util.tree_map(np.asarray, p) for p in jnet.params],
                                   device="cpu")
    net.state = [{} for _ in net.params]
    x = np.random.default_rng(17).normal(size=(3,) + in_type.batch_shape(1)[1:]).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=1e-6)
    y = tpre.RnnToCnn(channels=2).apply(torch.arange(8.0).reshape(1, 2, 4))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jpre.RnnToCnn(channels=2).apply(jnp.arange(8.0).reshape(1, 2, 4))))
