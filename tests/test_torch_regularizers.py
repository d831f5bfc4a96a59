"""The port's dropout, weight noise and parameter constraints
(``nn/conf/regularizers.py``) against the JAX package on the CPU.

Both packages are fed the same random numbers: the port's two draw
functions (``regularizers.bernoulli`` / ``regularizers.normal``) and
``jax.random.bernoulli`` / ``jax.random.normal`` as the reference's
``nn/conf/regularizers.py`` sees them are replaced, for the test, by one
numpy stream each, seeded alike and handed out in call order.  The
reference runs with jit off, so it draws at every step as the port does.
No file of the JAX package changes.

Tolerances: each dropout config and weight noise 1e-6 (the same ops on
the same numbers); a 3-step ``fit_batch`` with dropout and weight noise
1e-5 (losses and every parameter); each constraint 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import regularizers as jR
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import regularizers as tR
from deeplearning4j_tpu_torch.nn.layers.base import config_from_dict, config_to_dict
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.params import params_from_numpy


class Stream:
    """A numpy stream of uniform and normal draws, in call order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def bern(self, p, shape):
        p = np.asarray(p, np.float64)
        return self.rng.random(tuple(shape) if shape is not None else p.shape) < p

    def norm(self, shape):
        return self.rng.standard_normal(tuple(shape)).astype(np.float32)


@pytest.fixture
def shared(monkeypatch):
    """``arm()`` replaces both packages' draws with one stream each, seeded
    alike, and returns the two streams.  Arm after building the networks:
    the reference's weight init draws through ``jax.random.normal`` too."""
    def arm():
        port, ref = Stream(123), Stream(123)
        monkeypatch.setattr(tR, "bernoulli", lambda gen, p, shape: torch.from_numpy(
            port.bern(p.detach().numpy() if isinstance(p, torch.Tensor) else p, shape)))
        monkeypatch.setattr(tR, "normal", lambda gen, shape: torch.from_numpy(port.norm(shape)))
        monkeypatch.setattr(jR.jax.random, "bernoulli", lambda key, p=0.5, shape=None:
                            jnp.asarray(ref.bern(np.asarray(p), shape)))
        monkeypatch.setattr(jR.jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                            jnp.asarray(ref.norm(shape), dtype))
        return port, ref
    return arm


DROPOUTS = [
    ("float", 0.3, 0.3),
    ("Dropout", tR.Dropout(0.4), jR.Dropout(0.4)),
    ("SpatialDropout", tR.SpatialDropout(0.5), jR.SpatialDropout(0.5)),
    ("AlphaDropout", tR.AlphaDropout(0.2), jR.AlphaDropout(0.2)),
    ("GaussianDropout", tR.GaussianDropout(0.3), jR.GaussianDropout(0.3)),
    ("GaussianNoise", tR.GaussianNoise(0.2), jR.GaussianNoise(0.2)),
]


@pytest.mark.parametrize("name,tcfg,jcfg", DROPOUTS, ids=[d[0] for d in DROPOUTS])
@pytest.mark.parametrize("shape", [(6, 10), (3, 5, 4)], ids=["ff", "rnn"])
def test_dropout_matches_the_reference_under_shared_draws(shared, name, tcfg, jcfg, shape):
    shared()
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    gen = torch.Generator()
    got = tR.apply_dropout(tcfg, gen, torch.from_numpy(x), True)
    want = jR.apply_dropout(jcfg, jax.random.PRNGKey(0), jnp.asarray(x), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # outside training: the input unchanged, no draw
    assert torch.equal(tR.apply_dropout(tcfg, gen, torch.from_numpy(x), False),
                       torch.from_numpy(x))


WEIGHT_NOISE = [
    ("DropConnect", tR.DropConnect(0.7), jR.DropConnect(0.7)),
    ("WeightNoise_add", tR.WeightNoise(0.1), jR.WeightNoise(0.1)),
    ("WeightNoise_mul", tR.WeightNoise(0.1, additive=False, mean=1.0),
     jR.WeightNoise(0.1, additive=False, mean=1.0)),
]


@pytest.mark.parametrize("name,tcfg,jcfg", WEIGHT_NOISE, ids=[w[0] for w in WEIGHT_NOISE])
def test_weight_noise_matches_the_reference_under_shared_draws(shared, name, tcfg, jcfg):
    shared()
    rng = np.random.default_rng(2)
    params = {"W": rng.normal(size=(4, 3)).astype(np.float32),
              "RW": rng.normal(size=(3, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    got = tR.apply_weight_noise(tcfg, torch.Generator(),
                                {k: torch.from_numpy(v) for k, v in params.items()}, True)
    want = jR.apply_weight_noise(jcfg, jax.random.PRNGKey(0),
                                 {k: jnp.asarray(v) for k, v in params.items()}, True)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(got["b"].numpy(), params["b"])   # biases untouched


def _nets(dropout=0.5, noise=True):
    jconf = (JBuilder.builder().seed(9).updater(JNesterovs(lr=0.1, momentum=0.9))
             .layer(jff.Dense(n_out=12, activation="relu", dropout=dropout))
             .layer(jff.Dense(n_out=8, activation="tanh", dropout=jR.GaussianDropout(0.2),
                              weight_noise=jR.DropConnect(0.8) if noise else None))
             .layer(jff.OutputLayer(n_out=3, activation="softmax", loss="mcxent",
                                    dropout=jR.AlphaDropout(0.1)))
             .set_input_type(JInputType.feed_forward(5)).build())
    jnet = JNet(jconf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf.to_dict()), device="cpu")
    net.params = params_from_numpy([jax.tree_util.tree_map(np.asarray, p) for p in jnet.params],
                                   device="cpu")
    net.state = [{} for _ in net.params]
    net.opt_state = net.init_opt_state(net.params)
    return net, jnet


def test_fit_batch_with_dropout_and_weight_noise_matches_the_reference(shared):
    net, jnet = _nets()
    assert isinstance(net.conf.layers[1].weight_noise, tR.DropConnect)
    port, ref = shared()
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(10, 5)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]) for _ in range(3)]
    lt = [float(net.fit_batch(DataSet(x, y))) for x, y in batches]
    with jax.disable_jit():
        lj = [float(jnet.fit_batch(JDataSet(x, y))) for x, y in batches]
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    for p, q in zip(net.params, jnet.params):
        for k in p:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(q[k]), rtol=0, atol=1e-5,
                                       err_msg=k)
    # both consumed the same count of numbers
    assert port.rng.random() == ref.rng.random()


def test_dropout_stream_repeats_from_a_seed_and_inference_ignores_it():
    rng = np.random.default_rng(4)
    ds = DataSet(rng.normal(size=(10, 5)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)])
    runs = []
    for _ in range(2):
        net, _ = _nets()
        runs.append([float(net.fit_batch(ds)) for _ in range(3)])
    assert runs[0] == runs[1]
    net, _ = _nets()
    assert torch.equal(net.output(ds.features), net.output(ds.features))


def test_configs_round_trip_as_the_reference_writes_them():
    for cfg in (tR.Dropout(0.2), tR.SpatialDropout(0.3), tR.AlphaDropout(0.1),
                tR.GaussianDropout(0.4), tR.GaussianNoise(0.05), tR.DropConnect(0.9),
                tR.WeightNoise(0.02, False, 1.0), tR.MaxNormConstraint(1.5),
                tR.MinMaxNormConstraint(0.5, 2.0, 0.7), tR.UnitNormConstraint(),
                tR.NonNegativeConstraint()):
        ref = getattr(jR, type(cfg).__name__)
        d = config_to_dict(cfg)
        from deeplearning4j_tpu.nn.layers.base import config_to_dict as j_to_dict
        assert d == j_to_dict(ref(**{k: v for k, v in d.items() if k != "type"}))
        assert config_from_dict(d) == cfg


CONSTRAINTS = [
    ("MaxNorm", tR.MaxNormConstraint(1.2), jR.MaxNormConstraint(1.2)),
    ("MinMaxNorm", tR.MinMaxNormConstraint(0.8, 1.5, 0.6), jR.MinMaxNormConstraint(0.8, 1.5, 0.6)),
    ("UnitNorm", tR.UnitNormConstraint(), jR.UnitNormConstraint()),
    ("NonNegative", tR.NonNegativeConstraint(), jR.NonNegativeConstraint()),
]


@pytest.mark.parametrize("name,tcfg,jcfg", CONSTRAINTS, ids=[c[0] for c in CONSTRAINTS])
def test_constraint_matches_the_reference(name, tcfg, jcfg):
    rng = np.random.default_rng(5)
    params = {"W": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    got = tR.apply_constraints([tcfg], {k: torch.from_numpy(v) for k, v in params.items()})
    want = jR.apply_constraints([jcfg], {k: jnp.asarray(v) for k, v in params.items()})
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-7,
                                   err_msg=k)


def test_constraints_apply_after_every_update_as_in_the_reference():
    net, jnet = _nets(dropout=0.0, noise=False)
    for layers in (net.conf.layers, jnet.conf.layers):
        for l in layers:
            l.dropout = 0.0
    net.conf.layers[0].constraints = [tR.MaxNormConstraint(0.5)]
    jnet.conf.layers[0].constraints = [jR.MaxNormConstraint(0.5)]
    net.conf.layers[1].constraints = [tR.NonNegativeConstraint()]
    jnet.conf.layers[1].constraints = [jR.NonNegativeConstraint()]
    rng = np.random.default_rng(6)
    for _ in range(3):
        x = rng.normal(size=(10, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
        net.fit_batch(DataSet(x, y))
        jnet.fit_batch(JDataSet(x, y))
    for p, q in zip(net.params, jnet.params):
        for k in p:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(q[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
    norms = torch.sqrt((net.params[0]["W"] ** 2).sum(0))
    assert float(norms.max()) <= 0.5 + 1e-6 and float(net.params[1]["W"].min()) >= 0.0
