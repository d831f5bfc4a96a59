"""The public names the ported modules lacked against the reference's:
``ops.initializers.WeightInit``, ``ops.dtypes.DTypePolicy`` with
``default_policy`` / ``mixed_policy`` (exported from ``ops``),
``LSTM.step`` / ``zero_carry`` and ``ShardedTrainer.shard_dataset``; the
exports of ``serving``, ``datasets``, ``evaluation`` and the learning
packages (``nlp``, ``graph``, ``clustering``, ``plot``, ``streaming``), and of
``ui``, ``modelimport`` and ``wrappers``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ops as jops
import deeplearning4j_tpu_torch.ops as tops
from deeplearning4j_tpu.nn.layers.recurrent import LSTM as JLSTM
from deeplearning4j_tpu.nn.layers.recurrent import GravesLSTM as JGraves
from deeplearning4j_tpu.ops import dtypes as jdtypes
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM, GravesLSTM
from deeplearning4j_tpu_torch.utils.params import params_from_numpy


def _names(cls):
    return {k: v for k, v in vars(cls).items() if k.isupper()}


def test_weight_init_names_are_the_references():
    assert _names(tops.WeightInit) == _names(jops.WeightInit)
    assert len(_names(tops.WeightInit)) >= 19
    w = tops.init_weight((6, 4), tops.WeightInit.XAVIER, 6, 4,
                         generator=torch.Generator().manual_seed(0))
    assert w.shape == (6, 4)


@pytest.mark.parametrize("policy", ["default_policy", "mixed_policy"])
def test_dtype_policies_are_the_references(policy):
    t, j = getattr(tops, policy)(), getattr(jdtypes, policy)()
    assert isinstance(t, tops.DTypePolicy)
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert str(getattr(t, field)).replace("torch.", "") == jnp.dtype(getattr(j, field)).name
    x = np.linspace(-2, 2, 7).astype(np.float64)
    for cast in ("cast_to_compute", "cast_to_param", "cast_to_output"):
        got = getattr(t, cast)(x)
        want = np.asarray(getattr(j, cast)(x)).astype(np.float32)
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert tops.DTypePolicy() == tops.default_policy()


@pytest.mark.parametrize("cls,jcls,ids", [(LSTM, JLSTM, False), (LSTM, JLSTM, True),
                                          (GravesLSTM, JGraves, False)])
def test_lstm_step_and_zero_carry_are_the_references(cls, jcls, ids):
    """Five streamed steps from the zero carry: every h and c within 1e-6
    of the reference's ``step``."""
    n_in, n, mb = 5, 6, 3
    jl, tl = jcls(n_in=n_in, n_out=n), cls(n_in=n_in, n_out=n)
    jp = jl.init_params(jax.random.PRNGKey(0), None)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jc, tc = jl.zero_carry(mb), tl.zero_carry(mb)
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(jc, tc))
    rng = np.random.default_rng(1)
    for _ in range(5):
        if ids:
            x = rng.integers(0, n_in, mb).astype(np.int32)
            jx, tx = jnp.asarray(x), torch.from_numpy(x)
        else:
            x = rng.normal(size=(mb, n_in)).astype(np.float32)
            jx, tx = jnp.asarray(x), torch.from_numpy(x)
        jh, jc = jl.step(jp, jc, jx)
        th, tc = tl.step(tp, tc, tx)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-6)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_shard_dataset_places_the_global_batch_like_the_references():
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
    from deeplearning4j_tpu.nn.layers import Dense as JDense
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.parallel import ShardedTrainer as JTrainer
    from deeplearning4j_tpu.parallel.mesh import build_mesh as j_build_mesh
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerConfiguration,
                                                        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, build_mesh

    conf = (JConf.builder().seed(1).layer(JDense(n_out=8, activation="tanh"))
            .layer(JOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())
    jnet = JNet(conf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf.to_dict()), device="cpu")
    net.init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    jt = JTrainer(jnet, j_build_mesh({"data": 1}, jax.devices()[:1]))
    tt = ShardedTrainer(net, build_mesh({"data": 1}))
    jd = jt.shard_dataset(JDataSet(x, y))
    td = tt.shard_dataset(DataSet(x, y))
    assert isinstance(td.features, torch.Tensor) and td.features.device == net.device
    np.testing.assert_array_equal(td.features.numpy(), np.asarray(jd.features))
    np.testing.assert_array_equal(td.labels.numpy(), np.asarray(jd.labels))
    assert td.features_mask is None and jd.features_mask is None
    loss = float(tt.fit_batch(td))
    assert np.isfinite(loss)
    tt.dp_size = 3                       # a batch of 8 rows over 3 ranks
    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        tt.shard_dataset(DataSet(x, y))


def test_serving_all_is_the_references():
    import deeplearning4j_tpu.serving as jserving
    import deeplearning4j_tpu_torch.serving as tserving

    assert sorted(tserving.__all__) == sorted(jserving.__all__)
    assert all(hasattr(tserving, n) for n in tserving.__all__)


@pytest.mark.parametrize("pkg", ["datasets", "evaluation"])
def test_datasets_and_evaluation_export_the_references_names(pkg):
    import importlib
    import types

    j = importlib.import_module(f"deeplearning4j_tpu.{pkg}")
    t = importlib.import_module(f"deeplearning4j_tpu_torch.{pkg}")
    names = {n for n, v in vars(j).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert names and names <= set(t.__all__)
    assert all(hasattr(t, n) for n in t.__all__)


@pytest.mark.parametrize("pkg", ["nlp", "graph", "clustering", "plot", "streaming"])
def test_learning_libraries_export_the_references_names(pkg):
    """The five learning packages export exactly the reference's public
    names, each present."""
    import importlib
    import types

    j = importlib.import_module(f"deeplearning4j_tpu.{pkg}")
    t = importlib.import_module(f"deeplearning4j_tpu_torch.{pkg}")
    names = {n for n, v in vars(j).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert names and set(t.__all__) == names
    assert all(hasattr(t, n) for n in t.__all__)


@pytest.mark.parametrize("pkg", ["ui", "modelimport", "wrappers"])
def test_ui_modelimport_and_wrappers_export_the_references_names(pkg):
    """``ui``, ``modelimport`` and ``wrappers`` export the reference's
    public names, each present (``wrappers`` has no ``__all__``: its public
    classes and functions)."""
    import importlib
    import types

    j = importlib.import_module(f"deeplearning4j_tpu.{pkg}")
    t = importlib.import_module(f"deeplearning4j_tpu_torch.{pkg}")

    def public(m):
        if hasattr(m, "__all__"):
            return set(m.__all__)
        return {n for n, v in vars(m).items() if not n.startswith("_")
                and not isinstance(v, types.ModuleType)
                and getattr(v, "__module__", None) == m.__name__}
    names = public(j)
    assert names and public(t) == names
    assert all(hasattr(t, n) for n in names)
