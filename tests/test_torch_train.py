"""The port's training path against the JAX package's: losses, updaters,
schedules, gradient normalization, the fused Adam step (K4's plain
version), ``fit_batch`` on a small TransformerLM, and the optimizer state
in the checkpoint zip both ways.

Inputs come from numpy seeds and go to both packages.  Tolerances, f32:
  - losses and their gradients: atol = rtol = 1e-5 (sums in another
    order);
  - one updater application: atol = rtol = 1e-6 (the same elementwise
    math; only XLA:CPU's optional FMA contraction of ``a*x + b*y`` differs);
  - the LM trajectory: losses atol 1e-5; params atol 3e-5, a tenth of one
    Adam step (lr 3e-4): Adam divides each gradient by its running RMS,
    so where a gradient is near zero the f32 reordering gap of the
    backward moves the step by a visible share of lr.
Within the port, the fused step's plain version over the flat buffers is
bitwise the per-leaf ``Adam.apply``.
"""

import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.ops import update_kernel as juk
from deeplearning4j_tpu.utils.serializer import load_model as j_load
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.textgen_lstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.nn.layers.base import config_from_dict
from deeplearning4j_tpu_torch.nn import updaters as tupd
from deeplearning4j_tpu_torch.ops import losses as tlosses
from deeplearning4j_tpu_torch.ops import update_kernel as tuk
from deeplearning4j_tpu_torch.optimize.score import LazyScore
from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.utils.serializer import load_model, save_model

SIZE = dict(vocab_size=64, n_layers=2, d_model=64, n_heads=4, max_len=32)
LR = 3e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """numpy leaves of a port tree in the JAX flatten order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [params_to_numpy(tree)]


def _assert_trees_close(port_tree, jax_tree, **tol):
    got, want = _leaves(port_tree), jax.tree_util.tree_leaves(_np(jax_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


# -- losses -------------------------------------------------------------------------------

# each loss with an activation and labels in its domain
_LOSS_CASES = {
    "mse": ("identity", "normal"), "l2": ("identity", "normal"),
    "l1": ("identity", "normal"), "mae": ("tanh", "normal"),
    "xent": ("sigmoid", "binary"), "mcxent": ("softmax", "onehot"),
    "negativeloglikelihood": ("softmax", "onehot"), "hinge": ("identity", "binary"),
    "squared_hinge": ("identity", "binary"), "kl_divergence": ("softmax", "dist"),
    "poisson": ("sigmoid", "counts"), "cosine_proximity": ("identity", "normal"),
    "mape": ("identity", "normal"), "msle": ("sigmoid", "dist"),
}


def _labels(kind, shape, rng):
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "binary":
        return (rng.random(shape) > 0.5).astype(np.float32)
    if kind == "counts":
        return rng.integers(0, 4, shape).astype(np.float32)
    if kind == "dist":
        e = np.exp(rng.standard_normal(shape))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return np.eye(shape[-1], dtype=np.float32)[rng.integers(0, shape[-1], shape[:-1])]


def _masks(shape, rng):
    mb, t, c = shape
    per_example = (rng.random((mb, t)) > 0.3).astype(np.float32)
    return {"none": None, "per_example": per_example,
            "labels_shape": (rng.random(shape) > 0.3).astype(np.float32),
            "broadcast": np.array([[1.0], [0.0], [1.0]], np.float32)}


def _loss_both(name, act, labels, pre, mask):
    """(port value, port d/dpre) and (JAX value, JAX d/dpre)."""
    jl = jlosses.get_loss(name)
    jm = None if mask is None else jnp.asarray(mask)
    jlab = jnp.asarray(labels)
    jv, jg = jax.value_and_grad(lambda p: jl(jlab, p, act, jm))(jnp.asarray(pre))
    pt = torch.from_numpy(pre).requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask)
    tv = tlosses.get_loss(name)(torch.from_numpy(labels), pt, act, tm)
    tv.backward()
    return (float(tv.detach()), pt.grad.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("mask_kind", ["none", "per_example", "labels_shape", "broadcast"])
@pytest.mark.parametrize("name", sorted(_LOSS_CASES))
def test_loss_matches_jax(name, mask_kind):
    assert sorted(tlosses.loss_names()) == sorted(jlosses.loss_names())
    rng = np.random.default_rng(len(name))
    shape = (3, 4, 5)
    act, kind = _LOSS_CASES[name]
    pre = rng.standard_normal(shape).astype(np.float32)
    mask = _masks(shape, rng)[mask_kind]
    (tv, tg), (jv, jg) = _loss_both(name, act, _labels(kind, shape, rng), pre, mask)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, atol=1e-5, rtol=1e-5)


# with class-id labels [mb, t] the labels' shape is the per-example shape
@pytest.mark.parametrize("mask_kind", ["none", "per_example", "broadcast"])
@pytest.mark.parametrize("name", ["mcxent", "negativeloglikelihood", "mse"])
def test_sparse_labels_match_jax(name, mask_kind):
    rng = np.random.default_rng(9)
    shape = (3, 4, 5)
    act = _LOSS_CASES[name][0]
    pre = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(0, 5, shape[:2]).astype(np.int32)
    mask = _masks(shape, rng)[mask_kind]
    (tv, tg), (jv, jg) = _loss_both(name, act, ids, pre, mask)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, atol=1e-5, rtol=1e-5)
    # the gather the port takes for softmax + NLL equals its one-hot product
    onehot = np.eye(5, dtype=np.float32)[ids]
    (ov, og), _ = _loss_both(name, act, onehot, pre, mask)
    np.testing.assert_allclose(tv, ov, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tg, og, atol=1e-6, rtol=1e-6)


def test_summed_per_example_matches_jax():
    rng = np.random.default_rng(10)
    pre = rng.standard_normal((3, 4, 5)).astype(np.float32)
    ids = rng.integers(0, 5, (3, 4)).astype(np.int32)
    want = np.asarray(jlosses.summed_per_example("mcxent", jnp.asarray(ids),
                                                 jnp.asarray(pre), "softmax"))
    got = tlosses.summed_per_example("mcxent", torch.from_numpy(ids),
                                     torch.from_numpy(pre), "softmax")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# -- updaters, schedules, gradient normalization -----------------------------------------


def _tree(rng):
    return {"W": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}


_SCHEDULES = [
    ("Schedule", dict(lr=0.01)),
    ("ExponentialSchedule", dict(lr=0.01, decay=0.9)),
    ("InverseSchedule", dict(lr=0.01, decay=0.1, power=0.75)),
    ("PolySchedule", dict(lr=0.01, power=2.0, max_iter=10)),
    ("SigmoidSchedule", dict(lr=0.01, decay=0.5, steps=3)),
    ("StepSchedule", dict(lr=0.01, decay=0.5, steps=2)),
]


@pytest.mark.parametrize("name,kw", _SCHEDULES, ids=[s[0] for s in _SCHEDULES])
def test_schedules_match_jax(name, kw):
    js, ts = getattr(jupd, name)(**kw), getattr(tupd, name)(**kw)
    for it in (0, 1, 2, 5, 9, 14):
        want = np.asarray(js(jnp.asarray(it, jnp.int32)))
        got = ts(torch.tensor(float(it)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=0, rtol=1e-6)


_UPDATERS = [
    ("Sgd", dict(lr=0.1)), ("Nesterovs", dict(lr=0.1, momentum=0.9)),
    ("Adam", dict(lr=0.01)), ("Adam", dict(lr=0.01, moment_dtype="bfloat16")),
    ("AdaMax", dict(lr=0.01)), ("Nadam", dict(lr=0.01)), ("AMSGrad", dict(lr=0.01)),
    ("AdaGrad", dict(lr=0.1)), ("AdaDelta", dict()), ("RmsProp", dict(lr=0.01)),
    ("NoOp", dict()),
]


@pytest.mark.parametrize("name,kw", _UPDATERS,
                         ids=[n + ("_bf16" if kw.get("moment_dtype") else "")
                              for n, kw in _UPDATERS])
def test_updaters_match_jax(name, kw):
    rng = np.random.default_rng(20)
    params = _tree(rng)
    ju, tu = getattr(jupd, name)(**kw), getattr(tupd, name)(**kw)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), params_from_numpy(params, "cpu")
    js, ts = ju.init_state(jp), tu.init_state(tp)
    for it in range(3):
        g = _tree(rng)
        jp, js = ju.apply(jp, jax.tree_util.tree_map(jnp.asarray, g), js,
                          jnp.asarray(it, jnp.int32))
        tp, ts = tu.apply(tp, params_from_numpy(g, "cpu"), ts, torch.tensor(float(it)))
        _assert_trees_close(tp, jp, atol=1e-6, rtol=1e-6)
        _assert_trees_close(ts, js, atol=1e-6, rtol=1e-6)


def test_updater_with_a_schedule_matches_jax():
    rng = np.random.default_rng(21)
    params, g = _tree(rng), _tree(rng)
    ju = jupd.Adam(lr=jupd.StepSchedule(lr=0.05, decay=0.5, steps=1))
    tu = tupd.Adam(lr=tupd.StepSchedule(lr=0.05, decay=0.5, steps=1))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, _ = ju.apply(jp, jax.tree_util.tree_map(jnp.asarray, g), ju.init_state(jp),
                       jnp.asarray(3, jnp.int32))
    tp = params_from_numpy(params, "cpu")
    got, _ = tu.apply(tp, params_from_numpy(g, "cpu"), tu.init_state(tp),
                      torch.tensor(3.0))
    _assert_trees_close(got, want, atol=1e-6, rtol=1e-6)


_MODES = ["none", "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
          "clip_elementwise_absolute_value", "clip_l2_per_layer", "clip_l2_per_param_type"]


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["under", "over"])
@pytest.mark.parametrize("mode", _MODES)
def test_gradient_normalization_matches_jax(mode, scale):
    g = {k: v * np.float32(scale) for k, v in _tree(np.random.default_rng(22)).items()}
    want = jupd.normalize_gradients(jax.tree_util.tree_map(jnp.asarray, g), mode, 1.0)
    got = tupd.normalize_gradients(params_from_numpy(g, "cpu"), mode, 1.0)
    _assert_trees_close(got, want, atol=1e-6, rtol=1e-6)


# -- the fused step (K4's plain version) ---------------------------------------------------


@pytest.mark.parametrize("kind", ["adam", "nadam"])
def test_fused_update_plain_matches_jax_update_math(kind):
    rng = np.random.default_rng(30)
    p, g, m = (rng.standard_normal(1000).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(1000)).astype(np.float32)
    sc = np.array([3e-4, 1 - 0.9 ** 2, 1 - 0.999 ** 2], np.float32)
    want = juk._update_math(kind, *(jnp.asarray(a) for a in (p, g, m, v)),
                            jnp.asarray(sc[0]), jnp.asarray(sc[1]), jnp.asarray(sc[2]),
                            0.9, 0.999, 1e-8)
    got = tuk.fused_update(kind, *(torch.from_numpy(a) for a in (p, g, m, v)),
                           torch.from_numpy(sc), 0.9, 0.999, 1e-8)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("cls", ["Adam", "Nadam"])
def test_fused_apply_is_bitwise_the_per_leaf_path(monkeypatch, cls, moment_dtype):
    rng = np.random.default_rng(31)
    u = getattr(tupd, cls)(lr=0.01, moment_dtype=moment_dtype)
    params = params_from_numpy(_tree(rng), "cpu")
    state = u.init_state(params)
    for it in range(3):
        g = params_from_numpy(_tree(rng), "cpu")
        monkeypatch.setenv(tuk.ENV_SWITCH, "0")
        p_leaf, s_leaf = u.apply(params, g, state, torch.tensor(float(it)))
        monkeypatch.setenv(tuk.ENV_SWITCH, "1")
        before = tuk.fused_update_cuda.launches
        fused = tuk.fused_apply(tuk.kind_of(u), u, params, g, state, torch.tensor(float(it)))
        assert fused is not None and tuk.fused_update_cuda.launches == before
        p_fused, s_fused = u.apply(params, g, state, torch.tensor(float(it)))
        for a, b in zip(_leaves([p_fused, s_fused, fused]), _leaves([p_leaf, s_leaf, fused])):
            np.testing.assert_array_equal(a, b)
        params, state = p_fused, s_fused


def test_fused_apply_routes_only_exact_adam_and_nadam(monkeypatch):
    monkeypatch.setenv(tuk.ENV_SWITCH, "1")
    assert tuk.kind_of(tupd.Adam()) == "adam" and tuk.kind_of(tupd.Nadam()) == "nadam"
    assert tuk.kind_of(tupd.AMSGrad()) is None and tuk.kind_of(tupd.AdaMax()) is None
    p = {"W": torch.ones(2, 2, dtype=torch.float64)}
    u = tupd.Adam()
    assert tuk.fused_apply("adam", u, p, p, u.init_state(p), torch.tensor(0.0)) is None
    monkeypatch.setenv(tuk.ENV_SWITCH, "0")
    p32 = {"W": torch.ones(2, 2)}
    assert tuk.fused_apply("adam", u, p32, p32, u.init_state(p32), torch.tensor(0.0)) is None


# -- fit_batch on a small LM ----------------------------------------------------------------


def _batches(n, b=4, t=32, seed=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(0, SIZE["vocab_size"], (b, t + 1)).astype(np.int32)
        out.append((x[:, :-1], x[:, 1:]))
    return out


def _pair(seed=3):
    """A JAX LM and the port's, from the same weights and updater state."""
    jn = JLM(**SIZE, seed=seed)
    net = TransformerLM(**SIZE, device="cpu")
    net.params = params_from_numpy(_np(jn.params), device="cpu")
    net.opt_state = params_from_numpy(_np(jn.opt_state), device="cpu")
    return jn, net


@pytest.mark.parametrize("fused", ["0", "1"], ids=["per_leaf", "fused"])
def test_fit_batch_trajectory_matches_jax(monkeypatch, fused):
    monkeypatch.setenv(tuk.ENV_SWITCH, fused)
    jn, net = _pair()
    for i, (x, y) in enumerate(_batches(4)):
        lj = jn.fit_batch(JDataSet(x, y))
        lt = net.fit_batch(DataSet(x, y))
        assert isinstance(lt, LazyScore) and not lt.materialized
        np.testing.assert_allclose(float(lt), float(lj), atol=1e-5, rtol=0)
        assert net.iteration == jn.iteration == i + 1
    _assert_trees_close(net.params, jn.params, atol=0.1 * LR, rtol=0)
    _assert_trees_close(net.opt_state, jn.opt_state, atol=1e-6, rtol=1e-3)


def test_fit_and_score_match_jax():
    jn, net = _pair(seed=4)
    data = _batches(3, seed=41)
    jl = jn.fit(ListDataSetIterator([JDataSet(x, y) for x, y in data]), epochs=2)
    tl = net.fit([DataSet(x, y) for x, y in data], epochs=2)
    assert len(tl) == 6 and all(s.materialized for s in tl)
    np.testing.assert_allclose([float(s) for s in tl], [float(s) for s in jl],
                               atol=1e-5, rtol=0)
    assert net.epoch == jn.epoch == 2 and net.iteration == jn.iteration == 6
    x, y = _batches(1, seed=42)[0]
    np.testing.assert_allclose(net.score(DataSet(x, y)), jn.score(JDataSet(x, y)),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="iterate again"):
        net.fit(iter([DataSet(x, y)]), epochs=2)


def test_l2_regularization_enters_the_loss_as_in_jax():
    from deeplearning4j_tpu.models.transformer import TransformerBlock as JBlock
    from deeplearning4j_tpu_torch.models.transformer import TransformerBlock

    rng = np.random.default_rng(43)
    p = {"Wq": rng.standard_normal((4, 4)).astype(np.float32),
         "b1": rng.standard_normal((4,)).astype(np.float32)}
    want = JBlock(l1=0.01, l2=0.1).regularization_score(
        jax.tree_util.tree_map(jnp.asarray, p))
    got = TransformerBlock(l1=0.01, l2=0.1).regularization_score(params_from_numpy(p, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(TransformerBlock().regularization_score(params_from_numpy(p, "cpu"))) == 0.0


def test_training_refuses_what_is_not_ported():
    """Dropout and weight noise train now (drawn from the network's
    generator; tests/test_torch_regularizers.py holds them to the
    reference); inference ignores them.  The nan guard under TBPTT is
    still refused, as in the reference."""
    net = TransformerLM(**SIZE, device="cpu")
    x, y = _batches(1)[0]
    before = net.output(x).clone()
    net.conf.layers[2].dropout = 0.1
    net.conf.layers[3].weight_noise = config_from_dict({"type": "WeightNoise", "stddev": 0.1})
    torch.testing.assert_close(net.output(x), before, rtol=0, atol=0)
    assert np.isfinite(float(net.fit_batch(DataSet(x, y))))
    rnn = TextGenerationLSTM(vocab_size=8, hidden=4, tbptt_length=2, device="cpu")
    rnn.set_nan_guard(2)
    with pytest.raises(NotImplementedError, match="TBPTT"):
        rnn.fit_batch(DataSet(np.zeros((2, 4), np.int64), np.zeros((2, 4), np.int64)))


# -- optimizer state in the checkpoint ------------------------------------------------------


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jn = JLM(**SIZE, seed=5)
    data = _batches(3, seed=44)
    for x, y in data[:2]:
        jn.fit_batch(JDataSet(x, y))
    path = str(tmp_path / "jax_trained.zip")
    j_save(jn, path)
    net = load_model(path, device="cpu")
    assert net.iteration == jn.iteration == 2
    _assert_trees_close(net.opt_state, jn.opt_state, atol=0, rtol=0)
    x, y = data[2]
    np.testing.assert_allclose(float(net.fit_batch(DataSet(x, y))),
                               float(jn.fit_batch(JDataSet(x, y))), atol=1e-5, rtol=0)
    _assert_trees_close(net.params, jn.params, atol=0.1 * LR, rtol=0)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    jn, net = _pair(seed=6)
    data = _batches(3, seed=45)
    for x, y in data[:2]:
        net.fit_batch(DataSet(x, y))
    path = str(tmp_path / "port_trained.zip")
    save_model(net, path)
    back = j_load(path)
    assert back.iteration == 2
    _assert_trees_close(net.opt_state, back.opt_state, atol=0, rtol=0)
    with zipfile.ZipFile(path) as z:
        names = np.load(io.BytesIO(z.read("updater.npz"))).files
    assert "2/m/Wq" in names and "1/v/P" in names
    assert all(len(n.split("/")) == 3 and n.split("/")[1] in ("m", "v") for n in names)
    x, y = data[2]
    np.testing.assert_allclose(float(back.fit_batch(JDataSet(x, y))),
                               float(net.fit_batch(DataSet(x, y))), atol=1e-5, rtol=0)


def test_load_without_updater_starts_fresh_state(tmp_path):
    jn = JLM(**SIZE, seed=7)
    x, y = _batches(1, seed=46)[0]
    jn.fit_batch(JDataSet(x, y))
    path = str(tmp_path / "j.zip")
    j_save(jn, path)
    net = load_model(path, load_updater=False, device="cpu")
    assert all(not t.any() for t in _leaves_t(net.opt_state))
    out = str(tmp_path / "no_updater.zip")
    save_model(net, out, save_updater=False)
    with zipfile.ZipFile(out) as z:
        assert "updater.npz" not in z.namelist()


def _leaves_t(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_t(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_t(v)]
    return [tree]
