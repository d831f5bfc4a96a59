"""The rest of the port's ``MultiLayerNetwork`` against the JAX package on
the CPU: the nan guard, ``fit_batches``, ``num_params`` and ``summary``,
``feed_forward``, ``score_examples``, ``evaluate``, listeners,
``clone_params``, ``fit`` over an iterator, and every (param, compute)
dtype pair the reference accepts.

Both networks start from the same weights (``params_from_numpy``).
Tolerances: float32 1e-6 (losses and parameters over a few steps;
``fit_batches`` against k ``fit_batch`` calls of the port bitwise);
float64 1e-12 in outputs, losses and gradients, and one float32 spacing
(1e-7) in parameters after updates; pairs with a 16-bit dtype 2e-2 (sums
in another order at 8 or 11 bits of mantissa);
``summary`` and ``evaluate().stats()`` equal as strings.

The reference's updaters compute in float32 even for float64 parameters
(``p.astype(float32) - update``): a gradient that differs in its last
float64 bits can round to another float32, so after an update float64
parameters agree to one float32 spacing, not to 1e-12.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JListIterator
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers.recurrent import LSTM as JLSTM
from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.multilayer import DivergenceError as JDivergenceError
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.utils.jax_compat import enable_x64
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import (DivergenceError, MultiLayerConfiguration,
                                                    MultiLayerNetwork)
from deeplearning4j_tpu_torch.optimize import listeners as tl
from deeplearning4j_tpu_torch.utils.params import params_from_numpy


def _jconf(dtype=("float32", "float32"), l2=0.0, updater=None):
    return (JBuilder.builder().seed(8).updater(updater or JAdam(lr=0.02))
            .layer(jff.Dense(n_out=10, activation="tanh", l2=l2))
            .layer(jff.Dense(n_out=7, activation="relu", l1=l2))
            .layer(jff.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(6)).dtype(*dtype).build())


def _pair(dtype=("float32", "float32"), l2=0.0, updater=None):
    jnet = JNet(_jconf(dtype, l2, updater))
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jnet.conf.to_dict()), device="cpu")
    net.params = params_from_numpy([jax.tree_util.tree_map(np.asarray, p) for p in jnet.params],
                                   device="cpu")
    net.state = [{} for _ in net.params]
    net.opt_state = params_from_numpy(
        [jax.tree_util.tree_map(np.asarray, o) for o in jnet.opt_state], device="cpu")
    return net, jnet


def _data(n, seed=0, mb=12, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(mb, 6)).astype(dtype),
             np.eye(4, dtype=dtype)[rng.integers(0, 4, mb)]) for _ in range(n)]


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _close_params(net, jnet, atol):
    for p, q in zip(net.params, jnet.params):
        for k in p:
            np.testing.assert_allclose(_np(p[k]), np.asarray(q[k], np.float64), rtol=0,
                                       atol=atol, err_msg=k)


def _bitwise(a, b):
    return all(sorted(p) == sorted(q) and all(torch.equal(p[k], q[k]) for k in p)
               for p, q in zip(a, b))


# -- the nan guard -------------------------------------------------------------------------


def test_nan_guard_skips_bitwise_spends_its_budget_and_raises(caplog):
    net, jnet = _pair()
    net.set_nan_guard(2)
    jnet.set_nan_guard(2)
    (x, y), = _data(1)
    bad = x.copy()
    bad[3, 2] = np.nan
    for d in (net, jnet):
        d.fit_batch(DataSet(x, y) if d is net else JDataSet(x, y))
    params = net.clone_params()
    opt = [{k: {n: t.clone() for n, t in v.items()} for k, v in o.items()} for o in net.opt_state]
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            assert not np.isfinite(float(net.fit_batch(DataSet(bad, y))))
            jnet.fit_batch(JDataSet(bad, y))
    assert "update skipped (2/2 bad steps)" in caplog.text
    assert _bitwise(params, net.params)
    assert all(torch.equal(a, b) for o1, o2 in zip(opt, net.opt_state) for k in o1
               for a, b in zip(o1[k].values(), o2[k].values()))
    assert net.iteration == jnet.iteration == 3 and net._bad_steps == jnet._bad_steps == 2
    with pytest.raises(DivergenceError, match="non-finite gradient") as e:
        net.fit_batch(DataSet(bad, y))
    with pytest.raises(JDivergenceError):
        jnet.fit_batch(JDataSet(bad, y))
    assert (e.value.bad_steps, e.value.budget) == (3, 2) and net._bad_steps == 0
    # a good step resets the count, and the guarded steps track the reference
    net.fit_batch(DataSet(bad, y))
    jnet.fit_batch(JDataSet(bad, y))
    lt, lj = float(net.fit_batch(DataSet(x, y))), float(jnet.fit_batch(JDataSet(x, y)))
    assert net._bad_steps == jnet._bad_steps == 0 and abs(lt - lj) <= 1e-6
    _close_params(net, jnet, 1e-6)
    with pytest.raises(ValueError, match=">= 1"):
        net.set_nan_guard(0)


def test_nan_guard_refuses_tbptt_as_the_reference_does():
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import NeuralNetConfiguration

    conf = (NeuralNetConfiguration.builder().layer(LSTM(n_out=4))
            .layer(RnnOutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.recurrent(3)).tbptt(2).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    net.set_nan_guard(1)
    with pytest.raises(NotImplementedError, match="TBPTT"):
        net.fit_batch(DataSet(np.zeros((2, 4, 3), np.float32), np.zeros((2, 4, 3), np.float32)))
    net.set_nan_guard(None)
    net.fit_batch(DataSet(np.zeros((2, 4, 3), np.float32), np.zeros((2, 4, 3), np.float32)))


@pytest.mark.parametrize("compression", [None, "bitmap"])
def test_sharded_trainer_nan_guard_skips_the_step_and_keeps_the_residual(compression):
    """One rank (no process group): the trainer arms the network's guard;
    a bad step leaves parameters, updater state and the compressed path's
    residual bitwise as they were, and the budget raises."""
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, build_mesh, build_two_tier_mesh

    net, _ = _pair()
    mesh = build_mesh() if compression is None else build_two_tier_mesh(1)
    trainer = ShardedTrainer(net, mesh, grad_compression=compression, nan_guard=1)
    assert net._nan_guard_budget == 1
    (x, y), = _data(1, seed=11)
    trainer.fit_batch(DataSet(x, y))
    params, resid = net.clone_params(), None if compression is None else trainer._residual.clone()
    bad = x.copy()
    bad[0, 0] = np.inf
    trainer.fit_batch(DataSet(bad, y))
    assert _bitwise(params, net.params) and net._bad_steps == 1
    if compression is not None:
        assert torch.equal(resid, trainer._residual)
    with pytest.raises(DivergenceError):
        trainer.fit_batch(DataSet(bad, y))
    trainer.fit_batch(DataSet(x, y))
    assert not _bitwise(params, net.params) and net._bad_steps == 0
    # the network's listeners fire per step and per epoch, as under fit
    col = tl.CollectScoresIterationListener()
    net.set_listeners(col)
    trainer.fit([DataSet(x, y)] * 2, epochs=2)
    assert [i for i, _ in col.scores] == [net.iteration - 3 + i for i in range(4)]


# -- fit_batches ---------------------------------------------------------------------------


def test_fit_batches_is_bitwise_k_fit_batch_calls_and_the_references_fit_batches():
    (a, jnet), (b, _) = _pair(), _pair()
    data = _data(4, seed=1)
    la = [float(a.fit_batch(DataSet(x, y))) for x, y in data]
    lb = [float(s) for s in b.fit_batches([DataSet(x, y) for x, y in data])]
    assert la == lb and _bitwise(a.params, b.params) and a.iteration == b.iteration == 4
    lj = [float(s) for s in jnet.fit_batches([JDataSet(x, y) for x, y in data])]
    np.testing.assert_allclose(lb, lj, rtol=0, atol=1e-6)
    _close_params(b, jnet, 1e-6)
    assert b.fit_batches([]) == [] and b.fit_graph_count == 0    # no graph on the CPU
    with pytest.raises(ValueError, match="uniform masks"):
        b.fit_batches([DataSet(*data[0], features_mask=np.ones((12,), np.float32)),
                       DataSet(*data[1])])


def test_fit_batches_fires_listeners_and_falls_back_for_model_state_listeners():
    net, _ = _pair()
    col = tl.CollectScoresIterationListener()
    net.set_listeners(col)
    data = [DataSet(x, y) for x, y in _data(3, seed=2)]
    scores = net.fit_batches(data)
    assert [i for i, _ in col.scores] == [1, 2, 3]
    assert [float(s) for _, s in col.scores] == [float(s) for s in scores]

    class Needs(tl.TrainingListener):
        requires_model_state = True

        def __init__(self):
            self.seen = []

        def iteration_done(self, model, iteration, score):
            self.seen.append((iteration, float(model.params[0]["W"].sum())))
    needs = Needs()
    net.add_listener(needs)
    net.fit_batches(data)
    sums = [s for _, s in needs.seen]
    assert [i for i, _ in needs.seen] == [4, 5, 6] and len(set(sums)) == 3


# -- surface ----------------------------------------------------------------------------


def test_num_params_and_summary_equal_the_reference():
    net, jnet = _pair()
    assert net.num_params() == jnet.num_params() == 6 * 10 + 10 + 10 * 7 + 7 + 7 * 4 + 4
    assert net.summary() == jnet.summary()
    with pytest.raises(ValueError, match="init"):
        MultiLayerNetwork(net.conf, device="cpu").summary()


def test_feed_forward_and_score_examples_match_the_reference():
    net, jnet = _pair(l2=0.01)
    (x, y), = _data(1, seed=3)
    acts, jacts = net.feed_forward(x), jnet.feed_forward(x)
    assert len(acts) == len(jacts) == 3
    for a, b in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    for reg in (True, False):
        got = net.score_examples(DataSet(x, y), add_regularization_terms=reg)
        want = jnet.score_examples(JDataSet(x, y), add_regularization_terms=reg)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert abs(float(net.score_examples(DataSet(x, y)).mean()) - net.score(DataSet(x, y))) <= 1e-6
    assert abs(net.score(DataSet(x, y)) - jnet.score(JDataSet(x, y))) <= 1e-6


def test_evaluate_stats_equal_the_reference_as_strings():
    net, jnet = _pair()
    data = _data(3, seed=4)
    ev = net.evaluate(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    jev = jnet.evaluate(JListIterator([JDataSet(x, y) for x, y in data]))
    assert ev.stats() == jev.stats()
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    x = np.concatenate([d[0] for d in data])
    y = np.concatenate([d[1] for d in data])
    assert net.evaluate((x, y)).stats() == jev.stats()


def test_fit_over_an_iterator_fires_iteration_and_epoch_listeners_like_the_reference():
    net, jnet = _pair()
    data = _data(3, seed=5)
    col, jcol = tl.CollectScoresIterationListener(), None
    from deeplearning4j_tpu.optimize.listeners import CollectScoresIterationListener as JCol

    jcol = JCol()

    class Epochs(tl.TrainingListener):
        def __init__(self):
            self.epochs = []

        def epoch_done(self, model, epoch):
            self.epochs.append(epoch)
    ep = Epochs()
    net.set_listeners(col, ep)
    jnet.set_listeners(jcol)
    losses = net.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]), epochs=2)
    jlosses = jnet.fit(JListIterator([JDataSet(x, y) for x, y in data]), epochs=2)
    np.testing.assert_allclose([float(v) for v in losses], [float(v) for v in jlosses],
                               rtol=0, atol=1e-6)
    assert [i for i, _ in col.scores] == [i for i, _ in jcol.scores] == list(range(1, 7))
    assert ep.epochs == [1, 2] and net.epoch == jnet.epoch == 2
    _close_params(net, jnet, 1e-6)


def test_evaluative_and_checkpoint_listeners_see_each_steps_model(tmp_path):
    net, _ = _pair()
    data = [DataSet(x, y) for x, y in _data(4, seed=6)]
    evl = tl.EvaluativeListener(data[0], frequency=2)
    ckpt = tl.CheckpointListener(str(tmp_path), save_every_iterations=2, keep_last=1)
    assert evl.requires_model_state and ckpt.requires_model_state
    net.set_listeners(evl, tl.ComposableListener(ckpt))
    net.fit_batches(data)
    assert [i for i, _ in evl.evaluations] == [2, 4]
    assert [p.rsplit("_", 1)[-1] for p in ckpt.saved] == ["4.zip"]
    back = MultiLayerNetwork.load(ckpt.saved[0], device="cpu")
    assert back.iteration == 4 and _bitwise(back.params, net.params)


def test_clone_params_is_a_copy():
    net, _ = _pair()
    before = net.clone_params()
    assert _bitwise(before, net.params)
    assert all(a is not b for p, q in zip(before, net.params) for a, b in zip(p.values(), q.values()))
    net.fit_batch(DataSet(*_data(1)[0]))
    assert not _bitwise(before, net.params)


# -- dtype pairs ------------------------------------------------------------------------

PAIRS = [(("float64", "float64"), 1e-12), (("float32", "float64"), 1e-6),
         (("float64", "float32"), 1e-6), (("bfloat16", "float32"), 2e-2),
         (("float32", "float16"), 2e-2), (("float16", "float32"), 2e-2),
         (("bfloat16", "bfloat16"), 2e-2), (("float32", "bfloat16"), 2e-2)]


def _grads_close(net, jnet, x, y, tol):
    """The training loss and every gradient, port against reference."""
    loss, grads, _ = net._loss_and_grads(DataSet(x, y))
    jl, jg = jax.value_and_grad(lambda p: jnet._loss(
        p, jnet.state, jnp.asarray(x), jnp.asarray(y), train=True, rng=None)[0])(jnet.params)
    assert abs(float(loss) - float(jl)) <= tol * max(1.0, abs(float(jl)))
    for g, h in zip(grads, jg):
        for k in g:
            np.testing.assert_allclose(_np(g[k]), np.asarray(h[k], np.float64), rtol=0,
                                       atol=tol, err_msg=k)


@pytest.mark.parametrize("dtype,tol", PAIRS, ids=["/".join(p[0]) for p in PAIRS])
def test_every_dtype_pair_matches_the_reference(dtype, tol):
    """Output, loss and gradients at the pair's tolerance; then two SGD
    steps, whose float32 update math (the reference's, for every pair)
    rounds a float64 parameter to float32: parameters within one float32
    spacing (1e-7) where float64 is involved."""
    wide = "float64" in dtype
    with enable_x64(wide):
        net, jnet = _pair(dtype, updater=JSgd(lr=0.05))
        assert str(net.params[0]["W"].dtype) == f"torch.{dtype[0]}"
        data = _data(2, seed=7, dtype=np.float64 if wide else np.float32)
        x = data[0][0]
        np.testing.assert_allclose(_np(net.output(x)), np.asarray(jnet.output(x), np.float64),
                                   rtol=0, atol=tol)
        _grads_close(net, jnet, *data[0], tol)
        for xx, yy in data:
            lt, lj = float(net.fit_batch(DataSet(xx, yy))), float(jnet.fit_batch(JDataSet(xx, yy)))
            assert abs(lt - lj) <= max(tol, 1e-7 if wide else tol) * max(1.0, abs(lj))
        _close_params(net, jnet, max(tol, 1e-7) if wide else tol)
        if dtype == ("float64", "float64"):
            assert all(t.dtype == torch.float64 for p in net.params for t in p.values())


def test_float64_adam_is_within_one_float32_spacing_of_the_reference():
    with enable_x64(True):
        net, jnet = _pair(("float64", "float64"))
        for xx, yy in _data(3, seed=8, dtype=np.float64):
            net.fit_batch(DataSet(xx, yy))
            jnet.fit_batch(JDataSet(xx, yy))
        _close_params(net, jnet, 1e-7)


def test_float64_recurrent_net_matches_the_reference():
    with enable_x64(True):
        jconf = (JBuilder.builder().seed(3).updater(JSgd(lr=0.05))
                 .layer(JLSTM(n_out=5)).layer(JRnnOut(n_out=4, activation="softmax"))
                 .set_input_type(JInputType.recurrent(3)).dtype("float64", "float64").build())
        jnet = JNet(jconf)
        jnet.init()
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf.to_dict()),
                                device="cpu")
        net.params = params_from_numpy([jax.tree_util.tree_map(np.asarray, p)
                                        for p in jnet.params], device="cpu")
        net.state = [{} for _ in net.params]
        net.opt_state = params_from_numpy([jax.tree_util.tree_map(np.asarray, o)
                                           for o in jnet.opt_state], device="cpu")
        rng = np.random.default_rng(9)
        x = rng.normal(size=(2, 6, 3))
        y = np.eye(4)[rng.integers(0, 4, (2, 6))]
        _grads_close(net, jnet, x, y, 1e-12)
        for _ in range(2):
            lt, lj = float(net.fit_batch(DataSet(x, y))), float(jnet.fit_batch(JDataSet(x, y)))
            assert abs(lt - lj) <= 1e-7
        _close_params(net, jnet, 1e-7)


# -- datasets and iterators ---------------------------------------------------------------


def test_dataset_methods_and_iterators_match_the_reference():
    from deeplearning4j_tpu.datasets import iterators as jit_
    from deeplearning4j_tpu_torch.datasets import iterators as tit

    rng = np.random.default_rng(12)
    x, y = rng.normal(size=(10, 3)).astype(np.float32), rng.integers(0, 2, (10, 1))
    m = rng.integers(0, 2, (10,)).astype(np.float32)
    t, j = DataSet(x, y, m), JDataSet(x, y, m)

    def same(a, b):
        for f in ("features", "labels", "features_mask", "labels_mask"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None)
            if va is not None:
                np.testing.assert_array_equal(va, vb)
    same(t.shuffle(4), j.shuffle(4))
    for a, b in zip(t.batch_by(4), j.batch_by(4)):
        same(a, b)
    for a, b in zip(t.split_test_and_train(7), j.split_test_and_train(7)):
        same(a, b)
    same(DataSet.merge(t.batch_by(3)), JDataSet.merge(j.batch_by(3)))
    same(t.get_rows([3, 1]), j.get_rows([3, 1]))
    for a, b in zip(tit.KFoldIterator(t, k=3), jit_.KFoldIterator(j, k=3)):
        same(a, b)
    sampled = [(a, b) for a, b in zip(tit.SamplingDataSetIterator(t, 4, 3, seed=2),
                                       jit_.SamplingDataSetIterator(j, 4, 3, seed=2))]
    assert len(sampled) == 3
    for a, b in sampled:
        same(a, b)
    two = tit.MultipleEpochsIterator(2, tit.ListDataSetIterator(t.batch_by(5)))
    assert len(list(two)) == 4
    assert len(list(tit.EarlyTerminationDataSetIterator(
        tit.ListDataSetIterator(t.batch_by(2)), 2))) == 2
    assert len(list(tit.AsyncDataSetIterator(tit.ListDataSetIterator(t.batch_by(2))))) == 5


def test_performance_and_time_listeners_report():
    net, _ = _pair()
    lines = []
    perf = tl.PerformanceListener(report_every=2, out=lines.append)
    timer = tl.TimeIterationListener(4, out=lines.append)
    net.set_listeners(tl.ComposableListener(perf, timer), tl.ScoreIterationListener(2, lines.append))
    net.fit([DataSet(x, y) for x, y in _data(4, seed=13)])
    assert sum("Score at iteration" in s for s in lines) == 2
    assert any("ETA" in s for s in lines) and len(lines) >= 4
