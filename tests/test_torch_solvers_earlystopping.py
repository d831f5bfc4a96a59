"""The port's solvers (``optimize/solvers.py``), early stopping
(``earlystopping/``) and pretrained-weight cache (``models/pretrained.py``)
against the JAX package's on the CPU.

Tolerances: ``minimize``'s per-iteration losses within 1e-6 of the
reference's on its quadratic case; on Rosenbrock the first 4 within 1e-5
and the reference's gate on both packages' results; ``fit_solver`` on the
Iris MLP (L-BFGS and CG, 20 iterations): the first 10 losses within
1e-5, and every one within 1e-5 plus twice the distance by which the
reference's own path moves when its inputs move by one float32 spacing
(these solvers amplify rounding, the reference's as much as the port's);
the early-stopping trainer's epoch scores within 1e-5 and its best
epoch, termination reason and details equal, with the restored model's
output bitwise the best epoch's; the pretrained cache's checksums equal
to the reference's, and a zip the JAX package wrote restored with
``output()`` within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.models import pretrained as jpt
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu_torch import earlystopping as tes
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import load_iris
from deeplearning4j_tpu_torch.models import pretrained as tpt
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import solvers as tsolvers
from deeplearning4j_tpu_torch.utils.params import params_from_numpy


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _quadratic(p):
    return (p["x"] - 3.0) ** 2 + 10.0 * (p["y"] + 1.0) ** 2


def _rosenbrock(p):
    x, y = p["x"], p["y"]
    return (1 - x) ** 2 + 100 * (y - x * x) ** 2


def _both(fn, x0, method, iters):
    got = tsolvers.minimize(fn, {k: torch.tensor(v) for k, v in x0.items()},
                            method=method, max_iterations=iters)
    want = jsolvers.minimize(fn, {k: jnp.asarray(v) for k, v in x0.items()},
                             method=method, max_iterations=iters)
    return got, want


@pytest.mark.parametrize("method", ["lbfgs", "cg", "line_gd"])
def test_minimize_quadratic_matches_the_reference(method):
    got, want = _both(_quadratic, {"x": 0.0, "y": 0.0}, method, 200)
    assert got.iterations == want.iterations and got.converged == want.converged
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-6)
    assert got.loss < 1e-6
    np.testing.assert_allclose([float(got.params["x"]), float(got.params["y"])],
                               [3.0, -1.0], atol=1e-3)
    assert got.params["x"].dtype == torch.float32


def _within_the_references_own_wobble(got, want, wobble, atol):
    """Per iteration |port − reference| <= atol + 2·|reference − reference
    on inputs moved by one float32 spacing|: where the reference's own
    path is stable under rounding the port must match it to ``atol``;
    where one float32 spacing of input moves the reference's path, the
    port may differ by twice that."""
    n = min(len(got), len(want), len(wobble))
    got, want, wobble = (np.asarray(v[:n], np.float64) for v in (got, want, wobble))
    bound = atol + 2 * np.abs(want - wobble)
    assert np.all(np.abs(got - want) <= bound), (np.abs(got - want), bound)


def test_minimize_ill_conditioned_matches_the_reference():
    """Rosenbrock in float32 is chaotic under rounding (the two packages'
    first losses already differ by one float32 spacing, and the paths part
    after 4 iterations), so the per-iteration check covers those 4, and
    both packages must pass the reference's gate: L-BFGS ends at least 10x
    below line gradient descent."""
    x0 = {"x": -1.2, "y": 1.0}
    lb, jlb = _both(_rosenbrock, x0, "lbfgs", 150)
    gd, jgd = _both(_rosenbrock, x0, "line_gd", 150)
    for got, want in ((lb, jlb), (gd, jgd)):
        np.testing.assert_allclose(got.losses[:4], want.losses[:4], rtol=0, atol=1e-5)
    assert lb.loss < gd.loss * 0.1 or lb.loss < 1e-8
    assert jlb.loss < jgd.loss * 0.1 or jlb.loss < 1e-8


def test_unknown_method_and_line_search():
    with pytest.raises(ValueError, match="lbfgs"):
        tsolvers.minimize(_quadratic, {"x": torch.tensor(0.0), "y": torch.tensor(0.0)},
                          method="newton")
    x = torch.tensor([0.0, 0.0])
    f = lambda v: (v[0] - 3.0) ** 2 + 10.0 * (v[1] + 1.0) ** 2  # noqa: E731
    g = torch.tensor([-6.0, 20.0])
    # an ascent direction is refused; a descent one passes Armijo
    assert tsolvers.backtrack_line_search(f, x, 19.0, g, g) == (0.0, 19.0)
    step, fnew = tsolvers.backtrack_line_search(f, x, 19.0, g, -g)
    jstep, jfnew = jsolvers.backtrack_line_search(lambda v: f(v), jnp.zeros(2), 19.0,
                                                  jnp.asarray([-6.0, 20.0]),
                                                  jnp.asarray([6.0, -20.0]))
    assert step == jstep and abs(fnew - jfnew) < 1e-5 and fnew < 19.0


def _iris_pair():
    conf = (JBuilder.builder().seed(7).updater(JSgd(lr=0.1))
            .layer(jff.Dense(n_out=16, activation="tanh"))
            .layer(jff.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())
    jnet = JNet(conf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf.to_dict()), device="cpu")
    net.params = params_from_numpy(_np_tree(jnet.params), device="cpu")
    net.state = [{}, {}]
    net.opt_state = net.init_opt_state(net.params)
    xs, ys = load_iris()
    x = (xs - xs.mean(0)) / xs.std(0)
    return net, jnet, x.astype(np.float32), np.eye(3, dtype=np.float32)[ys]


@pytest.mark.parametrize("method", ["lbfgs", "cg"])
def test_fit_solver_on_the_iris_mlp_matches_the_reference(method):
    """20 iterations.  The first agree within 1e-5; later ones separate by
    as much as the reference's own path does when its inputs move by one
    float32 spacing (L-BFGS's curvature pairs and CG's β amplify rounding:
    measured up to 1.0e-3 and 4.2e-5 in the loss), so the gate is
    ``_within_the_references_own_wobble`` at 1e-5."""
    net, jnet, x, y = _iris_pair()
    _, jnet2, _, _ = _iris_pair()
    got = tsolvers.fit_solver(net, DataSet(x, y), method=method, max_iterations=20)
    want = jsolvers.fit_solver(jnet, JDataSet(x, y), method=method, max_iterations=20)
    wobble = jsolvers.fit_solver(jnet2, JDataSet(np.nextafter(x, np.float32(np.inf)), y),
                                 method=method, max_iterations=20)
    assert len(got.losses) == len(want.losses) == 21
    _within_the_references_own_wobble(got.losses, want.losses, wobble.losses, 1e-5)
    np.testing.assert_allclose(got.losses[:10], want.losses[:10], rtol=0, atol=1e-5)
    assert all(b <= a for a, b in zip(got.losses, got.losses[1:]))
    assert abs(net.score(DataSet(x, y)) - got.loss) < 1e-5


def _es_config(m, saver, val):
    return m.EarlyStoppingConfiguration(
        score_calculator=m.DataSetLossCalculator(val),
        epoch_terminations=[m.MaxEpochsTerminationCondition(12),
                            m.ScoreImprovementEpochTerminationCondition(1)],
        iteration_terminations=[m.InvalidScoreIterationTerminationCondition()],
        model_saver=saver)


@pytest.mark.parametrize("saver", ["in_memory", "local_file"])
def test_early_stopping_matches_the_reference(saver, tmp_path):
    net, jnet, x, y = _iris_pair()
    rng = np.random.default_rng(0)
    order = rng.permutation(150)
    train, val = order[:100], order[100:]
    # a rate that overshoots: the validation loss turns up, so patience ends it
    net.conf.updater.lr = jnet.conf.updater.lr = 3.0
    batches = [DataSet(x[train[i:i + 25]], y[train[i:i + 25]]) for i in range(0, 100, 25)]
    jbatches = JList([JDataSet(b.features, b.labels) for b in batches])
    if saver == "in_memory":
        s, js = tes.InMemoryModelSaver(), jes.InMemoryModelSaver()
    else:
        s, js = (tes.LocalFileModelSaver(str(tmp_path / "port")),
                 jes.LocalFileModelSaver(str(tmp_path / "jax")))
    res = tes.EarlyStoppingTrainer(_es_config(tes, s, DataSet(x[val], y[val])), net,
                                   batches).fit()
    jres = jes.EarlyStoppingTrainer(_es_config(jes, js, JDataSet(x[val], y[val])), jnet,
                                    jbatches).fit()
    np.testing.assert_allclose(res.score_vs_epoch, jres.score_vs_epoch, rtol=0, atol=1e-5)
    assert (res.best_model_epoch, res.termination_reason, res.termination_details,
            res.total_epochs) == (jres.best_model_epoch, jres.termination_reason,
                                  jres.termination_details, jres.total_epochs)
    assert res.termination_details == "ScoreImprovementEpochTerminationCondition"
    assert res.total_epochs > res.best_model_epoch
    # the restored model is the best epoch's: its validation score again
    assert abs(tes.DataSetLossCalculator(DataSet(x[val], y[val])).calculate_score(net)
               - res.best_model_score) < 1e-6
    if saver == "local_file":
        best = MultiLayerNetwork.load(s.best_path, device="cpu")
        assert torch.equal(best.output(x), net.output(x))


def test_iteration_termination_stops_mid_epoch():
    net, _, x, y = _iris_pair()
    net.conf.updater.lr = 1e9
    cfg = tes.EarlyStoppingConfiguration(
        score_calculator=tes.DataSetLossCalculator(DataSet(x, y)),
        epoch_terminations=[tes.MaxEpochsTerminationCondition(5)],
        iteration_terminations=[tes.MaxScoreIterationTerminationCondition(50.0)])
    res = tes.EarlyStoppingTrainer(cfg, net, [DataSet(x, y)] * 4).fit()
    assert res.termination_reason == "IterationTermination"
    assert "MaxScoreIterationTerminationCondition" in res.termination_details
    assert tes.BestScoreEpochTerminationCondition(0.5, minimize=False).terminate(1, 0.7, 0.7)


# -- the pretrained cache ----------------------------------------------------------------


@pytest.fixture
def jax_zip(tmp_path):
    """A checkpoint the JAX package wrote, and its network."""
    _, jnet, _, _ = _iris_pair()
    path = str(tmp_path / "jax_model.zip")
    jnet.save(path)
    return path, jnet


def test_checksum_matches_the_reference(jax_zip):
    path, _ = jax_zip
    assert tpt.checksum(path) == jpt.checksum(path)
    assert tpt.cached_path("m", "iris", "/c") == jpt.cached_path("m", "iris", "/c")


def test_cache_restore_and_eviction(jax_zip, tmp_path):
    path, jnet = jax_zip
    cache = str(tmp_path / "cache")
    dst = tpt.install_weights("mine", path, tpt.PretrainedType.IRIS, cache_dir=cache)
    assert dst == jpt.cached_path("mine", "iris", cache) and os.path.exists(dst)
    net = tpt.init_pretrained("mine", "iris", expected_checksum=tpt.checksum(path),
                              cache_dir=cache, device="cpu")
    _, _, x, _ = _iris_pair()
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=1e-6)
    # a corrupt cached copy fails its checksum and is evicted
    with open(dst, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(IOError, match="cached copy evicted"):
        tpt.init_pretrained("mine", "iris", expected_checksum=tpt.checksum(path),
                            cache_dir=cache, device="cpu")
    assert not os.path.exists(dst)
    with pytest.raises(FileNotFoundError, match="local_file"):
        tpt.init_pretrained("mine", "iris", local_file=str(tmp_path / "typo.zip"),
                            device="cpu")
    with pytest.raises(FileNotFoundError, match="iris_mlp"):
        tpt.init_pretrained("nope", "imagenet", cache_dir=cache, device="cpu")


def test_builtin_iris_weights_load_and_are_checksum_enforced(tmp_path, monkeypatch):
    net = tpt.init_pretrained("iris_mlp", tpt.PretrainedType.IRIS, cache_dir=str(tmp_path),
                              device="cpu")
    xs, ys = load_iris()
    assert net.evaluate(DataSet(xs, np.eye(3, dtype=np.float32)[ys])).accuracy() > 0.97
    with pytest.raises(IOError, match="checksum mismatch"):
        tpt.init_pretrained("iris_mlp", "iris", expected_checksum=999,
                            cache_dir=str(tmp_path), device="cpu")
    monkeypatch.setitem(tpt.BUILTIN_WEIGHTS, ("iris_mlp", "iris"), ("iris_mlp_iris.zip", 1))
    with pytest.raises(IOError, match="corrupt"):
        tpt.init_pretrained("iris_mlp", "iris", cache_dir=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tpt.init_pretrained_int8("iris_mlp", "iris")
