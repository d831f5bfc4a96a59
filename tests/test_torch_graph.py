"""The port's ComputationGraph against the JAX package's on the CPU: every
vertex's forward, ``output_type`` and ``output_mask``; the configuration
JSON round trip; ``output``, ``score``, ``score_examples``, ``evaluate``
and training of a two-input, two-output graph; ``summary``; pretraining;
and checkpoints both ways (the reference's golden graph zip loads in the
port, and a zip the port writes loads in the reference).

Weights, BatchNorm state and updater state go from the reference to the
port with ``params_from_numpy`` (trees keyed by vertex name).

Tolerances: vertices 1e-6 (the same ops); the golden zip's output 1e-6;
outputs, scores and 3 training steps (losses, every parameter and Adam
moment, BatchNorm's running statistics) 1e-5; checkpoints written by one
package and read by the other: bitwise parameters and outputs 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn import graph as jg
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.utils.serializer import load_model as j_load
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import graph as tg
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.optimize.listeners import CollectScoresIterationListener
from deeplearning4j_tpu_torch.utils.params import params_from_numpy
from deeplearning4j_tpu_torch.utils.serializer import load_model, save_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
CNN, RNN, FF = JInputType.convolutional, JInputType.recurrent, JInputType.feed_forward


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def _assert_trees(port_tree, ref_tree, atol):
    a, b = _flat(port_tree), _flat(ref_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# -- vertices ----------------------------------------------------------------------

R = np.random.default_rng(0)
A4 = R.normal(size=(2, 3, 4, 5)).astype(np.float32)
B4 = R.normal(size=(2, 3, 4, 2)).astype(np.float32)
A3 = R.normal(size=(2, 5, 3)).astype(np.float32)
B3 = R.normal(size=(2, 5, 4)).astype(np.float32)
A2 = R.normal(size=(4, 6)).astype(np.float32)
B2 = R.normal(size=(4, 6)).astype(np.float32)
C2 = R.normal(size=(4, 6)).astype(np.float32)
M5 = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)

# (id, vertex name, kwargs, inputs, input types, masks)
VERTEX_CASES = [
    ("merge_cnn", "MergeVertex", {}, [A4, B4], [CNN(3, 4, 5), CNN(3, 4, 2)], None),
    ("merge_rnn_masked", "MergeVertex", {}, [A3, B3], [RNN(3, 5), RNN(4, 5)], [None, M5]),
    ("merge_ff", "MergeVertex", {}, [A2, B2], [FF(6), FF(6)], None),
    ("elementwise_add", "ElementWiseVertex", dict(op="add"), [A2, B2, C2], [FF(6)] * 3, None),
    ("elementwise_subtract", "ElementWiseVertex", dict(op="subtract"), [A2, B2], [FF(6)] * 2,
     None),
    ("elementwise_product", "ElementWiseVertex", dict(op="product"), [A2, B2, C2],
     [FF(6)] * 3, None),
    ("elementwise_average", "ElementWiseVertex", dict(op="average"), [A2, B2, C2],
     [FF(6)] * 3, None),
    ("elementwise_max_masked", "ElementWiseVertex", dict(op="max"), [A3, A3 * 0.5],
     [RNN(3, 5)] * 2, [M5, None]),
    ("subset_ff", "SubsetVertex", dict(from_idx=1, to_idx=3), [A2], [FF(6)], None),
    ("subset_rnn", "SubsetVertex", dict(from_idx=0, to_idx=1), [A3], [RNN(3, 5)], None),
    ("subset_cnn", "SubsetVertex", dict(from_idx=2, to_idx=4), [A4], [CNN(3, 4, 5)], None),
    ("stack", "StackVertex", {}, [A2, B2], [FF(6)] * 2, None),
    ("unstack", "UnstackVertex", dict(index=1, stack_size=2), [A2], [FF(6)], None),
    ("reshape_cnn", "ReshapeVertex", dict(shape=[2, 3, 1]), [A2], [FF(6)], None),
    ("reshape_rnn", "ReshapeVertex", dict(shape=[3, 2]), [A2], [FF(6)], None),
    ("reshape_ff", "ReshapeVertex", dict(shape=[60]), [A4], [CNN(3, 4, 5)], None),
    ("scale", "ScaleVertex", dict(factor=2.5), [A2], [FF(6)], None),
    ("shift", "ShiftVertex", dict(shift=-0.75), [A3], [RNN(3, 5)], [M5]),
    ("l2normalize_cnn", "L2NormalizeVertex", {}, [A4], [CNN(3, 4, 5)], None),
    ("l2", "L2Vertex", {}, [A4, A4[::-1].copy()], [CNN(3, 4, 5)] * 2, None),
    ("preprocessor", "PreprocessorVertex", dict(preprocessor="CnnToFeedForward"), [A4],
     [CNN(3, 4, 5)], None),
    ("poolhelper", "PoolHelperVertex", {}, [A4], [CNN(3, 4, 5)], None),
    ("last_time_step", "LastTimeStepVertex", {}, [A3], [RNN(3, 5)], None),
    ("last_time_step_masked", "LastTimeStepVertex", {}, [A3], [RNN(3, 5)], [M5]),
    ("duplicate_to_time_series", "DuplicateToTimeSeriesVertex", {}, [A2[:2], B3],
     [FF(6), RNN(4, 5)], [None, M5]),
]


def _vertices(name, kw):
    if name == "PreprocessorVertex":
        return (jg.PreprocessorVertex(preprocessor=jpre.CnnToFeedForward()),
                tg.PreprocessorVertex(preprocessor=tpre.CnnToFeedForward()))
    return getattr(jg, name)(**kw), getattr(tg, name)(**kw)


@pytest.mark.parametrize("case", VERTEX_CASES, ids=[c[0] for c in VERTEX_CASES])
def test_vertex_forward_type_and_mask_match_the_reference(case):
    _, name, kw, xs, types, masks = case
    jv, tv = _vertices(name, kw)
    masks = masks or [None] * len(xs)
    jy = jv.forward([jnp.asarray(x) for x in xs], [None if m is None else jnp.asarray(m)
                                                   for m in masks])
    ty = tv.forward([_t(x) for x in xs], [_t(m) for m in masks])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    ttypes = [InputType.from_dict(t.to_dict()) for t in types]
    assert tv.output_type(ttypes).to_dict() == jv.output_type(types).to_dict()
    jm = jv.output_mask([None if m is None else jnp.asarray(m) for m in masks])
    tm = tv.output_mask([_t(m) for m in masks])
    assert (jm is None) == (tm is None)
    if tm is not None:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


# -- a two-input, two-output graph ----------------------------------------------------


def _jconf(variant="plain"):
    """The two-input, two-output graph; ``variant`` "normalized" adds
    per-layer L2 clipping, a layer with its own updater and a max-norm
    constraint."""
    from deeplearning4j_tpu.nn.conf.regularizers import MaxNormConstraint
    from deeplearning4j_tpu.nn.updaters import Sgd as JSgd

    b = _jbuilder()
    if variant == "normalized":
        b.gradient_normalization("clip_l2_per_layer", 0.5)
        vs = {v.name: v.vertex for v in b._conf.vertices}
        vs["db"].layer.updater = JSgd(lr=0.05)
        vs["da"].layer.constraints = [MaxNormConstraint(max_norm=0.8)]
    return b.build()


def _jbuilder():
    return (jg.GraphBuilder().seed(3).updater(JAdam(lr=1e-2))
            .add_inputs("a", "b")
            .set_input_types(a=FF(5), b=FF(6))
            .add_layer("da", jff.Dense(n_out=8, activation="tanh", l2=1e-3), "a")
            .add_layer("db", jff.Dense(n_out=8, activation="relu"), "b")
            .add_vertex("m", jg.MergeVertex(), "da", "db")
            .add_layer("bn", jnorm.BatchNormalization(), "m")
            .add_vertex("sub", jg.SubsetVertex(from_idx=0, to_idx=7), "bn")
            .add_vertex("sum", jg.ElementWiseVertex(op="add"), "sub", "da")
            .add_layer("out", jff.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "sum")
            .add_layer("reg", jff.OutputLayer(n_out=2, activation="identity", loss="mse"),
                       "bn")
            .set_outputs("out", "reg"))


def _pair(variant="plain"):
    jnet = jg.ComputationGraph(_jconf(variant))
    jnet.init()
    net = tg.ComputationGraph(tg.ComputationGraphConfiguration.from_dict(
        jnet.conf.to_dict()), device="cpu")
    net.params = params_from_numpy(_np(jnet.params), "cpu")
    net.state = params_from_numpy(_np(jnet.state), "cpu")
    net.opt_state = params_from_numpy(_np(jnet.opt_state), "cpu")
    return jnet, net


def _data(seed=1, n=8):
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(n, 5)).astype(np.float32)
    xb = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    r = rng.normal(size=(n, 2)).astype(np.float32)
    return xa, xb, y, r


def test_configuration_json_round_trips_unchanged():
    d = _jconf().to_dict()
    conf = tg.ComputationGraphConfiguration.from_dict(json.loads(json.dumps(d)))
    assert conf.to_dict() == d
    assert jg.ComputationGraphConfiguration.from_dict(conf.to_dict()).to_dict() == d


def test_an_unported_vertex_layer_is_named():
    # every layer type of the reference is ported since MoE (it loads);
    # a type the port does not know is still named in the error
    d = _jconf().to_dict()
    d["vertices"][0]["vertex"]["layer"]["type"] = "MoE"
    d["vertices"][0]["vertex"]["layer"].update(n_in=5, d_ff=8, n_experts=2)
    assert type(tg.ComputationGraphConfiguration.from_dict(d).vertices[0].vertex.layer
                ).__name__ == "MoE"
    d["vertices"][0]["vertex"]["layer"]["type"] = "CapsuleLayer"
    with pytest.raises(ValueError, match="CapsuleLayer.*not ported"):
        tg.ComputationGraphConfiguration.from_dict(d)


def test_structure_matches_the_reference():
    jnet, net = _pair()
    assert net.topo_order == jnet.topo_order
    assert {k: v.to_dict() for k, v in net.vertex_out_types.items()} == {
        k: v.to_dict() for k, v in jnet.vertex_out_types.items()}
    assert net.num_params() == jnet.num_params()
    assert net.summary() == jnet.summary()
    with pytest.raises(ValueError, match="cycle"):
        tg.ComputationGraph(tg.GraphBuilder().add_inputs("x").set_input_types(
            x=InputType.feed_forward(2))
            .add_vertex("p", tg.ScaleVertex(), "q").add_vertex("q", tg.ScaleVertex(), "p")
            .build(), device="cpu")


def test_output_score_score_examples_and_evaluate_match_the_reference():
    jnet, net = _pair()
    xa, xb, y, r = _data()
    jouts = jnet.output(xa, xb)
    touts = net.output(xa, xb)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)
    jmds, mds = JMultiDataSet([xa, xb], [y, r]), MultiDataSet([xa, xb], [y, r])
    assert abs(net.score(mds) - jnet.score(jmds)) < 1e-5
    for reg in (True, False):
        np.testing.assert_allclose(net.score_examples(mds, reg).numpy(),
                                   jnet.score_examples(jmds, reg), rtol=0, atol=1e-5)
    assert net.evaluate(mds).stats() == jnet.evaluate(jmds).stats()


@pytest.mark.parametrize("variant", ["plain", "normalized"])
def test_three_fit_batch_steps_of_a_two_input_graph_match_the_reference(variant):
    jnet, net = _pair(variant)
    lst = CollectScoresIterationListener(1)
    net.set_listeners(lst)
    for step in range(3):
        xa, xb, y, r = _data(seed=10 + step)
        jl = float(jnet.fit_batch(JMultiDataSet([xa, xb], [y, r])))
        tl = float(net.fit_batch(MultiDataSet([xa, xb], [y, r])))
        assert abs(tl - jl) < 1e-5
    assert net.iteration == jnet.iteration == 3 and len(lst.scores) == 3
    _assert_trees(net.params, _np(jnet.params), 1e-5)
    _assert_trees(net.opt_state, _np(jnet.opt_state), 1e-5)
    _assert_trees(net.state, _np(jnet.state), 1e-5)


def test_fit_batches_and_fit_match_fit_batch_on_the_cpu():
    _, a = _pair()
    _, b = _pair()
    batches = [MultiDataSet(list(d[:2]), list(d[2:])) for d in (_data(20), _data(21))]
    la = [float(a.fit_batch(m)) for m in batches]
    lb = [float(s) for s in b.fit_batches(batches)]
    assert la == lb and a.iteration == b.iteration == 2
    _assert_trees(a.params, b.params, 0)
    _assert_trees(a.state, b.state, 0)
    _, c = _pair()
    lc = c.fit(batches, epochs=1)
    assert [float(s) for s in lc] == la and c.epoch == 1


def test_single_input_graph_takes_a_dataset():
    b = (tg.GraphBuilder().seed(1).add_inputs("x").set_input_types(x=InputType.feed_forward(4))
         .add_layer("h", tff_dense(5), "x")
         .add_layer("out", tff_output(3), "h").set_outputs("out"))
    net = tg.ComputationGraph(b.build(), device="cpu")
    net.init()
    x = np.random.default_rng(2).normal(size=(6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]]
    losses = [float(net.fit_batch(DataSet(x, y))) for _ in range(20)]
    assert losses[-1] < losses[0]
    assert net.evaluate((x, y)).accuracy() >= 0.5


def tff_dense(n):
    from deeplearning4j_tpu_torch.nn.layers import Dense
    return Dense(n_out=n, activation="tanh")


def tff_output(n):
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    return OutputLayer(n_out=n, activation="softmax", loss="mcxent")


def test_pretrain_layer_of_an_autoencoder_vertex_runs_the_reference_objective():
    from deeplearning4j_tpu.nn.layers.feedforward import AutoEncoder as JAE
    conf = (jg.GraphBuilder().seed(4).updater(JAdam(lr=1e-2)).add_inputs("x")
            .set_input_types(x=FF(6))
            .add_layer("ae", JAE(n_out=3, activation="sigmoid", corruption_level=0.0), "x")
            .add_layer("out", jff.OutputLayer(n_out=2, activation="softmax"), "ae")
            .set_outputs("out").build())
    jnet = jg.ComputationGraph(conf)
    jnet.init()
    net = tg.ComputationGraph(tg.ComputationGraphConfiguration.from_dict(conf.to_dict()),
                              device="cpu")
    net.params = params_from_numpy(_np(jnet.params), "cpu")
    net.state = params_from_numpy(_np(jnet.state), "cpu")
    net.opt_state = params_from_numpy(_np(jnet.opt_state), "cpu")
    assert net.pretrainable_layers() == jnet.pretrainable_layers() == ["ae"]
    x = np.random.default_rng(5).random(size=(8, 6)).astype(np.float32)
    jl = jnet.pretrain(JMultiDataSet([x], [None]), epochs=3)["ae"]
    tl = net.pretrain(MultiDataSet([x], [None]), epochs=3)["ae"]
    np.testing.assert_allclose([float(v) for v in tl], [float(v) for v in jl], rtol=0,
                               atol=1e-5)
    _assert_trees(net.params, _np(jnet.params), 1e-5)


# -- checkpoints -------------------------------------------------------------------


def test_golden_graph_zip_loads_and_reproduces_the_pinned_output():
    net = load_model(os.path.join(FIX, "cg_golden.zip"), device="cpu")
    assert isinstance(net, tg.ComputationGraph) and net.iteration == 3
    xa = np.random.default_rng(77).normal(size=(4, 5)).astype(np.float32)
    xb = np.random.default_rng(78).normal(size=(4, 6)).astype(np.float32)
    want = np.load(os.path.join(FIX, "cg_golden_output.npy"))
    np.testing.assert_allclose(net.output(xa, xb)[0].numpy(), want, rtol=0, atol=1e-6)
    assert float(torch.abs(net.opt_state["da"]["m"]["W"]).max()) > 0


def test_graph_zips_load_across_packages_both_ways(tmp_path):
    jnet, net = _pair()
    xa, xb, y, r = _data(30)
    jnet.fit_batch(JMultiDataSet([xa, xb], [y, r]))
    jpath, tpath = str(tmp_path / "ref.zip"), str(tmp_path / "port.zip")
    jnet.save(jpath)
    loaded = tg.ComputationGraph.load(jpath, device="cpu")
    _assert_trees(loaded.params, _np(jnet.params), 0)
    _assert_trees(loaded.state, _np(jnet.state), 0)
    _assert_trees(loaded.opt_state, _np(jnet.opt_state), 0)
    assert loaded.iteration == 1
    loaded.fit_batch(MultiDataSet([xa, xb], [y, r]))
    save_model(loaded, tpath)
    back = j_load(tpath)
    assert type(back).__name__ == "ComputationGraph" and back.iteration == 2
    _assert_trees(loaded.params, _np(back.params), 0)
    _assert_trees(loaded.opt_state, _np(back.opt_state), 0)
    _assert_trees(loaded.state, _np(back.state), 0)
    for t, j in zip(loaded.output(xa, xb), back.output(xa, xb)):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)


# -- serving -----------------------------------------------------------------------


def test_a_one_input_graph_is_served_eagerly_through_its_output():
    """The predict Engine serves a ComputationGraph the reference's way:
    its per-example shape from its one InputType, each batch through its
    ``output`` (bitwise), no captured program, no unwarmed serve."""
    from deeplearning4j_tpu_torch.serving import Engine

    b = (tg.GraphBuilder().seed(2).add_inputs("in")
         .set_input_types(**{"in": InputType.convolutional(6, 6, 2)})
         .add_layer("c", tconv2d(), "in")
         .add_layer("gap", tgap(), "c")
         .add_layer("out", tff_output(3), "gap").set_outputs("out"))
    net = tg.ComputationGraph(b.build(), device="cpu")
    net.init()
    eng = Engine(net, max_batch=4, replicas=1, device="cpu").load()
    try:
        x = np.random.default_rng(3).normal(size=(3, 6, 6, 2)).astype(np.float32)
        got = eng.output(x)
        pad = np.concatenate([x, np.zeros((1, 6, 6, 2), np.float32)])
        np.testing.assert_array_equal(got, net.output(pad)[0].numpy()[:3])
        assert eng.compile_cache_size() is None
        assert eng.metrics_snapshot()["counters"].get("unwarmed_serves", 0) == 0
    finally:
        eng.shutdown()


def tconv2d():
    from deeplearning4j_tpu_torch.nn.layers import Convolution2D
    return Convolution2D(n_out=4, kernel=(3, 3), convolution_mode="same", activation="relu")


def tgap():
    from deeplearning4j_tpu_torch.nn.layers import GlobalPooling
    return GlobalPooling(pooling="max")
