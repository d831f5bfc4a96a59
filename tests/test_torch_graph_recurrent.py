"""A recurrent ComputationGraph of the port against the JAX package's on
the CPU: an LSTM stack inside a ``GraphBuilder`` graph with two outputs,
one at every step and one through ``LastTimeStepVertex`` →
``DuplicateToTimeSeriesVertex``, trained with TBPTT (a ragged tail chunk
included) on masked sequences, then streamed with ``rnn_time_step``.

On CUDA tensors the LSTM layers run K5a / K5b (the card tests and
``chip_smoke.py`` hold those); here they take the plain per-step loop,
as the reference's tests run its own.

Tolerances: TBPTT losses, parameters, Adam moments 1e-5 after 3
``fit_batch`` calls; outputs and streamed steps 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn import graph as jg
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.datasets import MultiDataSet
from deeplearning4j_tpu_torch.nn import graph as tg
from deeplearning4j_tpu_torch.utils.params import params_from_numpy

F, H, V = 6, 8, 5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _assert_trees(port_tree, ref_tree, atol):
    a, b = _flat(port_tree), _flat(ref_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


def _jconf(tbptt):
    b = (jg.GraphBuilder().seed(5).updater(JAdam(lr=1e-2))
         .add_inputs("x").set_input_types(x=JInputType.recurrent(F))
         .add_layer("lstm1", jrec.LSTM(n_out=H), "x")
         .add_layer("lstm2", jrec.LSTM(n_out=H), "lstm1")
         .add_layer("out", jrec.RnnOutputLayer(n_out=V, activation="softmax",
                                               loss="mcxent"), "lstm2")
         .add_vertex("last", jg.LastTimeStepVertex(), "lstm2")
         .add_vertex("dup", jg.DuplicateToTimeSeriesVertex(), "last", "lstm2")
         .add_layer("out2", jrec.RnnOutputLayer(n_out=V, activation="softmax",
                                                loss="mcxent"), "dup")
         .set_outputs("out", "out2"))
    if tbptt:
        b.tbptt(tbptt)
    return b.build()


def _pair(tbptt=None):
    jnet = jg.ComputationGraph(_jconf(tbptt))
    jnet.init()
    net = tg.ComputationGraph(tg.ComputationGraphConfiguration.from_dict(jnet.conf.to_dict()),
                              device="cpu")
    net.params = params_from_numpy(_np(jnet.params), "cpu")
    net.state = params_from_numpy(_np(jnet.state), "cpu")
    net.opt_state = params_from_numpy(_np(jnet.opt_state), "cpu")
    return jnet, net


def _data(seed, mb=3, T=12, masked=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (mb, T + 1))
    x = np.eye(F, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(V, dtype=np.float32)[ids[:, 1:]]
    m = None
    if masked:
        m = np.ones((mb, T), np.float32)
        m[1, T - 3:] = 0.0
        m[2, 4:] = 0.0
    return x, y, m


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_tbptt_fit_batch_matches_the_reference(masked):
    jnet, net = _pair(tbptt=5)
    for step in range(3):
        x, y, m = _data(40 + step, masked=masked)
        jl = float(jnet.fit_batch(JMultiDataSet([x], [y, y], [m], [m, m])))
        tl = float(net.fit_batch(MultiDataSet([x], [y, y], [m], [m, m])))
        assert abs(tl - jl) < 1e-5, (step, tl, jl)
    assert net.iteration == jnet.iteration == 9
    _assert_trees(net.params, _np(jnet.params), 1e-5)
    _assert_trees(net.opt_state, _np(jnet.opt_state), 1e-5)


def test_masked_outputs_and_the_last_step_vertex_match_the_reference():
    jnet, net = _pair()
    x, _, m = _data(50)
    jouts = jnet.output(x, masks=[m])
    touts = net.output(x, masks=[m])
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)
    # the duplicated last step is each row's last PRESENT step
    acts = net._apply(net.params, net.state, {"x": torch.from_numpy(x)},
                      masks={"x": torch.from_numpy(m)})[0]
    last = acts["last"].numpy()
    np.testing.assert_array_equal(last[2], acts["lstm2"][2, 3].numpy())
    np.testing.assert_array_equal(acts["dup"][2].numpy(), np.repeat(last[2:3], 12, axis=0))


def test_rnn_time_step_streams_the_reference_steps():
    jnet, net = _pair(tbptt=5)
    x, y, _ = _data(60)
    jnet.fit_batch(JMultiDataSet([x], [y, y]))
    net.fit_batch(MultiDataSet([x], [y, y]))
    _assert_trees(net.params, _np(jnet.params), 1e-5)
    jnet.rnn_clear_previous_state()
    net.rnn_clear_previous_state()
    full = net.output(x)[0].numpy()
    for t in range(x.shape[1]):
        jo = jnet.rnn_time_step(x[:, t])
        to = net.rnn_time_step(x[:, t])
        assert to[0].shape == (3, V)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
        np.testing.assert_allclose(to[0].numpy(), full[:, t], rtol=0, atol=1e-5)
    # a chunk streams its steps, and a new batch size starts from zeros
    net.rnn_clear_previous_state()
    chunk = net.rnn_time_step(x[:, :4])[0].numpy()
    np.testing.assert_allclose(chunk, full[:, :4], rtol=0, atol=1e-5)
    one = net.rnn_time_step(x[:1, 0])[0].numpy()
    np.testing.assert_allclose(one, full[:1, 0], rtol=0, atol=1e-5)
