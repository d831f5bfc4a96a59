"""The port's recurrent path against the JAX package's: the activation
registry, the six recurrent layers' forward (dense and integer-id inputs,
masks, carry in and out, the four ``Bidirectional`` modes) and single
steps,
the configuration JSON, TBPTT ``fit_batch`` trajectories,
``rnn_time_step``, ``TextGenerationLSTM`` checkpoints both ways and the
CLI's recurrent ``generate``.

Parameters and optimizer state come from the JAX package and go to the
port; inputs come from numpy seeds.  Tolerances, f32: activations 1e-6
(the same elementwise math); layer outputs, TBPTT losses and parameters,
and streamed distributions 1e-5 (sums in another order).
"""

import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.textgen_lstm import TextGenerationLSTM as JTextGen
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import recurrent as jr
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.utils.serializer import load_model as j_load
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch import cli as tcli
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import TextGenerationLSTM
from deeplearning4j_tpu_torch.nn.layers import recurrent as tr
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerConfiguration,
                                                    MultiLayerNetwork)
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import lstm_kernel as tk
from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.utils.serializer import load_model, save_model

TOL = dict(atol=1e-5, rtol=0)


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


# -- activations ------------------------------------------------------------------------------

X = np.random.default_rng(3).standard_normal((4, 7, 33), dtype=np.float32) * 3


@pytest.mark.parametrize("name", jact.activation_names() + ["leakyrelu(0.3)", "elu(0.5)"])
def test_every_activation_matches_jax(name):
    assert tact.activation_names() == jact.activation_names()
    want = np.asarray(jact.get_activation(name)(jnp.asarray(X)))
    got = tact.get_activation(name)(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_bad_parametric_activation_raises():
    with pytest.raises(ValueError, match="leakyrelu"):
        tact.get_activation("leakyrelu(x)")


# -- layers -----------------------------------------------------------------------------------

N_IN, N_OUT, MB, T = 5, 6, 3, 7


def _layers(name, **kw):
    """(JAX layer, port layer) of one class built from the same fields."""
    return getattr(jr, name)(**kw), getattr(tr, name)(**kw)


def _wrapped(name, inner, **kw):
    ji, ti = _layers(inner, n_in=N_IN, n_out=N_OUT)
    return getattr(jr, name)(layer=ji, **kw), getattr(tr, name)(layer=ti, **kw)


def _forward_both(jl, tl, x, mask=None, carry=None, seed=0, **fkw):
    p = _np(jl.init_params(jax.random.PRNGKey(seed), JInputType.recurrent(N_IN)))
    jkw = dict(fkw, mask=None if mask is None else jnp.asarray(mask))
    tkw = dict(fkw, mask=None if mask is None else torch.from_numpy(mask))
    if carry is not None:
        jkw["carry"] = jax.tree_util.tree_map(jnp.asarray, carry)
        tkw["carry"] = jax.tree_util.tree_map(torch.from_numpy, carry)
    jo = jl.forward(jax.tree_util.tree_map(jnp.asarray, p), {}, jnp.asarray(x), **jkw)
    to = tl.forward(params_from_numpy(p, "cpu"), {}, torch.from_numpy(x), **tkw)
    np.testing.assert_allclose(to.y.numpy(), np.asarray(jo.y), **TOL)
    return jo, to


def _data(seed, ids=False):
    rng = np.random.default_rng(seed)
    if ids:
        x = rng.integers(0, N_IN, (MB, T)).astype(np.int32)
    else:
        x = rng.standard_normal((MB, T, N_IN)).astype(np.float32)
    mask = (rng.random((MB, T)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    carry = tuple(rng.standard_normal((MB, N_OUT)).astype(np.float32) for _ in range(2))
    return x, mask, carry


@pytest.mark.parametrize("case", ["dense", "masked", "ids", "ids_masked", "carry",
                                  "hardsigmoid_gates"])
@pytest.mark.parametrize("cls", ["LSTM", "GravesLSTM"])
def test_lstm_forward_matches_jax(cls, case):
    kw = dict(gate_activation="hardsigmoid") if case == "hardsigmoid_gates" else {}
    jl, tl = _layers(cls, n_in=N_IN, n_out=N_OUT, **kw)
    x, mask, carry = _data(1, ids=case.startswith("ids"))
    jo, to = _forward_both(jl, tl, x, mask if "masked" in case else None,
                           carry if case == "carry" else None)
    assert to.y.dtype == torch.float32
    for a, b in zip(to.carry, jo.carry):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_graves_bidirectional_lstm_matches_jax(masked):
    jl, tl = _layers("GravesBidirectionalLSTM", n_in=N_IN, n_out=N_OUT)
    x, mask, _ = _data(2)
    _, to = _forward_both(jl, tl, x, mask if masked else None)
    assert to.carry is None and not tl.recurrent


@pytest.mark.parametrize("case", ["plain", "masked", "carry"])
def test_simple_rnn_matches_jax(case):
    jl, tl = _layers("SimpleRnn", n_in=N_IN, n_out=N_OUT)
    x, mask, carry = _data(3)
    jo, to = _forward_both(jl, tl, x, mask if case == "masked" else None,
                           carry[0] if case == "carry" else None)
    np.testing.assert_allclose(to.carry.numpy(), np.asarray(jo.carry), **TOL)


@pytest.mark.parametrize("inner", ["LSTM", "SimpleRnn"])
@pytest.mark.parametrize("mode", ["concat", "add", "mul", "average"])
def test_bidirectional_matches_jax(mode, inner):
    jl, tl = _wrapped("Bidirectional", inner, mode=mode)
    x, mask, _ = _data(4)
    _forward_both(jl, tl, x, mask)
    assert tl.output_type(tr.InputType.recurrent(N_IN)).size == (
        2 * N_OUT if mode == "concat" else N_OUT)


@pytest.mark.parametrize("masked", [False, True])
def test_last_time_step_matches_jax(masked):
    jl, tl = _wrapped("LastTimeStep", "LSTM")
    x, mask, _ = _data(5)
    mask[1, 4:] = 0.0                       # a shorter sequence
    _, to = _forward_both(jl, tl, x, mask if masked else None)
    assert tuple(to.y.shape) == (MB, N_OUT)


@pytest.mark.parametrize("ids", [False, True], ids=["dense", "ids"])
def test_lstm_single_steps_match_jax_step(ids):
    # the port streams through forward() on one time step with the carry
    # in and out; the reference has a step() for it
    jl, tl = _layers("LSTM", n_in=N_IN, n_out=N_OUT)
    p = _np(jl.init_params(jax.random.PRNGKey(6), None))
    x, _, carry = _data(6, ids=ids)
    jc = tuple(jnp.asarray(c) for c in carry)
    tc = tuple(torch.from_numpy(c) for c in carry)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, "cpu")
    for t in range(3):
        jh, jc = jl.step(jp, jc, jnp.asarray(x[:, t]))
        out = tl.forward(tp, {}, torch.from_numpy(x[:, t:t + 1]), carry=tc)
        tc = out.carry
        np.testing.assert_allclose(out.y[:, 0].numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tc[1].numpy(), np.asarray(jc[1]), **TOL)


def test_recurrent_configuration_json_round_trips_with_jax():
    conf = (JConf.builder().seed(1).updater(jupd.RmsProp(lr=0.01))
            .layer(jr.LSTM(n_out=4, gate_activation="hardsigmoid"))
            .layer(jr.Bidirectional(layer=jr.GravesLSTM(n_out=4), mode="add"))
            .layer(jr.GravesBidirectionalLSTM(n_out=3))
            .layer(jr.SimpleRnn(n_out=3))
            .layer(jr.RnnOutputLayer(n_out=5, activation="softmax"))
            .tbptt(7).set_input_type(JInputType.recurrent(5)).build())
    d = conf.to_dict()
    port = MultiLayerConfiguration.from_dict(d)
    assert isinstance(port.layers[1].layer, tr.GravesLSTM)
    assert port.backprop_type == "tbptt" and port.tbptt_length == 7
    assert port.to_dict() == d


# -- networks ---------------------------------------------------------------------------------

VOCAB = 11


def _pair(layers, updater, *, tbptt=5, clip=None, n_in=VOCAB, seed=7):
    """A JAX network and the port's, from one configuration, the same
    weights and the same updater state."""
    b = JConf.builder().seed(seed).updater(updater)
    if clip:
        b.gradient_normalization(clip, 1.0)
    for l in layers:
        b.layer(l)
    b.layer(jr.RnnOutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent"))
    b.tbptt(tbptt).set_input_type(JInputType.recurrent(n_in))
    jn = JNet(b.build())
    jn.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jn.conf.to_dict()), device="cpu")
    net.params = params_from_numpy(_np(jn.params), "cpu")
    net.state = params_from_numpy(_np(jn.state), "cpu")
    net.opt_state = params_from_numpy(_np(jn.opt_state), "cpu")
    return jn, net


def _id_batches(n, t, seed, mb=4):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, VOCAB, (mb, t)).astype(np.int32) for _ in range(2))
            for _ in range(n)]


def _sequence_route(zx, RW, b, h0, c0, mask=None, reverse=False):
    """The route CUDA tensors take, ``LSTMSequence`` (K5a forward, K5b
    backward), on CPU tensors, whose kernels' dispatchers run the plain
    versions."""
    hs, h, c = tk.LSTMSequence.apply(zx, RW, b, h0, c0, mask, reverse)
    return hs, (h, c)


# "switch_on" cases send the port's standard cell through LSTMSequence,
# the route CUDA tensors take; the others take the plain per-step loop
# under autograd, the CPU's route.  The JAX side runs its default, the
# plain cell.
_TBPTT_CASES = {
    # name: (layers, updater, clip, T, switch)
    "adam_ids": (lambda: [jr.LSTM(n_out=8), jr.LSTM(n_out=8)], jupd.Adam(lr=1e-2), None, 20, "0"),
    "adam_ids_tail": (lambda: [jr.LSTM(n_out=8), jr.LSTM(n_out=8)], jupd.Adam(lr=1e-2),
                      None, 23, "0"),
    "rmsprop_clip_graves_tail": (lambda: [jr.GravesLSTM(n_out=8), jr.GravesLSTM(n_out=8)],
                                 jupd.RmsProp(lr=1e-3), "clip_elementwise_absolute_value",
                                 23, "0"),
    "rmsprop_clip_switch_on": (lambda: [jr.LSTM(n_out=8), jr.LSTM(n_out=8)],
                               jupd.RmsProp(lr=1e-3), "clip_elementwise_absolute_value",
                               23, "1"),
    "adam_switch_on_n128": (lambda: [jr.LSTM(n_out=128), jr.LSTM(n_out=128)],
                            jupd.Adam(lr=1e-3), None, 20, "1"),
    "simple_rnn": (lambda: [jr.LSTM(n_out=8), jr.SimpleRnn(n_out=8)], jupd.Adam(lr=1e-2),
                   None, 20, "0"),
}


@pytest.mark.parametrize("case", sorted(_TBPTT_CASES))
def test_tbptt_trajectory_matches_jax(monkeypatch, case):
    layers, updater, clip, t_len, switch = _TBPTT_CASES[case]
    if switch == "1":
        monkeypatch.setattr(tr, "lstm_sequence", _sequence_route)
    jn, net = _pair(layers(), updater, clip=clip)
    chunks = -(-t_len // 5)
    for i, (x, y) in enumerate(_id_batches(2, t_len, seed=len(case))):
        lj = jn.fit_batch(JDataSet(x, y))
        lt = net.fit_batch(DataSet(x, y))
        np.testing.assert_allclose(float(lt), float(lj), **TOL)
        assert net.iteration == jn.iteration == (i + 1) * chunks
    _assert_trees_close(net.params, jn.params, **TOL)
    _assert_trees_close(net.opt_state, jn.opt_state, atol=1e-5, rtol=1e-4)


def test_tbptt_with_dense_inputs_and_masks_matches_jax():
    jn, net = _pair([jr.LSTM(n_out=6)], jupd.Adam(lr=1e-2), tbptt=4, n_in=5)
    rng = np.random.default_rng(8)
    for _ in range(2):
        x = rng.standard_normal((3, 10, 5)).astype(np.float32)
        y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (3, 10))]
        m = (rng.random((3, 10)) > 0.2).astype(np.float32)
        lj = jn.fit_batch(JDataSet(x, y, m, m))
        lt = net.fit_batch(DataSet(x, y, m, m))
        np.testing.assert_allclose(float(lt), float(lj), **TOL)
    assert net.iteration == jn.iteration == 6
    _assert_trees_close(net.params, jn.params, **TOL)


def test_tbptt_with_dense_inputs_and_masks_through_the_sequence_function(monkeypatch):
    # the card's route (masked K5a forward, the hold's split in the
    # backward) on the CPU, against the reference's TBPTT
    monkeypatch.setattr(tr, "lstm_sequence", _sequence_route)
    jn, net = _pair([jr.LSTM(n_out=6), jr.LSTM(n_out=5)], jupd.Adam(lr=1e-2), tbptt=4, n_in=5)
    rng = np.random.default_rng(9)
    for _ in range(2):
        x = rng.standard_normal((3, 10, 5)).astype(np.float32)
        y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (3, 10))]
        m = (rng.random((3, 10)) > 0.2).astype(np.float32)
        lj = jn.fit_batch(JDataSet(x, y, m, m))
        lt = net.fit_batch(DataSet(x, y, m, m))
        np.testing.assert_allclose(float(lt), float(lj), **TOL)
    assert net.iteration == jn.iteration == 6
    _assert_trees_close(net.params, jn.params, **TOL)


@pytest.mark.parametrize("case", ["lstm_masked_carry", "bidirectional_concat",
                                  "graves_bidirectional_standard_cell", "last_time_step"])
def test_layers_through_the_sequence_function_match_jax(monkeypatch, case):
    # every layer that reaches the standard cell, reverse included
    # (GravesBidirectionalLSTM with peephole=False walks its second
    # direction backwards), through the card's route on the CPU
    monkeypatch.setattr(tr, "lstm_sequence", _sequence_route)
    x, mask, carry = _data(10, ids=False)
    if case == "lstm_masked_carry":
        jl, tl = _layers("LSTM", n_in=N_IN, n_out=N_OUT)
        jo, to = _forward_both(jl, tl, x, mask, carry)
        for a, b in zip(to.carry, jo.carry):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    elif case == "bidirectional_concat":
        _forward_both(*_wrapped("Bidirectional", "LSTM", mode="concat"), x, mask)
    elif case == "graves_bidirectional_standard_cell":
        jl, tl = _layers("GravesBidirectionalLSTM", n_in=N_IN, n_out=N_OUT, peephole=False)
        _forward_both(jl, tl, x, mask)
    else:
        _forward_both(*_wrapped("LastTimeStep", "LSTM"), x, mask)


def test_tbptt_refuses_inputs_without_a_time_axis():
    _, net = _pair([jr.LSTM(n_out=4)], jupd.Adam())
    with pytest.raises(ValueError, match="TBPTT requires"):
        net.fit_batch(DataSet(np.zeros((2, VOCAB), np.float32), np.zeros((2, 3), np.int32)))


@pytest.mark.parametrize("ids", [True, False], ids=["ids", "dense"])
def test_rnn_time_step_matches_output_and_jax(ids):
    jn, net = _pair([jr.LSTM(n_out=8), jr.GravesLSTM(n_out=8)], jupd.Adam(),
                    n_in=VOCAB)
    rng = np.random.default_rng(9)
    x = (rng.integers(0, VOCAB, (2, 6)).astype(np.int32) if ids
         else rng.standard_normal((2, 6, VOCAB)).astype(np.float32))
    full = net.output(x)
    np.testing.assert_allclose(full.numpy(), np.asarray(jn.output(x)), **TOL)
    net.rnn_clear_previous_state()
    jn.rnn_clear_previous_state()
    first = net.rnn_time_step(x[:, :2])               # a chunk, then single steps
    assert isinstance(first, torch.Tensor) and tuple(first.shape) == (2, 2, VOCAB)
    np.testing.assert_allclose(first.numpy(), full[:, :2].numpy(), **TOL)
    np.testing.assert_allclose(first.numpy(), jn.rnn_time_step(x[:, :2]), **TOL)
    for t in range(2, 6):
        got = net.rnn_time_step(x[:, t])
        assert tuple(got.shape) == (2, VOCAB)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(), **TOL)
        np.testing.assert_allclose(got.numpy(), jn.rnn_time_step(x[:, t]), **TOL)
    # a new batch size starts from zero state; so does a cleared one
    one = net.rnn_time_step(x[:1, 0])
    np.testing.assert_allclose(one.numpy(), full[:1, 0].numpy(), **TOL)
    net.rnn_time_step(x[:1, 1])
    net.rnn_clear_previous_state()
    np.testing.assert_allclose(net.rnn_time_step(x[:1, 0]).numpy(), full[:1, 0].numpy(),
                               **TOL)


# -- checkpoints and the CLI ------------------------------------------------------------------

TG = dict(vocab_size=20, hidden=16, tbptt_length=5)


def test_jax_textgen_checkpoint_resumes_in_the_port(tmp_path):
    jn = JTextGen(**TG)
    data = _id_batches(2, 12, seed=10, mb=3)
    jn.fit_batch(JDataSet(*data[0]))
    path = str(tmp_path / "jax_textgen.zip")
    j_save(jn, path)
    net = load_model(path, device="cpu")
    assert [type(l).__name__ for l in net.conf.layers] == ["GravesLSTM", "GravesLSTM",
                                                            "RnnOutputLayer"]
    assert net.iteration == jn.iteration == 3
    _assert_trees_close(net.params, jn.params, atol=0, rtol=0)
    _assert_trees_close(net.opt_state, jn.opt_state, atol=0, rtol=0)
    np.testing.assert_allclose(float(net.fit_batch(DataSet(*data[1]))),
                               float(jn.fit_batch(JDataSet(*data[1]))), **TOL)
    _assert_trees_close(net.params, jn.params, **TOL)


def test_port_textgen_checkpoint_resumes_in_jax(tmp_path):
    net = TextGenerationLSTM(**TG, device="cpu")
    assert net.conf.backprop_type == "tbptt" and net.conf.tbptt_length == 5
    data = _id_batches(2, 12, seed=11, mb=3)
    net.fit_batch(DataSet(*data[0]))
    path = str(tmp_path / "port_textgen.zip")
    save_model(net, path)
    with zipfile.ZipFile(path) as z:
        names = np.load(io.BytesIO(z.read("updater.npz"))).files
    assert "0/g2/pW" in names and "1/g2/RW" in names and "2/g2/W" in names
    back = j_load(path)
    assert back.iteration == 3
    _assert_trees_close(net.params, back.params, atol=0, rtol=0)
    np.testing.assert_allclose(float(back.fit_batch(JDataSet(*data[1]))),
                               float(net.fit_batch(DataSet(*data[1]))), **TOL)
    _assert_trees_close(net.params, back.params, **TOL)


@pytest.mark.parametrize("layer", ["bidirectional", "graves_bidirectional"])
def test_bidirectional_checkpoints_round_trip_both_ways(tmp_path, layer):
    inner = (jr.Bidirectional(layer=jr.LSTM(n_out=4), mode="concat")
             if layer == "bidirectional" else jr.GravesBidirectionalLSTM(n_out=4))
    jn, net = _pair([inner], jupd.Adam(), tbptt=3)
    x, y = _id_batches(1, 7, seed=12, mb=2)[0]
    net.fit_batch(DataSet(x, y))
    path = str(tmp_path / "port.zip")
    save_model(net, path)
    with zipfile.ZipFile(path) as z:
        names = np.load(io.BytesIO(z.read("params.npz"))).files
    assert ("0/fwd/RW" in names) if layer == "bidirectional" else ("0/pWB" in names)
    back = j_load(path)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(back.output(x)), **TOL)
    j_save(back, str(tmp_path / "jax.zip"))
    again = load_model(str(tmp_path / "jax.zip"), device="cpu")
    _assert_trees_close(again.params, back.params, atol=0, rtol=0)
    _assert_trees_close(again.opt_state, back.opt_state, atol=0, rtol=0)


@pytest.mark.parametrize("sampling", [[], ["--temperature", "0.8", "--top-k", "5", "--seed", "3"]],
                         ids=["greedy", "seeded"])
def test_cli_generate_recurrent_matches_jax_cli(tmp_path, capsys, sampling):
    jn = JTextGen(vocab_size=128, hidden=16, tbptt_length=5)
    path = str(tmp_path / "charrnn.zip")
    j_save(jn, path)
    args = ["generate", "--model", path, "--prompt", "hello", "--max-tokens", "12"] + sampling
    assert jcli.main(args) == 0
    want = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want and len(got.out.strip()) >= len("hello")
    assert "rnn_time_step: 12 tokens" in got.err
