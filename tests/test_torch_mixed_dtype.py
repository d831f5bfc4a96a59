"""Mixed float32-param / bfloat16-compute networks in the port against the
JAX package: every ported layer inside a ``dtype("float32", "bfloat16")``
network, a float-input MLP and an index-input char-RNN, three training
steps, checkpoints both ways, the TransformerLM (whose blocks compute in
float32 under these dtypes, in both packages), and the pairs the port
refuses.

Weights come from the JAX package through ``params_from_numpy``; inputs
from numpy seeds.  Tolerances: a bfloat16 result within ``BF16_TOL`` of
the reference's (2^-6 absolute, two bfloat16 spacings at 1.0: the
packages round the same f32 sums, summed in another order, to bfloat16);
a float32 result within 1e-5; three SGD steps' losses within 2^-6 and
parameters within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.utils.serializer import load_model as j_load
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerConfiguration,
                                                    MultiLayerNetwork,
                                                    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.ops import update_kernel
from deeplearning4j_tpu_torch.ops.dtypes import matmul
from deeplearning4j_tpu_torch.utils.params import params_from_numpy
from deeplearning4j_tpu_torch.utils.serializer import load_model, save_model

MIXED = ("float32", "bfloat16")
BF16_TOL = dict(atol=2.0 ** -6, rtol=0)
F32_TOL = dict(atol=1e-5, rtol=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_of(jnet):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jnet.conf.to_dict()),
                            device="cpu")
    net.params = params_from_numpy(_np(jnet.params), device="cpu")
    net.state = params_from_numpy(_np(jnet.state), device="cpu")
    net.opt_state = params_from_numpy(_np(jnet.opt_state), device="cpu")
    return net


def _jnet(layers, input_type, updater=None, tbptt=None, seed=1):
    b = JConf.builder().seed(seed).updater(updater or JSgd(lr=0.1))
    for l in layers:
        b.layer(l)
    if tbptt:
        b.tbptt(tbptt)
    net = JNet(b.set_input_type(input_type).dtype(*MIXED).build())
    net.init()
    return net


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


RNG = np.random.default_rng(0)
X_FF = RNG.standard_normal((4, 6)).astype(np.float32)
X_SEQ = RNG.standard_normal((3, 7, 6)).astype(np.float32)
IDS = RNG.integers(0, 11, (3, 7)).astype(np.int32)

#: (id, layers, input type, input): one network per ported layer
LAYER_CASES = [
    ("dense", lambda: [JL.Dense(n_out=8, activation="tanh")], JIT.feed_forward(6), X_FF),
    ("output_layer", lambda: [JL.OutputLayer(n_out=5, activation="softmax")],
     JIT.feed_forward(6), X_FF),
    ("loss_layer", lambda: [JL.Dense(n_out=5), JL.LossLayer(activation="softmax")],
     JIT.feed_forward(6), X_FF),
    ("embedding", lambda: [JL.Embedding(n_in=11, n_out=6, activation="tanh")],
     JIT.feed_forward(11), IDS[:, :1]),
    ("embedding_sequence", lambda: [JL.EmbeddingSequence(n_in=11, n_out=6)],
     JIT.recurrent(11, 7), IDS),
    ("lstm_float", lambda: [JL.LSTM(n_out=8)], JIT.recurrent(6), X_SEQ),
    ("lstm_ids", lambda: [JL.LSTM(n_out=8)], JIT.recurrent(11), IDS),
    ("graves_lstm", lambda: [JL.GravesLSTM(n_out=8)], JIT.recurrent(6), X_SEQ),
    ("graves_bidirectional", lambda: [JL.GravesBidirectionalLSTM(n_out=8)],
     JIT.recurrent(6), X_SEQ),
    ("simple_rnn", lambda: [JL.SimpleRnn(n_out=8)], JIT.recurrent(6), X_SEQ),
    ("bidirectional", lambda: [JL.Bidirectional(layer=JL.LSTM(n_out=8), mode="concat")],
     JIT.recurrent(6), X_SEQ),
    ("rnn_output", lambda: [JL.RnnOutputLayer(n_out=5, activation="softmax")],
     JIT.recurrent(6), X_SEQ),
    ("last_time_step", lambda: [JL.LastTimeStep(layer=JL.LSTM(n_out=8))],
     JIT.recurrent(6), X_SEQ),
    ("positional_embedding", lambda: [jtr.PositionalEmbedding(max_len=7, d_model=6)],
     JIT.recurrent(6, 7), X_SEQ),
    ("transformer_block", lambda: [jtr.TransformerBlock(d_model=6, n_heads=2)],
     JIT.recurrent(6, 7), X_SEQ),
]


@pytest.mark.parametrize("layers,input_type,x", [c[1:] for c in LAYER_CASES],
                         ids=[c[0] for c in LAYER_CASES])
def test_every_ported_layer_in_a_mixed_network(layers, input_type, x):
    jnet = _jnet(layers(), input_type)
    net = _port_of(jnet)
    want = jnet.output(x)
    got = net.output(x)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert all(t.dtype == torch.float32 for p in net.params for t in _leaves(p))
    tol = F32_TOL if got.dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **tol)


def test_bfloat16_input_meets_float32_weight_where_the_reference_promotes():
    """A TransformerBlock fed bfloat16 activations multiplies them by its
    float32 weights uncast: JAX promotes to float32, and so does the
    port (``torch.matmul`` alone would raise on the mixed pair)."""
    a = torch.randn(3, 4, dtype=torch.bfloat16)
    w = torch.randn(4, 5)
    with pytest.raises(RuntimeError):
        a @ w
    y = matmul(a, w)
    assert y.dtype == torch.float32
    assert torch.equal(y, a.float() @ w)
    assert torch.equal(matmul(w.T, w), w.T @ w)


def _mlp(updater=None):
    return _jnet([JL.Dense(n_out=16, activation="tanh"),
                  JL.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
                 JIT.feed_forward(4), updater=updater)


def _char_rnn(updater=None):
    return _jnet([JL.LSTM(n_out=8), JL.LSTM(n_out=8),
                  JL.RnnOutputLayer(n_out=11, activation="softmax", loss="mcxent")],
                 JIT.recurrent(11), updater=updater, tbptt=5)


X_IRIS = RNG.standard_normal((8, 4)).astype(np.float32)
Y_IRIS = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, 8)]
X_CHARS = RNG.integers(0, 11, (4, 10)).astype(np.int32)
Y_CHARS = RNG.integers(0, 11, (4, 10)).astype(np.int32)
NETS = {"mlp_float_inputs": (_mlp, X_IRIS, Y_IRIS),
        "char_rnn_index_inputs": (_char_rnn, X_CHARS, Y_CHARS)}


@pytest.mark.parametrize("name", sorted(NETS))
def test_mixed_network_outputs(name):
    make, x, _ = NETS[name]
    jnet = make()
    net = _port_of(jnet)
    want, got = jnet.output(x), net.output(x)
    assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **BF16_TOL)


@pytest.mark.parametrize("name", sorted(NETS))
def test_three_training_steps_keep_float32_params(name):
    make, x, y = NETS[name]
    jnet = make()
    net = _port_of(jnet)
    for _ in range(3):
        lj = float(jnet.fit_batch(JDataSet(x, y)))
        lt = float(net.fit_batch(DataSet(x, y)))
        assert abs(lj - lt) <= 2.0 ** -6
    jleaves = jax.tree_util.tree_leaves(jnet.params)
    tleaves = [t for p in net.params for t in _leaves(p)]
    assert {str(a.dtype) for a in jleaves} == {"float32"}
    assert {t.dtype for t in tleaves} == {torch.float32}
    for a, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-3, rtol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "k4"])
def test_adam_bfloat16_moments_over_float32_params(fused, monkeypatch):
    """``Adam(moment_dtype="bfloat16")`` under mixed dtypes: moments stay
    bfloat16 and parameters float32 in both packages, losses agree; K4's
    ``fused_apply`` takes the pair (bfloat16 moments up-cast to its flat
    float32 buffers) and steps bitwise the per-leaf Adam."""
    monkeypatch.setenv(update_kernel.ENV_SWITCH, "0")
    jnet = _mlp(JAdam(lr=1e-2, moment_dtype="bfloat16"))
    net = _port_of(jnet)
    twin = _port_of(jnet)
    monkeypatch.setenv(update_kernel.ENV_SWITCH, "1" if fused else "0")
    for _ in range(3):
        lj = float(jnet.fit_batch(JDataSet(X_IRIS, Y_IRIS)))
        lt = float(net.fit_batch(DataSet(X_IRIS, Y_IRIS)))
        assert abs(lj - lt) <= 2.0 ** -6
    monkeypatch.setenv(update_kernel.ENV_SWITCH, "0")
    for _ in range(3):
        twin.fit_batch(DataSet(X_IRIS, Y_IRIS))
    for os_, jos in zip(net.opt_state, jnet.opt_state):
        for k in ("m", "v"):
            assert {t.dtype for t in _leaves(os_.get(k, {}))} <= {torch.bfloat16}
            assert {str(a.dtype) for a in jax.tree_util.tree_leaves(jos.get(k, {}))} \
                <= {"bfloat16"}
    for p, q in zip(net.params, twin.params):
        for k in p:
            assert p[k].dtype == torch.float32 and torch.equal(p[k], q[k])


def test_mixed_checkpoints_both_ways(tmp_path):
    jnet = _char_rnn()
    jnet.fit_batch(JDataSet(X_CHARS, Y_CHARS))
    jpath, tpath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    j_save(jnet, jpath)
    net = load_model(jpath, device="cpu")
    assert (net.conf.param_dtype, net.conf.compute_dtype) == MIXED
    assert all(t.dtype == torch.float32 for p in net.params for t in _leaves(p))
    np.testing.assert_allclose(net.output(X_CHARS).float().numpy(),
                               _f32(jnet.output(X_CHARS)), **BF16_TOL)
    net.fit_batch(DataSet(X_CHARS, Y_CHARS))
    save_model(net, tpath)
    back = j_load(tpath)
    assert (back.conf.param_dtype, back.conf.compute_dtype) == MIXED
    for a, t in zip(jax.tree_util.tree_leaves(back.params),
                    [t for p in net.params for t in _leaves(p)]):
        assert str(a.dtype) == "float32"
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    again = load_model(tpath, device="cpu")
    assert torch.equal(again.output(X_CHARS), net.output(X_CHARS))
    assert again.iteration == net.iteration == back.iteration


LM = dict(vocab_size=32, n_layers=2, d_model=16, n_heads=2, max_len=16)


def test_mixed_transformer_lm_blocks_compute_in_float32(monkeypatch):
    """Under ("float32", "bfloat16") the TransformerLM's blocks receive
    float32 activations in both packages: the embedding gathers float32
    rows from integer ids, and only floating inputs are cast."""
    seen = {"jax": [], "port": []}
    j_apply, t_apply = jtr.block_apply, ttr.block_apply

    def j_rec(p, h, *a, **kw):
        seen["jax"].append(str(h.dtype))
        return j_apply(p, h, *a, **kw)

    def t_rec(p, h, *a, **kw):
        seen["port"].append(str(h.dtype).replace("torch.", ""))
        return t_apply(p, h, *a, **kw)

    monkeypatch.setattr(jtr, "block_apply", j_rec)
    monkeypatch.setattr(ttr, "block_apply", t_rec)
    jnet = jtr.TransformerLM(**LM, dtype=MIXED)
    net = ttr.TransformerLM(**LM, dtype=MIXED, device="cpu")
    net.params = params_from_numpy(_np(jnet.params), device="cpu")
    x = RNG.integers(0, LM["vocab_size"], (2, LM["max_len"]))
    want, got = jnet.output(x), net.output(x)
    assert seen["jax"] == ["float32"] * LM["n_layers"]
    assert seen["port"] == ["float32"] * LM["n_layers"]
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # the decode adapter refuses it, as the reference's does
    with pytest.raises(NotImplementedError):
        jtr.TransformerDecodeAdapter(jnet)
    with pytest.raises(NotImplementedError):
        ttr.TransformerDecodeAdapter(net)


def test_other_dtype_pairs_still_raise():
    def build(pd, cd):
        conf = (NeuralNetConfiguration.builder().layer(Dense(n_out=3))
                .layer(OutputLayer(n_out=2)).set_input_type(InputType.feed_forward(4))
                .dtype(pd, cd).build())
        return MultiLayerNetwork(conf, device="cpu")

    for pd, cd in (("bfloat16", "float32"), ("float16", "float32"),
                   ("float32", "float16")):
        with pytest.raises(NotImplementedError, match="dtypes"):
            build(pd, cd)
    for pd, cd in (("float32", "float32"), ("bfloat16", "bfloat16"), MIXED):
        build(pd, cd).init()
