"""The port's Keras HDF5 import (``deeplearning4j_tpu_torch.modelimport``)
against the reference package's on the same ``.h5`` files: every fixture of
``tests/test_modelimport.py`` (written by the same ``_write_keras_file``)
imports to the same config dict, bitwise the same parameters and layer
state, and ``output()`` within 1e-5; every refused file raises the same
exception class name with the same message.  A ResNet50-shaped functional
model at narrow widths (``chip_smoke.keras_resnet50``) gives the same
network, and the in-memory archive ``chip_smoke.KerasFile`` gives a
network bitwise the ``.h5`` path's."""

import json
import os
import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

import deeplearning4j_tpu.modelimport as jimport
import deeplearning4j_tpu_torch.modelimport as timport
from deeplearning4j_tpu.modelimport import keras as jkeras
from deeplearning4j_tpu_torch.modelimport import keras as tkeras

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the card script's Keras model generators)


def _write_keras_file(path, model_config, training_config, layer_weights):
    """layer_weights: {layer_name: {weight_path: array}} in Keras layout."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config)
        if training_config is not None:
            f.attrs["training_config"] = json.dumps(training_config)
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array(
            [n.encode() for n in layer_weights], dtype="S64")
        for lname, weights in layer_weights.items():
            g = mw.create_group(lname)
            g.attrs["weight_names"] = np.array(
                [wn.encode() for wn in weights], dtype="S128")
            for wn, arr in weights.items():
                g.create_dataset(wn, data=arr)


def _seq_config(layers):
    return {"class_name": "Sequential", "config": {"layers": layers}}


def _rng():
    return np.random.default_rng(42)


def _lstm_weights(rng, n_in, units, zero_bias=False):
    return {"lstm/kernel:0": rng.normal(size=(n_in, 4 * units), scale=0.5).astype(np.float32),
            "lstm/recurrent_kernel:0": rng.normal(size=(units, 4 * units),
                                                  scale=0.5).astype(np.float32),
            "lstm/bias:0": (np.zeros(4 * units, np.float32) if zero_bias else
                            rng.normal(size=(4 * units,), scale=0.5).astype(np.float32))}


def _func(layers, outputs):
    return {"class_name": "Model", "config": {
        "layers": layers, "input_layers": [["in", 0, 0]],
        "output_layers": [[o, 0, 0] for o in outputs]}}


def _input(shape):
    return {"class_name": "InputLayer", "config": {"name": "in",
                                                    "batch_input_shape": [None, *shape]},
            "inbound_nodes": []}


def _node(cls, inputs, **cfg):
    return {"class_name": cls, "config": cfg,
            "inbound_nodes": [[[i, 0, 0, {}] for i in inputs]]}


# -- the reference test file's fixtures: (model_config, training_config,
# weights, input) --------------------------------------------------------------


def case_mlp_dense(rng):
    cfg = _seq_config([
        {"class_name": "Dense", "config": {"name": "dense_1", "units": 8, "activation": "relu",
                                           "use_bias": True, "batch_input_shape": [None, 4]}},
        {"class_name": "Dense", "config": {"name": "dense_2", "units": 3,
                                           "activation": "softmax", "use_bias": True}}])
    w = {"dense_1": {"dense_1/kernel:0": rng.normal(size=(4, 8)).astype(np.float32),
                     "dense_1/bias:0": rng.normal(size=(8,)).astype(np.float32)},
         "dense_2": {"dense_2/kernel:0": rng.normal(size=(8, 3)).astype(np.float32),
                     "dense_2/bias:0": rng.normal(size=(3,)).astype(np.float32)}}
    return cfg, {"loss": "categorical_crossentropy"}, w, rng.normal(size=(5, 4))


def case_loss_head(rng):
    cfg = _seq_config([{"class_name": "Dense", "config": {
        "name": "d", "units": 2, "activation": "softmax", "batch_input_shape": [None, 3]}}])
    w = {"d": {"d/kernel:0": np.eye(3, 2, dtype=np.float32),
               "d/bias:0": np.zeros(2, np.float32)}}
    return cfg, {"loss": "categorical_crossentropy"}, w, rng.normal(size=(8, 3))


def case_cnn(rng):
    cfg = _seq_config([
        {"class_name": "Conv2D", "config": {
            "name": "conv", "filters": 4, "kernel_size": [3, 3], "strides": [1, 1],
            "padding": "valid", "activation": "relu", "data_format": "channels_last",
            "batch_input_shape": [None, 8, 8, 1]}},
        {"class_name": "MaxPooling2D", "config": {"name": "pool", "pool_size": [2, 2],
                                                  "strides": [2, 2], "padding": "valid"}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        {"class_name": "Dense", "config": {"name": "out", "units": 2, "activation": "linear"}}])
    w = {"conv": {"conv/kernel:0": rng.normal(size=(3, 3, 1, 4), scale=0.5).astype(np.float32),
                  "conv/bias:0": rng.normal(size=(4,)).astype(np.float32)},
         "out": {"out/kernel:0": rng.normal(size=(36, 2), scale=0.5).astype(np.float32),
                 "out/bias:0": np.zeros(2, np.float32)}}
    return cfg, None, w, rng.normal(size=(2, 8, 8, 1))


def case_batchnorm(rng):
    cfg = _seq_config([{"class_name": "BatchNormalization", "config": {
        "name": "bn", "epsilon": 1e-3, "momentum": 0.99, "axis": [1],
        "batch_input_shape": [None, 5]}}])
    w = {"bn": {"bn/gamma:0": rng.normal(size=(5,)).astype(np.float32),
                "bn/beta:0": rng.normal(size=(5,)).astype(np.float32),
                "bn/moving_mean:0": rng.normal(size=(5,)).astype(np.float32),
                "bn/moving_variance:0": np.abs(rng.normal(size=(5,))).astype(np.float32) + 0.5}}
    return cfg, None, w, rng.normal(size=(4, 5))


def case_lstm_sequences(rng):
    cfg = _seq_config([{"class_name": "LSTM", "config": {
        "name": "lstm", "units": 4, "activation": "tanh", "recurrent_activation": "sigmoid",
        "return_sequences": True, "unit_forget_bias": True,
        "batch_input_shape": [None, 5, 3]}}])
    return cfg, None, {"lstm": _lstm_weights(rng, 3, 4)}, rng.normal(size=(2, 5, 3))


def case_lstm_last_step(rng):
    cfg = _seq_config([
        {"class_name": "LSTM", "config": {
            "name": "lstm", "units": 4, "activation": "tanh", "recurrent_activation": "sigmoid",
            "return_sequences": False, "batch_input_shape": [None, 5, 3]}},
        {"class_name": "Dense", "config": {"name": "d", "units": 2, "activation": "linear"}}])
    w = {"lstm": _lstm_weights(rng, 3, 4, zero_bias=True),
         "d": {"d/kernel:0": rng.normal(size=(4, 2)).astype(np.float32),
               "d/bias:0": np.zeros(2, np.float32)}}
    return cfg, None, w, rng.normal(size=(2, 5, 3))


def case_lstm_loss_head(rng):
    cfg = _seq_config([{"class_name": "LSTM", "config": {
        "name": "lstm", "units": 3, "return_sequences": True,
        "batch_input_shape": [None, 4, 2]}}])
    w = {"lstm": {"lstm/kernel:0": rng.normal(size=(2, 12)).astype(np.float32),
                  "lstm/recurrent_kernel:0": rng.normal(size=(3, 12)).astype(np.float32),
                  "lstm/bias:0": np.zeros(12, np.float32)}}
    return cfg, {"loss": "mse"}, w, rng.normal(size=(2, 4, 2))


def case_keras1_conv(rng):
    cfg = _seq_config([{"class_name": "Convolution2D", "config": {
        "name": "c", "nb_filter": 2, "nb_row": 3, "nb_col": 5, "activation": "linear",
        "border_mode": "valid", "batch_input_shape": [None, 8, 8, 1]}}])
    w = {"c": {"c/kernel:0": rng.normal(size=(3, 5, 1, 2), scale=0.5).astype(np.float32),
               "c/bias:0": np.zeros(2, np.float32)}}
    return cfg, None, w, rng.normal(size=(1, 8, 8, 1))


def case_embedding(rng):
    cfg = _seq_config([{"class_name": "Embedding", "config": {
        "name": "emb", "input_dim": 10, "output_dim": 6, "batch_input_shape": [None, 4]}}])
    w = {"emb": {"emb/embeddings:0": rng.normal(size=(10, 6)).astype(np.float32)}}
    return cfg, None, w, np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)


def case_two_branch_add(rng):
    cfg = _func([_input([4]),
                 _node("Dense", ["in"], name="a", units=6, activation="relu"),
                 _node("Dense", ["in"], name="b", units=6, activation="relu"),
                 _node("Add", ["a", "b"], name="add"),
                 _node("Dense", ["add"], name="out", units=2, activation="linear")], ["out"])
    w = {n: {f"{n}/kernel:0": rng.normal(size=shape).astype(np.float32),
             f"{n}/bias:0": np.zeros(shape[1], np.float32)}
         for n, shape in (("a", (4, 6)), ("b", (4, 6)), ("out", (6, 2)))}
    return cfg, None, w, rng.normal(size=(3, 4))


def case_functional_lstm(rng):
    cfg = _func([_input([5, 3]),
                 _node("LSTM", ["in"], name="lstm", units=4, activation="tanh",
                       recurrent_activation="sigmoid", return_sequences=False)], ["lstm"])
    return cfg, None, {"lstm": _lstm_weights(rng, 3, 4, zero_bias=True)}, rng.normal(size=(2, 5, 3))


def case_concatenate(rng):
    cfg = _func([_input([3]),
                 _node("Dense", ["in"], name="a", units=2, activation="linear", use_bias=False),
                 _node("Dense", ["in"], name="b", units=5, activation="linear", use_bias=False),
                 _node("Concatenate", ["a", "b"], name="cat")], ["cat"])
    w = {"a": {"a/kernel:0": rng.normal(size=(3, 2)).astype(np.float32)},
         "b": {"b/kernel:0": rng.normal(size=(3, 5)).astype(np.float32)}}
    return cfg, None, w, rng.normal(size=(2, 3))


def case_separable(rng):
    cin, dm, cout, kh, kw = 3, 2, 5, 3, 3
    cfg = _seq_config([
        {"class_name": "SeparableConv2D", "config": {
            "name": "sep_1", "filters": cout, "kernel_size": [kh, kw], "strides": [1, 1],
            "padding": "valid", "depth_multiplier": dm, "activation": "linear",
            "use_bias": True, "data_format": "channels_last",
            "batch_input_shape": [None, 8, 8, cin]}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        {"class_name": "Dense", "config": {"name": "out", "units": 2, "activation": "softmax",
                                           "use_bias": False}}])
    w = {"sep_1": {"sep_1/depthwise_kernel:0":
                   rng.normal(size=(kh, kw, cin, dm)).astype(np.float32),
                   "sep_1/pointwise_kernel:0":
                   rng.normal(size=(1, 1, cin * dm, cout)).astype(np.float32),
                   "sep_1/bias:0": rng.normal(size=(cout,)).astype(np.float32)},
         "flat": {},
         "out": {"out/kernel:0": rng.normal(size=(6 * 6 * cout, 2)).astype(np.float32)}}
    return cfg, {"loss": "categorical_crossentropy"}, w, rng.normal(size=(2, 8, 8, cin))


def case_noise_layers(rng):
    cfg = _seq_config([
        {"class_name": "GaussianNoise", "config": {"name": "gn", "stddev": 0.2,
                                                   "batch_input_shape": [None, 4]}},
        {"class_name": "GaussianDropout", "config": {"name": "gd", "rate": 0.3}},
        {"class_name": "AlphaDropout", "config": {"name": "ad", "rate": 0.1}},
        {"class_name": "Dense", "config": {"name": "out", "units": 3, "activation": "softmax",
                                           "use_bias": False}}])
    w = {"gn": {}, "gd": {}, "ad": {},
         "out": {"out/kernel:0": rng.normal(size=(4, 3)).astype(np.float32)}}
    return cfg, {"loss": "categorical_crossentropy"}, w, rng.normal(size=(5, 4))


def case_conv2d_transpose(rng):
    cfg = _seq_config([{"class_name": "Conv2DTranspose", "config": {
        "name": "deconv", "filters": 4, "kernel_size": [3, 3], "strides": [2, 2],
        "padding": "same", "use_bias": True, "activation": "linear",
        "data_format": "channels_last", "batch_input_shape": [None, 5, 5, 3]}}])
    w = {"deconv": {"deconv/kernel:0": rng.normal(size=(3, 3, 4, 3)).astype(np.float32),
                    "deconv/bias:0": rng.normal(size=(4,)).astype(np.float32)}}
    return cfg, None, w, rng.normal(size=(2, 5, 5, 3))


def case_zeropad1d(rng):
    cfg = _seq_config([{"class_name": "ZeroPadding1D", "config": {
        "name": "zp", "padding": [2, 1], "batch_input_shape": [None, 6, 4]}}])
    return cfg, None, {}, rng.normal(size=(3, 6, 4))


def case_cropping2d(rng):
    cfg = _seq_config([{"class_name": "Cropping2D", "config": {
        "name": "cr", "cropping": [[1, 2], [0, 1]], "data_format": "channels_last",
        "batch_input_shape": [None, 8, 8, 2]}}])
    return cfg, None, {}, rng.normal(size=(2, 8, 8, 2))


CASES = {f.__name__[5:]: f for f in (
    case_mlp_dense, case_loss_head, case_cnn, case_batchnorm, case_lstm_sequences,
    case_lstm_last_step, case_lstm_loss_head, case_keras1_conv, case_embedding,
    case_two_branch_add, case_functional_lstm, case_concatenate, case_separable,
    case_noise_layers, case_conv2d_transpose, case_zeropad1d, case_cropping2d)}


def _to_np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _trees(model):
    """(params, state) as {layer: {key: array}} for a network or a graph."""
    def named(tree):
        if isinstance(tree, dict):
            return {k: {kk: _to_np(vv) for kk, vv in (v or {}).items()} for k, v in tree.items()}
        return {i: {kk: _to_np(vv) for kk, vv in (v or {}).items()} for i, v in enumerate(tree)}
    return named(model.params), named(model.state)


def _assert_same_network(port, ref, exact_keys=True):
    assert port.conf.to_dict() == ref.conf.to_dict()
    for tp, rp in zip(_trees(port), _trees(ref)):
        assert tp.keys() == rp.keys()
        for layer in rp:
            assert tp[layer].keys() == rp[layer].keys(), layer
            for k in rp[layer]:
                np.testing.assert_array_equal(tp[layer][k], rp[layer][k], err_msg=f"{layer}/{k}")


def _outputs(model, x):
    out = model.output(x)
    return [_to_np(o) for o in out] if isinstance(out, list) else [_to_np(out)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixture_imports_to_the_references_network(tmp_path, case):
    """Same config dict, bitwise parameters and state, outputs within 1e-5,
    through the entry point each reference test calls."""
    cfg, tcfg, weights, x = CASES[case](_rng())
    path = str(tmp_path / f"{case}.h5")
    _write_keras_file(path, cfg, tcfg, weights)
    seq = cfg["class_name"] == "Sequential"
    jfn = (jimport.import_keras_sequential_model_and_weights if seq
           else jimport.import_keras_model_and_weights)
    tfn = (timport.import_keras_sequential_model_and_weights if seq
           else timport.import_keras_model_and_weights)
    ref, port = jfn(path), tfn(path, device="cpu")
    assert type(port).__name__ == type(ref).__name__
    _assert_same_network(port, ref)
    x = np.asarray(x) if x.dtype == np.int32 else np.asarray(x, np.float32)
    for got, want in zip(_outputs(port, x), _outputs(ref, x)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_an_imported_loss_head_trains_like_the_references(tmp_path):
    """The training config's loss head: one step from the same imported
    weights gives the same loss (1e-5) and parameters (1e-5)."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets import DataSet

    cfg, tcfg, weights, _ = case_loss_head(_rng())
    path = str(tmp_path / "m.h5")
    _write_keras_file(path, cfg, tcfg, weights)
    ref = jimport.import_keras_sequential_model_and_weights(path)
    port = timport.import_keras_sequential_model_and_weights(path, device="cpu")
    x = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
    lr, lp = float(ref.fit_batch(JDataSet(x, y))), float(port.fit_batch(DataSet(x, y)))
    assert np.isfinite(lp)
    np.testing.assert_allclose(lp, lr, rtol=1e-5)
    for tp, rp in zip(_trees(port)[0].values(), _trees(ref)[0].values()):
        for k in rp:
            np.testing.assert_allclose(tp[k], rp[k], rtol=1e-5, atol=1e-6)


def test_the_port_keeps_the_keras_layouts(tmp_path):
    """HWIO conv and [in, out] dense kernels go into ``params`` as they are;
    the LSTM's gates move to [i|f|o|g] and Conv2DTranspose's kernel is
    transposed and flipped, as in the reference."""
    rng = _rng()
    cfg, _, w, _ = case_cnn(rng)
    path = str(tmp_path / "cnn.h5")
    _write_keras_file(path, cfg, None, w)
    net = timport.import_keras_sequential_model_and_weights(path, device="cpu")
    np.testing.assert_array_equal(net.params[0]["W"].numpy(), w["conv"]["conv/kernel:0"])
    np.testing.assert_array_equal(net.params[2]["W"].numpy(), w["out"]["out/kernel:0"])
    k = np.arange(2 * 16, dtype=np.float32).reshape(2, 16)
    np.testing.assert_array_equal(tkeras._convert_lstm_kernel(k, 4),
                                  np.concatenate([k[:, :8], k[:, 12:], k[:, 8:12]], axis=1))
    cfg, _, w, _ = case_conv2d_transpose(rng)
    _write_keras_file(path, cfg, None, w)
    net = timport.import_keras_sequential_model_and_weights(path, device="cpu")
    np.testing.assert_array_equal(net.params[0]["W"].numpy(),
                                  w["deconv"]["deconv/kernel:0"].transpose(0, 1, 3, 2)[::-1, ::-1])


# -- refusals: the same class and message ---------------------------------------------


def _refused_bn_axis():
    return _seq_config([
        {"class_name": "Conv2D", "config": {"name": "c", "filters": 2, "kernel_size": [3, 3],
                                            "batch_input_shape": [None, 8, 8, 1]}},
        {"class_name": "BatchNormalization", "config": {"name": "bn", "axis": 1}}]), {}


def _refused_channels_first():
    return _seq_config([{"class_name": "Conv2D", "config": {
        "name": "c", "filters": 2, "kernel_size": [3, 3], "data_format": "channels_first",
        "batch_input_shape": [None, 1, 8, 8]}}]), {}


def _refused_lambda():
    return _seq_config([{"class_name": "Lambda", "config": {
        "name": "l", "batch_input_shape": [None, 3]}}]), {}


def _refused_shared_layer():
    return {"class_name": "Model", "config": {
        "layers": [_input([3]),
                   {"class_name": "Dense", "config": {"name": "shared", "units": 3,
                                                      "activation": "linear"},
                    "inbound_nodes": [[["in", 0, 0, {}]], [["shared", 0, 0, {}]]]}],
        "input_layers": [["in", 0, 0]], "output_layers": [["shared", 1, 0]]}}, {}


def _refused_output_padding():
    return _seq_config([{"class_name": "Conv2DTranspose", "config": {
        "name": "d", "filters": 2, "kernel_size": [3, 3], "strides": [2, 2],
        "padding": "valid", "output_padding": [1, 1], "use_bias": False,
        "data_format": "channels_last", "batch_input_shape": [None, 5, 5, 3]}}]), {
        "d": {"d/kernel:0": np.zeros((3, 3, 2, 3), np.float32)}}


def _refused_unknown_loss():
    cfg, _, w, _ = case_loss_head(_rng())
    return cfg, w, {"loss": "made_up_loss"}


def _refused_no_input_shape():
    return _seq_config([{"class_name": "Dense", "config": {"name": "d", "units": 2}}]), {}


def _refused_model_class():
    return {"class_name": "Subclassed", "config": {"layers": []}}, {}


def _refused_recurrent_features():
    return _seq_config([{"class_name": "LSTM", "config": {
        "name": "lstm", "units": 3, "batch_input_shape": [None, 4, None]}}]), {}


def _refused_concatenate_axis():
    return _func([_input([3]),
                  _node("Dense", ["in"], name="a", units=2, activation="linear"),
                  _node("Dense", ["in"], name="b", units=2, activation="linear"),
                  _node("Concatenate", ["a", "b"], name="cat", axis=0)], ["cat"]), {}


def _refused_padding_mode():
    return _seq_config([{"class_name": "Conv2D", "config": {
        "name": "c", "filters": 2, "kernel_size": [3, 3], "padding": "causal",
        "batch_input_shape": [None, 8, 8, 1]}}]), {}


def _refused_activation():
    return _seq_config([{"class_name": "Dense", "config": {
        "name": "d", "units": 2, "activation": "made_up", "batch_input_shape": [None, 3]}}]), {}


REFUSED = {f.__name__[9:]: f for f in (
    _refused_bn_axis, _refused_channels_first, _refused_lambda, _refused_shared_layer,
    _refused_output_padding, _refused_unknown_loss, _refused_no_input_shape,
    _refused_model_class, _refused_recurrent_features, _refused_concatenate_axis,
    _refused_padding_mode, _refused_activation)}


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as e:
        fn(*args, **kw)
    return e.value


@pytest.mark.parametrize("case", sorted(REFUSED))
@pytest.mark.parametrize("entry", ["sequential", "model"])
def test_a_refused_file_raises_the_references_error(tmp_path, case, entry):
    made = REFUSED[case]()
    cfg, weights = made[:2]
    tcfg = made[2] if len(made) > 2 else None
    path = str(tmp_path / f"{case}.h5")
    _write_keras_file(path, cfg, tcfg, weights)
    name = f"import_keras_{'sequential_' if entry == 'sequential' else ''}model_and_weights"
    ref = _raised(getattr(jimport, name), path)
    port = _raised(getattr(timport, name), path, device="cpu")
    assert type(port).__name__ == type(ref).__name__
    assert str(port) == str(ref)
    if isinstance(ref, jkeras.InvalidKerasConfigurationException):
        assert isinstance(port, tkeras.InvalidKerasConfigurationException)
        assert isinstance(port, ValueError)


def test_weights_only_and_enforced_training_config_refusals(tmp_path):
    path = str(tmp_path / "w.h5")
    with h5py.File(path, "w") as f:  # save_weights format: no model_config
        f.create_group("dense_1").create_dataset("dense_1/kernel:0",
                                                 data=np.zeros((2, 2), np.float32))
    for fn in ("import_keras_model_and_weights", "import_keras_sequential_model_and_weights"):
        ref = _raised(getattr(jimport, fn), path)
        port = _raised(getattr(timport, fn), path, device="cpu")
        assert (type(port).__name__, str(port)) == (type(ref).__name__, str(ref))
    cfg, _, w, _ = case_cnn(_rng())
    _write_keras_file(path, cfg, None, w)
    ref = _raised(jimport.import_keras_model_and_weights, path, enforce_training_config=True)
    port = _raised(timport.import_keras_model_and_weights, path, enforce_training_config=True,
                   device="cpu")
    assert (type(port).__name__, str(port)) == (type(ref).__name__, str(ref))


@pytest.mark.parametrize("kind,name", [
    ("activation", "linear"), ("activation", "hard_sigmoid"), ("activation", "leaky_relu"),
    ("activation", "made_up"), ("loss", "categorical_crossentropy"), ("loss", "mse"),
    ("loss", "kullback_leibler_divergence"), ("loss", "made_up"),
    ("initializer", "GlorotUniform"), ("initializer", "he_normal"),
    ("initializer", {"class_name": "VarianceScaling", "config": {}}),
    ("initializer", "Orthogonal"), ("initializer", None)])
def test_name_maps_are_the_references(kind, name):
    fn = f"map_{kind}"
    try:
        want = getattr(jkeras, fn)(name)
    except jkeras.InvalidKerasConfigurationException as e:
        port = _raised(getattr(tkeras, fn), name)
        assert isinstance(port, tkeras.InvalidKerasConfigurationException)
        assert str(port) == str(e)
        return
    assert getattr(tkeras, fn)(name) == want


def test_entry_points_and_exports_are_the_references():
    assert timport.KerasModelImport.import_keras_model_and_weights \
        is timport.import_keras_model_and_weights
    assert timport.KerasModelImport.import_keras_sequential_model_and_weights \
        is timport.import_keras_sequential_model_and_weights
    assert sorted(timport.__all__) == sorted(jimport.__all__)
    assert sorted(tkeras._LAYER_MAP) == sorted(jkeras._LAYER_MAP)
    assert tkeras._MERGE_OPS == jkeras._MERGE_OPS


def test_the_default_device_is_the_card(tmp_path):
    """Without ``device=`` the network lives on ``cuda``: on a machine
    without a card the import raises rather than fall back to the CPU."""
    cfg, tcfg, w, _ = case_mlp_dense(_rng())
    path = str(tmp_path / "m.h5")
    _write_keras_file(path, cfg, tcfg, w)
    if torch.cuda.is_available():
        net = timport.import_keras_model_and_weights(path)
        assert net.params[0]["W"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            timport.import_keras_model_and_weights(path)


# -- keras.applications shapes, and the in-memory seam -----------------------------------


NARROW_RESNET = dict(hw=32, classes=10, stem=8, stages=((4, 2, 1), (8, 1, 2)))
NARROW_VGG = dict(hw=32, classes=10, widths=(4, 4, 8, 8, 8), fc=16)


@pytest.mark.parametrize("arch", ["resnet50", "vgg16"])
def test_keras_applications_shapes_import_like_the_references(tmp_path, arch):
    """A ResNet50-shaped functional model (ZeroPadding2D, BN epsilon
    1.001e-5, Add, GlobalAveragePooling2D: the stem and three bottleneck
    blocks, projection and identity shortcuts, strides 1 and 2) and a
    VGG16-shaped Sequential at narrow widths: the same network in both
    packages, outputs within 1e-5."""
    kf = (chip_smoke.keras_resnet50(3, **NARROW_RESNET) if arch == "resnet50"
          else chip_smoke.keras_vgg16(3, **NARROW_VGG))
    path = str(tmp_path / f"{arch}.h5")
    kf.write(path)
    ref = jimport.import_keras_model_and_weights(path)
    port = timport.import_keras_model_and_weights(path, device="cpu")
    _assert_same_network(port, ref)
    x = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(np.float32)
    for got, want in zip(_outputs(port, x), _outputs(ref, x)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    n_params = sum(a.size for tree in _trees(port) for layer in tree.values()
                   for a in layer.values())
    assert n_params == kf.n_weights()


def test_the_published_parameter_counts():
    """The generators' weights at the published widths: VGG16 138,357,544,
    ResNet50 25,636,712 (shapes only; no network is built)."""
    assert chip_smoke.keras_vgg16(0).n_weights() == 138_357_544
    assert chip_smoke.keras_resnet50(0).n_weights() == 25_636_712


@pytest.mark.parametrize("arch", ["resnet50", "vgg16"])
def test_the_in_memory_archive_is_bitwise_the_h5_path(tmp_path, arch):
    """The import stages after the read, fed ``chip_smoke.KerasFile``'s
    config and arrays, build the network the ``.h5`` file gives, bitwise."""
    kf = (chip_smoke.keras_resnet50(5, **NARROW_RESNET) if arch == "resnet50"
          else chip_smoke.keras_vgg16(5, **NARROW_VGG))
    path = str(tmp_path / f"{arch}.h5")
    kf.write(path)
    from_file = timport.import_keras_model_and_weights(path, device="cpu")
    from_memory = tkeras._import_archive(kf, device="cpu")
    _assert_same_network(from_memory, from_file)
    x = np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32)
    for a, b in zip(_outputs(from_memory, x), _outputs(from_file, x)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(tkeras.InvalidKerasConfigurationException, match="functional model"):
        tkeras._import_archive(chip_smoke.keras_resnet50(5, **NARROW_RESNET), device="cpu",
                               sequential_only=True)
