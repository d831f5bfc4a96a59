"""Int8 serving (``deeplearning4j_tpu_torch/ops/quantize.py``) held against
the reference's ``deeplearning4j_tpu/ops/quantize.py`` on the CPU: the
weight quantization bitwise, the int8 product's int32 accumulator exactly
and its output within 1e-6, the padded ``torch._int_mm`` path, the
calibration pass, ``quantize_model`` on an MLP, the Iris MLP and a narrow
TransformerLM within rtol 1e-5 / atol 1e-6, ``init_pretrained_int8``'s
envelope and the predict engine's int8 contracts.

The reference's calibration stand-in has no indexing, so its calibration
raises on a network whose ``W`` is gathered from (``EmbeddingSequence``);
the port's passes an index through.  The TransformerLM cases give the
reference's stand-in the same pass-through (``_ref_gather``) to hold the
rest of the pass against it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.fetchers import load_iris
from deeplearning4j_tpu.models import init_pretrained as j_init_pretrained
from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.ops import quantize as jq
from deeplearning4j_tpu_torch.models import pretrained as tpt
from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import quantize as tq
from deeplearning4j_tpu_torch.serving import Engine
from deeplearning4j_tpu_torch.serving.engine import _to_device
from deeplearning4j_tpu_torch.utils.params import params_from_numpy
from deeplearning4j_tpu_torch.utils.serializer import load_model

IRIS_ZIP = "deeplearning4j_tpu/models/weights/iris_mlp_iris.zip"
LM = dict(vocab_size=48, n_layers=2, d_model=32, n_heads=4, max_len=12)
OUT_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jmlp(seed=0, n_in=12, n_out=4, steps=20):
    """The reference test's MLP (12 → 32 relu → 4 softmax), trained a little."""
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, 64)]
    conf = (JConf.builder().seed(seed).updater(JAdam(lr=1e-2))
            .layer(JDense(n_out=32, activation="relu"))
            .layer(JOutputLayer(n_out=n_out, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(n_in)).build())
    net = JNet(conf)
    net.init()
    for _ in range(steps):
        net.fit_batch(JDataSet(x, y))
    return net, x


def _port_of(jnet):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jnet.conf.to_dict()),
                            device="cpu")
    net.params = params_from_numpy(_np(jnet.params), device="cpu")
    net.state = params_from_numpy(_np(jnet.state), device="cpu")
    return net


def _lm(seed=3):
    jnet = JLM(**LM, seed=seed)
    tnet = TransformerLM(**LM, seed=seed, device="cpu")
    tnet.params = params_from_numpy(_np(jnet.params), device="cpu")
    x = np.random.default_rng(seed).integers(0, LM["vocab_size"],
                                             (4, LM["max_len"])).astype(np.float32)
    return jnet, tnet, x


@pytest.fixture
def _ref_gather(monkeypatch):
    """Give the reference's calibration stand-in the port's index
    pass-through (see the module docstring)."""
    monkeypatch.setattr(jq._CalibWeight, "__getitem__", lambda self, i: self.w[i],
                        raising=False)


def _jpath(path):
    """A reference tree path as the port's tuple of indices and keys."""
    return tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)


def _weights():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 8)).astype(np.float32)
    spread = w * np.logspace(-3, 2, 8, dtype=np.float32)[None, :]
    zero = rng.normal(size=(16, 3)).astype(np.float32)
    zero[:, 0] = 0.0
    zero[:, 2] = 0.0
    outlier = rng.normal(size=(32, 4)).astype(np.float32)
    outlier[0, 3] = 1e4
    halves = np.full((9, 5), 0.5, np.float32) * np.arange(1, 6, dtype=np.float32)
    return {"normal": w, "spread": spread, "all_zero_channels": zero,
            "outlier_channel": outlier, "ties": halves}


# -- the weight --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(_weights()))
@pytest.mark.parametrize("act_amax", [1.0, 0.0, 3.7])
def test_quantize_weight_is_bitwise_the_references(name, act_amax):
    w = _weights()[name]
    want = jq.quantize_weight(jnp.asarray(w), act_amax)
    got = tq.quantize_weight(torch.from_numpy(w), act_amax)
    assert got.values.dtype == torch.int8 and got.shape == w.shape
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.act_scale.numpy().tobytes() == np.asarray(want.act_scale).tobytes()
    # the padding is zeros at multiples of 8
    kp, np_ = got.padded.shape
    assert kp % 8 == 0 and np_ % 8 == 0
    assert not got.padded[w.shape[0]:].any() and not got.padded[:, w.shape[1]:].any()
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))


@pytest.mark.parametrize("shape", [(3, 64, 8), (1, 16, 3), (2, 5, 9, 5), (40, 32, 4)])
def test_int8_product_accumulator_is_exactly_the_references(shape):
    """The activation's int8 form and the int32 accumulator bitwise the
    reference's operations; the dequantized output within 1e-6 relative."""
    *lead, k, n = shape
    rng = np.random.default_rng(k * n)
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = (2.5 * rng.normal(size=(*lead, k))).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w), 3.0)       # saturates the tails
    tw = tq.quantize_weight(torch.from_numpy(w), 3.0)
    jxq = jnp.clip(jnp.round(jnp.asarray(x) / jw.act_scale), -127.0, 127.0).astype(jnp.int8)
    jacc = jax.lax.dot_general(jxq, jw.values,
                               dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    txq = tw.quantize_input(torch.from_numpy(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    tacc = tw.int_mm(txq)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    got = (torch.from_numpy(x) @ tw.to(torch.float32)).numpy()
    want = np.asarray(jnp.asarray(x) @ jw)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_padded_int_mm_matches_the_unpadded_product_at_k4_n3_m1():
    """K=4, N=3 (not multiples of 8) and M=1 (below the card's 17 rows):
    the zero padding changes no sum."""
    w = tq.quantize_weight(torch.randn(4, 3, generator=torch.Generator().manual_seed(0)),
                           2.0)
    assert tuple(w.padded.shape) == (8, 8)
    xq = torch.tensor([[-127, 5, 64, 127]], dtype=torch.int8)
    got = w.int_mm(xq)
    assert got.shape == (1, 3)
    torch.testing.assert_close(got, xq.to(torch.int32) @ w.values.to(torch.int32),
                               rtol=0, atol=0)


def test_int32_accumulation_does_not_overflow_int16():
    w = tq.quantize_weight(torch.ones(256, 2), 1.0)
    y = torch.ones(1, 256) @ w
    np.testing.assert_allclose(y.numpy(), 256.0, rtol=0.02)


def test_to_moves_devices_and_keeps_dtype_casts_the_identity():
    w = tq.quantize_weight(torch.ones(8, 2), 1.0)
    assert w.to(torch.bfloat16) is w and w.to(torch.float32) is w
    assert w.to("cpu") is w and w.to(torch.device("cpu")) is w
    assert w.shape == (8, 2) and w.ndim == 2 and w.dtype == torch.int8
    tree = {"W": w, "b": torch.zeros(2)}
    moved = _to_device([tree], torch.device("cpu"))
    assert moved[0]["W"] is w


def test_bf16_activation_gets_a_bf16_output():
    w = tq.quantize_weight(torch.randn(16, 8), 2.0)
    x = torch.randn(3, 16).to(torch.bfloat16)
    y = x @ w.to(x.dtype)
    assert y.dtype == torch.bfloat16
    want = ((w.int_mm(w.quantize_input(x)).float() * (w.act_scale * w.scales))
            .to(torch.bfloat16))
    torch.testing.assert_close(y, want, rtol=0, atol=0)


# -- calibration ---------------------------------------------------------------------------


def test_calibration_finds_the_references_weights_and_amax():
    jnet, x = _jmlp(seed=3)
    tnet = _port_of(jnet)
    want = {_jpath(p): v for p, v in jq.calibrate(jnet, x).items()}
    got = tq.calibrate(tnet, x)
    assert set(got) == set(want) == {(0, "W"), (1, "W")}
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-6)
    assert tq.calibrate(tnet, x) == got                 # deterministic


def test_calibration_takes_the_running_max_over_batches():
    jnet, x = _jmlp(seed=4)
    tnet = _port_of(jnet)
    small = tq.calibrate(tnet, x * 0.1)
    both = tq.calibrate(tnet, [x * 0.1, x])
    want = {_jpath(p): v for p, v in jq.calibrate(jnet, [x * 0.1, x]).items()}
    assert all(both[k] >= small[k] for k in small)
    for p in want:
        np.testing.assert_allclose(both[p], want[p], rtol=1e-6)


def test_calibration_of_a_transformer_lm_quantizes_its_head_only(_ref_gather):
    jnet, tnet, x = _lm()
    want = {_jpath(p): v for p, v in jq.calibrate(jnet, x).items()}
    got = tq.calibrate(tnet, x)
    head = len(tnet.params) - 1
    assert set(got) == set(want) == {(head, "W")}
    np.testing.assert_allclose(got[(head, "W")], want[(head, "W")], rtol=1e-6)


def test_unexercised_weight_stays_float():
    jnet, x = _jmlp(seed=5)
    tnet = _port_of(jnet)
    stats = tq.calibrate(tnet, x)
    qp = tq.quantize_params(tnet.params, dict(list(stats.items())[:1]))
    kinds = [type(layer["W"]) for layer in qp]
    assert kinds == [tq.Int8Weight, torch.Tensor]


def test_quantize_model_requires_candidates():
    class NoDense:
        params = [{"foo": torch.ones(3)}]
        state = [{}]

        def _apply_layers(self, params, state, x, mask, **kw):
            return (x, None, None)

    with pytest.raises(ValueError, match="no 2-D 'W'"):
        tq.quantize_model(NoDense(), np.ones((4, 3), np.float32))


# -- the quantized model ---------------------------------------------------------------------


def _quantized_both(jnet, tnet, x):
    jqm = jq.quantize_model(jnet, x)
    tqm = tq.quantize_model(tnet, x)
    return np.asarray(jqm.output(x)), tqm.output(x).numpy()


def test_quantized_mlp_output_matches_the_reference():
    jnet, x = _jmlp(seed=6)
    want, got = _quantized_both(jnet, _port_of(jnet), x)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    ref = np.asarray(jnet.output(x))
    assert np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-6) < 0.05
    assert (ref.argmax(1) == got.argmax(1)).mean() >= 0.95


def test_quantized_iris_mlp_output_matches_the_reference():
    from deeplearning4j_tpu.utils.serializer import load_model as j_load
    xs, _ = load_iris()
    want, got = _quantized_both(j_load(IRIS_ZIP), load_model(IRIS_ZIP, device="cpu"), xs)
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_quantized_transformer_lm_output_matches_the_reference(_ref_gather):
    jnet, tnet, x = _lm()
    want, got = _quantized_both(jnet, tnet, x)
    assert got.shape == (4, LM["max_len"], LM["vocab_size"])
    np.testing.assert_allclose(got, want, **OUT_TOL)
    ref = tnet.output(x).numpy()
    assert np.abs(ref - got).max() / np.abs(ref).max() < 0.05


def test_init_pretrained_int8_envelope(tmp_path):
    """The shipped Iris MLP's accuracy survives quantization, and the int8
    model agrees with the float one (the reference's envelope)."""
    xs, ys = load_iris()
    net = tpt.init_pretrained("iris_mlp", tpt.PretrainedType.IRIS,
                              cache_dir=str(tmp_path), device="cpu")
    qm = tpt.init_pretrained_int8("iris_mlp", tpt.PretrainedType.IRIS,
                                  calibration_inputs=xs, cache_dir=str(tmp_path),
                                  device="cpu")
    assert isinstance(qm, tq.QuantizedModel)
    ref = net.output(xs).numpy()
    got = qm.output(xs).numpy()
    assert (got.argmax(1) == ys).mean() > 0.97
    assert (ref.argmax(1) == got.argmax(1)).mean() >= 0.99
    jnet = j_init_pretrained("iris_mlp", "iris", cache_dir=str(tmp_path / "j"))
    np.testing.assert_allclose(got, np.asarray(jq.quantize_model(jnet, xs).output(xs)),
                               **OUT_TOL)
    with pytest.raises(ValueError, match="calibration_inputs"):
        tpt.init_pretrained_int8("iris_mlp", "iris", device="cpu")


# -- the engine's int8 contracts --------------------------------------------------------------


def _engine(net, **kw):
    return Engine(net, max_batch=8, slo_ms=10_000, bucket_sizes=(4, 8), replicas=1,
                  device="cpu", **kw)


def test_engine_int8_programs_flat_while_serving():
    jnet, x = _jmlp(seed=7)
    eng = _engine(_port_of(jnet))
    try:
        eng.load(input_shape=(12,), quantize="int8", calibration_inputs=x)
        n0 = eng.compile_cache_size()
        assert n0 == 2 and eng.current_tag == "v0+int8"
        for b in (3, 4, 8):
            assert eng.output(x[:b]).shape == (b, 4)
        assert eng.compile_cache_size() == n0
        snap = eng.metrics_snapshot()["counters"]
        assert snap["unwarmed_serves"] == 0
        # the quantized path reads no bundle: every pair is a miss
        assert snap["bundle_misses"] == 2 and snap["bundle_hits"] == 0
    finally:
        eng.shutdown()


def test_engine_int8_serves_the_direct_quantized_forward_and_the_reference():
    jnet, x = _jmlp(seed=8)
    tnet = _port_of(jnet)
    qm = tq.quantize_model(tnet, x)
    eng = _engine(tnet)
    try:
        eng.load(input_shape=(12,), quantize="int8", calibration_inputs=x)
        served = eng.output(x[:4])
        np.testing.assert_allclose(served, qm.output(x[:4]).numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(served, np.asarray(jq.quantize_model(jnet, x).output(x[:4])),
                                   **OUT_TOL)
    finally:
        eng.shutdown()


def test_engine_int8_lm_rows_are_the_eager_quantized_bucket(_ref_gather):
    _, tnet, x = _lm()
    eng = Engine(tnet, max_batch=4, slo_ms=30_000, replicas=2, device="cpu")
    try:
        eng.load(input_shape=(LM["max_len"],), quantize="int8", calibration_inputs=x)
        assert eng.compile_cache_size() == 3 * 2
        qm = eng._current.model
        for rows in (1, 3):
            got = eng.output(x[:rows])
            pad = np.concatenate([x[:rows], np.zeros((4 - rows, LM["max_len"]), np.float32)])
            want = qm.output(pad)[:rows].numpy()
            np.testing.assert_array_equal(got, want)
        assert eng.metrics_snapshot()["counters"]["unwarmed_serves"] == 0
    finally:
        eng.shutdown()


def test_engine_bad_quantize_mode_rejected():
    jnet, _ = _jmlp(seed=9, steps=1)
    eng = _engine(_port_of(jnet))
    try:
        with pytest.raises(ValueError, match="quantize"):
            eng.load(input_shape=(12,), quantize="int4")
    finally:
        eng.shutdown()
