"""The port's conv-path layers against the JAX package's on the CPU: the 14
layer classes of ``nn/layers/convolution.py``, ``pooling.py`` and
``normalization.py`` (BatchNormalization, LocalResponseNormalization),
forward, input gradient and weight gradients, and the four convolutional
preprocessors.

Each case builds the reference layer, parses the port's from the
reference's JSON (``layer_to_dict`` → ``layer_from_dict``: the registry
holds every class), and feeds both the same seeded numpy input and
parameters (random, biases included); the gradients are those of
``sum(y · w)`` for a fixed random cotangent ``w``.

Tolerances: float32 forward 1e-5 and gradients 1e-4 (absolute; the same
ops summed in another order); bfloat16 compute within one bfloat16 spacing
relative (rtol 2^-7) plus one spacing at the reference output's largest
magnitude absolute, 2^-7 · max|y| (XLA may keep an intermediate in float32
where torch rounds each op to bfloat16, which moves an output by one
spacing of the intermediate, not of the output; for BatchNorm the
intermediate is the normalized x̂, so its spacing at max|x̂| counts too); BatchNorm's running
statistics 1e-6 after 3 steps in float32, one bfloat16 spacing in
bfloat16 compute (they are float32 means of bfloat16 activations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.layers.base import layer_to_dict
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import CONFIG_REGISTRY, layer_from_dict
from deeplearning4j_tpu_torch.utils.params import params_from_numpy

CNN = JInputType.convolutional
RNN = JInputType.recurrent
FF = JInputType.feed_forward
BF16_RTOL = 2.0 ** -7

# (id, reference class, kwargs, input type, minibatch)
CASES = [
    ("conv_truncate_s1_odd", jconv.Convolution2D, dict(n_out=4, kernel=(3, 3)), CNN(7, 7, 3), 2),
    ("conv_truncate_s2_even", jconv.Convolution2D,
     dict(n_out=4, kernel=(3, 3), stride=(2, 2)), CNN(8, 8, 3), 2),
    ("conv_same_s1_odd", jconv.Convolution2D,
     dict(n_out=4, kernel=(3, 3), convolution_mode="same"), CNN(7, 7, 3), 2),
    ("conv_same_s2_odd", jconv.Convolution2D,
     dict(n_out=4, kernel=(3, 3), stride=(2, 2), convolution_mode="same"), CNN(7, 7, 3), 2),
    ("conv_same_s2_even_asym", jconv.Convolution2D,
     dict(n_out=4, kernel=(3, 3), stride=(2, 2), convolution_mode="same"), CNN(8, 8, 3), 2),
    ("conv_same_7x7_s2_stem", jconv.Convolution2D,
     dict(n_out=5, kernel=(7, 7), stride=(2, 2), convolution_mode="same", has_bias=False),
     CNN(10, 10, 3), 2),
    ("conv_strict_s2_odd", jconv.Convolution2D,
     dict(n_out=4, kernel=(3, 3), stride=(2, 2), convolution_mode="strict"), CNN(7, 7, 2), 2),
    ("conv_dilation2_same_even", jconv.Convolution2D,
     dict(n_out=3, kernel=(3, 3), dilation=(2, 2), convolution_mode="same"), CNN(8, 8, 2), 2),
    ("conv_dilation2_truncate_odd", jconv.Convolution2D,
     dict(n_out=3, kernel=(3, 3), dilation=(2, 2)), CNN(9, 9, 2), 2),
    ("conv_rect_kernel_stride", jconv.Convolution2D,
     dict(n_out=3, kernel=(3, 2), stride=(2, 1), convolution_mode="same",
          activation="relu"), CNN(7, 6, 2), 2),
    ("conv1d_same_s1", jconv.Convolution1D, dict(n_out=4, kernel=3), RNN(3, 9), 2),
    ("conv1d_same_s2_even", jconv.Convolution1D,
     dict(n_out=4, kernel=4, stride=2), RNN(3, 10), 2),
    ("conv1d_truncate_dilation2", jconv.Convolution1D,
     dict(n_out=4, kernel=3, dilation=2, convolution_mode="truncate"), RNN(3, 11), 2),
    ("deconv_same_s1_odd", jconv.Deconvolution2D,
     dict(n_out=3, kernel=(3, 3), convolution_mode="same"), CNN(5, 5, 2), 2),
    ("deconv_same_s2_even", jconv.Deconvolution2D,
     dict(n_out=3, kernel=(3, 3), stride=(2, 2), convolution_mode="same"), CNN(4, 4, 2), 2),
    ("deconv_same_s2_k2", jconv.Deconvolution2D,
     dict(n_out=3, kernel=(2, 2), stride=(2, 2), convolution_mode="same"), CNN(5, 5, 2), 2),
    ("deconv_truncate_s1_even", jconv.Deconvolution2D,
     dict(n_out=3, kernel=(3, 3)), CNN(4, 4, 2), 2),
    ("deconv_truncate_s2_odd", jconv.Deconvolution2D,
     dict(n_out=3, kernel=(3, 3), stride=(2, 2)), CNN(5, 5, 2), 2),
    ("deconv_truncate_s2_dilation2", jconv.Deconvolution2D,
     dict(n_out=2, kernel=(3, 3), stride=(2, 2), dilation=(2, 2)), CNN(4, 5, 2), 2),
    ("sepconv_same_s2_dm2", jconv.SeparableConvolution2D,
     dict(n_out=4, kernel=(3, 3), stride=(2, 2), convolution_mode="same",
          depth_multiplier=2), CNN(8, 8, 3), 2),
    ("sepconv_truncate_s1_dm1", jconv.SeparableConvolution2D,
     dict(n_out=4, kernel=(3, 3)), CNN(7, 7, 3), 2),
    ("sepconv_dilation2_dm2", jconv.SeparableConvolution2D,
     dict(n_out=2, kernel=(3, 3), dilation=(2, 2), depth_multiplier=2,
          convolution_mode="same"), CNN(7, 7, 2), 2),
    ("zeropad2d", jconv.ZeroPadding2D, dict(padding=(1, 2, 0, 3)), CNN(4, 5, 2), 2),
    ("zeropad1d", jconv.ZeroPadding1D, dict(padding=(2, 1)), RNN(3, 5), 2),
    ("cropping2d", jconv.Cropping2D, dict(cropping=(1, 0, 2, 1)), CNN(6, 7, 2), 2),
    ("upsampling2d", jconv.Upsampling2D, dict(size=(2, 3)), CNN(3, 4, 2), 2),
    ("upsampling1d", jconv.Upsampling1D, dict(size=3), RNN(2, 4), 2),
    ("pool_max_truncate_s2_even", jpool.Subsampling2D, dict(pooling="max"), CNN(8, 8, 3), 2),
    ("pool_max_same_3x3_s2_even", jpool.Subsampling2D,
     dict(pooling="max", kernel=(3, 3), stride=(2, 2), convolution_mode="same"),
     CNN(8, 8, 3), 2),
    ("pool_max_same_3x3_s1_odd", jpool.Subsampling2D,
     dict(pooling="max", kernel=(3, 3), stride=(1, 1), convolution_mode="same"),
     CNN(7, 7, 3), 2),
    ("pool_avg_truncate_s2_odd", jpool.Subsampling2D,
     dict(pooling="avg", kernel=(3, 3), stride=(2, 2)), CNN(7, 7, 3), 2),
    ("pool_avg_same_s2_odd", jpool.Subsampling2D,
     dict(pooling="avg", kernel=(2, 2), stride=(2, 2), convolution_mode="same"),
     CNN(7, 7, 3), 2),
    ("pool_avg_same_3x3_s1_even", jpool.Subsampling2D,
     dict(pooling="avg", kernel=(3, 3), stride=(1, 1), convolution_mode="same"),
     CNN(6, 6, 2), 2),
    ("pool_sum_same_s2_even", jpool.Subsampling2D,
     dict(pooling="sum", kernel=(3, 3), stride=(2, 2), convolution_mode="same"),
     CNN(8, 8, 2), 2),
    ("pool_pnorm_truncate_s1", jpool.Subsampling2D,
     dict(pooling="pnorm", kernel=(2, 2), stride=(1, 1), pnorm=3), CNN(5, 5, 2), 2),
    ("pool1d_max_truncate", jpool.Subsampling1D, dict(pooling="max"), RNN(3, 8), 2),
    ("pool1d_avg_same_odd", jpool.Subsampling1D,
     dict(pooling="avg", kernel=3, stride=2, convolution_mode="same"), RNN(3, 7), 2),
    ("global_max_cnn", jpool.GlobalPooling, dict(pooling="max"), CNN(4, 5, 3), 2),
    ("global_avg_cnn", jpool.GlobalPooling, dict(pooling="avg"), CNN(4, 5, 3), 2),
    ("global_sum_rnn", jpool.GlobalPooling, dict(pooling="sum"), RNN(3, 6), 2),
    ("global_pnorm_rnn", jpool.GlobalPooling, dict(pooling="pnorm", pnorm=2), RNN(3, 6), 2),
    ("bn_cnn_inference", jnorm.BatchNormalization, dict(), CNN(4, 4, 3), 3),
    ("bn_ff_inference_locked", jnorm.BatchNormalization,
     dict(lock_gamma_beta=True, activation="relu"), FF(5), 4),
    ("lrn_default", jnorm.LocalResponseNormalization, dict(), CNN(3, 4, 7), 2),
    ("lrn_n3", jnorm.LocalResponseNormalization,
     dict(n=3, k=1.0, alpha=0.5, beta=0.5), CNN(3, 3, 4), 2),
]


def _build(jcls, kw, in_type, seed):
    """The reference layer (n_in inferred), its port parsed from its JSON,
    and random params/state as numpy trees."""
    jl = jcls(**kw)
    jl.infer_nin(in_type)
    tl = layer_from_dict(layer_to_dict(jl))
    assert type(tl).__name__ == jcls.__name__
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.normal(size=a.shape)).astype(np.float32),
        jl.init_params(jax.random.PRNGKey(seed), in_type))
    js = {k: (np.abs(rng.normal(size=v.shape)) + (0.5 if k == "var" else 0.0)).astype(np.float32)
          for k, v in jl.init_state(in_type).items()}
    return jl, tl, jp, js


def _shape(in_type, mb):
    return tuple(in_type.batch_shape(mb))


def _ref_forward_and_grads(jl, jp, js, x, w, train):
    def f(p, xx):
        out = jl.forward(p, {k: jnp.asarray(v) for k, v in js.items()}, xx, train=train)
        return jnp.sum(out.y * w), out
    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    return out, gp, gx


def _port_forward_and_grads(tl, jp, js, x, w, train):
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(jp, "cpu").items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tl.forward(p, params_from_numpy(js, "cpu"), xt, train=train)
    keys = sorted(p)
    grads = torch.autograd.grad((out.y * torch.from_numpy(np.asarray(w))).sum(),
                                [p[k] for k in keys] + [xt])
    return out, dict(zip(keys, grads[:-1])), grads[-1]


def test_the_registry_holds_the_fourteen_conv_path_layers():
    names = {"Convolution2D", "Convolution1D", "Deconvolution2D", "SeparableConvolution2D",
             "ZeroPadding2D", "ZeroPadding1D", "Cropping2D", "Upsampling2D", "Upsampling1D",
             "Subsampling2D", "Subsampling1D", "GlobalPooling", "BatchNormalization",
             "LocalResponseNormalization"}
    assert names <= set(CONFIG_REGISTRY)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_forward_and_gradients_match_the_reference(case):
    name, jcls, kw, in_type, mb = case
    jl, tl, jp, js = _build(jcls, kw, in_type, seed=len(name))
    rng = np.random.default_rng(7)
    x = rng.normal(size=_shape(in_type, mb)).astype(np.float32)
    out_type = jl.output_type(in_type)
    tout = tl.output_type(InputType.from_dict(in_type.to_dict()))
    assert tout.to_dict() == out_type.to_dict()
    jy = np.asarray(jl.forward(jax.tree_util.tree_map(jnp.asarray, jp), js, jnp.asarray(x)).y)
    assert jy.shape[1:] == tuple(out_type.batch_shape(mb))[1:] or out_type.kind == "rnn"
    w = rng.normal(size=jy.shape).astype(np.float32)
    jout, jgp, jgx = _ref_forward_and_grads(jl, jp, js, x, w, train=False)
    tout, tgp, tgx = _port_forward_and_grads(tl, jp, js, x, w, train=False)
    np.testing.assert_allclose(tout.y.detach().numpy(), np.asarray(jout.y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=0, atol=1e-4)
    assert sorted(tgp) == sorted(jgp)
    for k in tgp:
        np.testing.assert_allclose(tgp[k].numpy(), np.asarray(jgp[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_strict_mode_refuses_a_remainder():
    with pytest.raises(ValueError, match="Strict"):
        layer_from_dict(layer_to_dict(jconv.Convolution2D(
            n_out=2, kernel=(3, 3), stride=(2, 2), convolution_mode="strict"))).output_type(
            InputType.convolutional(8, 8, 1))


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_honours_an_rnn_mask(pooling):
    jl, tl, _, _ = _build(jpool.GlobalPooling, dict(pooling=pooling), RNN(3, 6), 0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 6, 3)).astype(np.float32)
    m = np.array([[1] * 6, [1] * 4 + [0] * 2, [1] + [0] * 5], np.float32)
    w = rng.normal(size=(3, 3)).astype(np.float32)

    def f(xx):
        out = jl.forward({}, {}, xx, mask=jnp.asarray(m))
        return jnp.sum(out.y * w), out
    (_, jout), jgx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tout = tl.forward({}, {}, xt, mask=torch.from_numpy(m))
    (tgx,) = torch.autograd.grad((tout.y * torch.from_numpy(w)).sum(), [xt])
    assert tout.mask is None and jout.mask is None
    np.testing.assert_allclose(tout.y.detach().numpy(), np.asarray(jout.y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=0, atol=1e-4)


def _bn_steps(jl, tl, jp, js, xs, compute):
    """Three training forwards of both layers, each step's new state fed to
    the next → (reference outputs, port outputs, reference states, port
    states)."""
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bfloat16" else torch.float32
    jstate = {k: jnp.asarray(v) for k, v in js.items()}
    tstate = params_from_numpy(js, "cpu")
    jys, tys, jss, tss = [], [], [], []
    for x in xs:
        jo = jl.forward(jax.tree_util.tree_map(jnp.asarray, jp), jstate,
                        jnp.asarray(x).astype(jdt), train=True)
        to = tl.forward(params_from_numpy(jp, "cpu"), tstate,
                        torch.from_numpy(x).to(tdt), train=True)
        jstate, tstate = jo.state, to.state
        jys.append(np.asarray(jo.y.astype(jnp.float32)))
        tys.append(to.y.float().numpy())
        jss.append({k: np.asarray(v) for k, v in jstate.items()})
        tss.append({k: v.numpy() for k, v in tstate.items()})
    return jys, tys, jss, tss


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_type", [CNN(4, 5, 3), FF(6)], ids=["cnn", "ff"])
def test_batchnorm_training_and_its_running_state_after_3_steps(compute, in_type):
    jl, tl, jp, js = _build(jnorm.BatchNormalization, dict(activation="relu"), in_type, 5)
    rng = np.random.default_rng(11)
    xs = [(2.0 * rng.normal(size=_shape(in_type, 4)) + 0.7).astype(np.float32)
          for _ in range(3)]
    jys, tys, jss, tss = _bn_steps(jl, tl, jp, js, xs, compute)
    for x, jy, ty, jst, tst in zip(xs, jys, tys, jss, tss):
        assert sorted(tst) == ["mean", "var"] and tst["var"].dtype == np.float32
        if compute == "float32":
            np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
            for k in tst:
                np.testing.assert_allclose(tst[k], jst[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            axes = tuple(range(x.ndim - 1))
            xhat = (x - x.mean(axis=axes)) / x.std(axis=axes)
            scale = max(float(np.abs(jy).max()), float(np.abs(xhat).max()))
            np.testing.assert_allclose(ty, jy, rtol=BF16_RTOL, atol=BF16_RTOL * scale)
            for k in tst:
                np.testing.assert_allclose(tst[k], jst[k], rtol=BF16_RTOL, atol=0, err_msg=k)


def test_batchnorm_training_gradients_flow_through_the_batch_statistics():
    jl, tl, jp, js = _build(jnorm.BatchNormalization, dict(), CNN(3, 3, 2), 9)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(4, 3, 3, 2)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jout, jgp, jgx = _ref_forward_and_grads(jl, jp, js, x, w, train=True)
    tout, tgp, tgx = _port_forward_and_grads(tl, jp, js, x, w, train=True)
    np.testing.assert_allclose(tout.y.detach().numpy(), np.asarray(jout.y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=0, atol=1e-4)
    for k in tgp:
        np.testing.assert_allclose(tgp[k].numpy(), np.asarray(jgp[k]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["conv_same_7x7_s2_stem", "pool_max_same_3x3_s2_even",
                                  "deconv_same_s2_even", "sepconv_same_s2_dm2", "lrn_default"])
def test_layers_in_bfloat16_compute_within_one_spacing(case):
    name, jcls, kw, in_type, mb = next(c for c in CASES if c[0] == case)
    jl, tl, jp, js = _build(jcls, kw, in_type, seed=len(name))
    x = np.random.default_rng(8).normal(size=_shape(in_type, mb)).astype(np.float32)
    jy = jl.forward(jax.tree_util.tree_map(jnp.asarray, jp), js,
                    jnp.asarray(x).astype(jnp.bfloat16)).y
    ty = tl.forward(params_from_numpy(jp, "cpu"), params_from_numpy(js, "cpu"),
                    torch.from_numpy(x).to(torch.bfloat16)).y
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    jy = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=BF16_RTOL,
                               atol=BF16_RTOL * float(np.abs(jy).max()))


PRE_CASES = [
    ("CnnToFeedForward", {}, CNN(3, 4, 2), (2, 3, 4, 2)),
    ("FeedForwardToCnn", dict(height=3, width=4, channels=2), FF(24), (2, 24)),
    ("CnnToRnn", {}, CNN(3, 4, 2), (2, 3, 4, 2)),
    ("RnnToCnn", dict(channels=2), RNN(8, 3), (2, 3, 8)),
]


@pytest.mark.parametrize("case", PRE_CASES, ids=[c[0] for c in PRE_CASES])
def test_convolutional_preprocessors_match_the_reference(case):
    name, kw, in_type, shape = case
    jp = getattr(jpre, name)(**kw)
    tp = getattr(tpre, name)(**kw)
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(tp.apply(torch.from_numpy(x)).numpy(),
                                  np.asarray(jp.apply(jnp.asarray(x))))
    assert (tp.output_type(InputType.from_dict(in_type.to_dict())).to_dict()
            == jp.output_type(in_type).to_dict())
