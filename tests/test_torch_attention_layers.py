"""The port's ``LayerNorm``, ``SelfAttention`` and ``LearnedSelfAttention``
layers against the JAX package on the CPU.

The reference's ``kernel="flash"`` runs its Pallas kernels in interpret
mode on the CPU when T and S tile by 8, and ``mha`` otherwise; the port's
runs the flash kernels' plain PyTorch versions on CPU tensors (K1/K2/K3
on the card) at every length.  Cases: causal or not, with a [B, T] key
mask or without, T tiled (16) and ragged (13), and a batch row whose
every key is masked (its outputs are zeroed by the layer's output mask,
so the two conventions for such rows, zero gradients on the flash path
and mha's uniform weights, give the same result).

Tolerance: forward within 2e-5, every gradient within 2e-5 plus 1e-5 of
its size (f32; the attention sums run in another order, and a weight
gradient reaches 9 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers.feedforward import EmbeddingSequence as JEmb
from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.params import params_from_numpy

TOL = 2e-5
#: gradients also get 1e-5 of their size: a weight gradient here sums
#: B·T·T products and reaches 9 (f32 spacing 1e-6)
RTOL = 1e-5


def _check_layer(tl, jl, x, mask=None, in_type=None):
    """Forward and the gradients of sum(y * w) with respect to the input and
    every parameter, port against reference, from the reference's init."""
    rng = np.random.default_rng(21)
    jp = jl.init_params(jax.random.PRNGKey(3), in_type)
    jp = {k: jnp.asarray(0.4 * rng.normal(size=v.shape).astype(np.float32))
          for k, v in jp.items()}
    jm = None if mask is None else jnp.asarray(mask)
    jy = jl.forward(jp, {}, jnp.asarray(x), mask=jm).y
    w = rng.normal(size=jy.shape).astype(np.float32)
    jg, jgx = jax.grad(lambda p, xx: jnp.sum(jl.forward(p, {}, xx, mask=jm).y * w),
                       argnums=(0, 1))(jp, jnp.asarray(x))
    live = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu").items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    tm = None if mask is None else torch.from_numpy(mask)
    ty = tl.forward(live, {}, xt, mask=tm).y
    names = sorted(live)
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum(), [xt] + [live[k] for k in names])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=RTOL, atol=TOL)
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=RTOL, atol=TOL, err_msg=k)
    return ty.detach()


def test_layer_norm_matches_the_reference():
    x = np.random.default_rng(1).normal(size=(3, 5, 12)).astype(np.float32) * 3 + 1
    tl = tnorm.LayerNorm(activation="relu")
    jl = jnorm.LayerNorm(activation="relu")
    for l in (tl, jl):
        l.infer_nin(JInputType.recurrent(12))
    assert tl.n_features == 12
    _check_layer(tl, jl, x, in_type=JInputType.recurrent(12))


def _mask(b, t, seed, full_row):
    m = (np.random.default_rng(seed).random((b, t)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    if full_row:
        m[-1] = 0.0          # every key of the last row masked
    return m


CASES = [(causal, masked, t) for causal in (False, True) for masked in (False, True)
         for t in (16, 13)]


@pytest.mark.parametrize("causal,masked,t", CASES,
                         ids=[f"{'causal' if c else 'full'}-{'mask' if m else 'nomask'}-T{t}"
                              for c, m, t in CASES])
def test_self_attention_matches_the_reference(causal, masked, t):
    x = np.random.default_rng(2).normal(size=(3, t, 16)).astype(np.float32)
    mask = _mask(3, t, 4, full_row=True) if masked else None
    kw = dict(n_in=16, n_out=16, n_heads=4, causal=causal, activation="tanh")
    y = _check_layer(tatt.SelfAttention(**kw), jatt.SelfAttention(**kw), x, mask=mask)
    if masked:
        assert torch.all(y[torch.from_numpy(mask) == 0] == 0)


@pytest.mark.parametrize("kernel", ["flash", "xla"])
def test_self_attention_kernels_agree_and_project_out_off(kernel):
    x = np.random.default_rng(5).normal(size=(2, 8, 12)).astype(np.float32)
    kw = dict(n_in=12, n_out=12, n_heads=3, kernel=kernel, project_out=False)
    tl = tatt.SelfAttention(**kw)
    _check_layer(tl, jatt.SelfAttention(**kw), x, mask=_mask(2, 8, 6, False))
    assert sorted(tl.init_params(torch.Generator(), None)) == ["Wk", "Wq", "Wv"]
    with pytest.raises(ValueError, match="project_out=False"):
        tatt.SelfAttention(n_in=12, n_out=12, n_heads=3, head_dim=5,
                           project_out=False).init_params(torch.Generator(), None)


@pytest.mark.parametrize("t,masked", [(16, False), (13, False), (16, True)])
def test_learned_self_attention_matches_the_reference(t, masked):
    x = np.random.default_rng(7).normal(size=(2, t, 16)).astype(np.float32)
    kw = dict(n_in=16, n_out=16, n_heads=4, n_queries=3)
    tl = tatt.LearnedSelfAttention(**kw)
    y = _check_layer(tl, jatt.LearnedSelfAttention(**kw), x,
                     mask=_mask(2, t, 8, False) if masked else None)
    assert y.shape == (2, 3, 16)
    assert tl.output_type(JInputType.recurrent(16, t)).timesteps == 3
    with pytest.raises(ValueError, match="causal"):
        tatt.LearnedSelfAttention(causal=True, **kw).init_params(torch.Generator(), None)


def test_attention_network_trains_like_the_reference():
    """EmbeddingSequence → SelfAttention (causal, flash) → LayerNorm →
    RnnOutputLayer, the chip smoke's attention arm at a small width: two
    Adam steps with a key mask, then the output."""
    jconf = (JBuilder.builder().seed(4).updater(JAdam(lr=0.01))
             .layer(JEmb(n_in=20, n_out=16))
             .layer(jatt.SelfAttention(n_heads=4, causal=True))
             .layer(jnorm.LayerNorm())
             .layer(JRnnOut(n_out=20, activation="softmax", loss="mcxent"))
             .set_input_type(JInputType.recurrent(20, 16)).build())
    jnet = JNet(jconf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf.to_dict()), device="cpu")
    net.params = params_from_numpy([jax.tree_util.tree_map(np.asarray, p) for p in jnet.params],
                                   device="cpu")
    net.state = [{} for _ in net.params]
    net.opt_state = net.init_opt_state(net.params)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 20, (3, 17))
    mask = _mask(3, 16, 10, full_row=False)
    for _ in range(2):
        lt = float(net.fit_batch(DataSet(ids[:, :-1], ids[:, 1:], mask, mask)))
        lj = float(jnet.fit_batch(JDataSet(ids[:, :-1], ids[:, 1:], mask, mask)))
        assert abs(lt - lj) <= TOL
    for p, q in zip(net.params, jnet.params):
        for k in p:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(q[k]), rtol=0, atol=TOL,
                                       err_msg=k)
    np.testing.assert_allclose(net.output(ids[:, :-1], mask).numpy(),
                               np.asarray(jnet.output(ids[:, :-1], mask)), rtol=0, atol=TOL)
