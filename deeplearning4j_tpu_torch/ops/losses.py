"""Loss functions (mirrors ``deeplearning4j_tpu/ops/losses.py``).

Losses are functions of (labels, pre-activation output); gradients come
from autograd.  Softmax + MCXENT/NLL and sigmoid + XENT are computed in
log space, as in the reference.

Conventions (as in the reference):
  - per-example score = sum of per-element loss over the feature axis
  - network score = mean per-example score over the (masked) minibatch
  - integer labels with one axis fewer than the output are class
    indices.  For softmax + MCXENT/NLL the port gathers ``-logp[label]``
    instead of multiplying by a one-hot: the same value (the one-hot's
    other entries add exact zeros) without the [..., C] one-hot, which at
    a 50304-word vocabulary is the size of the logits.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .activations import get_activation

Tensor = torch.Tensor
_EPS = 1e-7


def _act_name(activation) -> str:
    return activation if isinstance(activation, str) else getattr(activation, "__name__", "")


def _is_sparse(labels: Tensor, preout: Tensor) -> bool:
    return not labels.is_floating_point() and labels.ndim == preout.ndim - 1


def _broadcast_mask(mask: Tensor, shape) -> Tensor:
    m = mask
    while m.ndim < len(shape):
        m = m[..., None]
    return m.expand(shape)


class Loss:
    """A loss = per-element function + reduction, with fused log-space
    paths for softmax + MCXENT/NLL and sigmoid + XENT."""

    def __init__(self, name: str, elementwise: Callable[[Tensor, Tensor], Tensor],
                 feature_mean: bool = False):
        self.name = name
        self._elementwise = elementwise
        # reference: LossMSE = LossL2 / nOut, LossMAE = LossL1 / nOut
        self._feature_mean = feature_mean

    def _softmax_xent(self, activation) -> bool:
        return (self.name in ("mcxent", "negativeloglikelihood")
                and _act_name(activation) == "softmax")

    def per_element(self, labels: Tensor, preout: Tensor, activation="identity") -> Tensor:
        if _is_sparse(labels, preout):
            labels = F.one_hot(labels.long(), preout.shape[-1]).to(preout.dtype)
        if self._softmax_xent(activation):
            return -labels * torch.log_softmax(preout, dim=-1)
        if self.name == "xent" and _act_name(activation) == "sigmoid":
            z, y = preout, labels
            return torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
        return self._elementwise(labels, get_activation(activation)(preout))

    def per_example(self, labels: Tensor, preout: Tensor, activation="identity",
                    mask: Optional[Tensor] = None) -> Tensor:
        if (_is_sparse(labels, preout) and self._softmax_xent(activation)
                and (mask is None or mask.ndim < preout.ndim)):
            s = -torch.log_softmax(preout, dim=-1).gather(
                -1, labels.long()[..., None])[..., 0]
            if mask is not None:
                s = s * _broadcast_mask(mask.to(s.dtype), s.shape)
            return s
        el = self.per_element(labels, preout, activation)
        if mask is not None:
            el = el * _broadcast_mask(mask.to(el.dtype), el.shape)
        s = el.sum(dim=-1)
        if self._feature_mean:
            s = s / el.shape[-1]
        return s

    def __call__(self, labels: Tensor, preout: Tensor, activation="identity",
                 mask: Optional[Tensor] = None) -> Tensor:
        """Reduce to the network score.  A mask of the per-example shape
        averages over present entries; a mask of the labels' shape weights
        outputs and averages over entries with any unmasked output."""
        pe = self.per_example(labels, preout, activation, mask)
        if mask is not None:
            if tuple(mask.shape) == tuple(pe.shape):
                present = mask.to(pe.dtype)
            elif tuple(mask.shape) == tuple(labels.shape):
                present = (mask.amax(dim=-1) > 0).to(pe.dtype)
            else:  # broadcastable per-example mask, e.g. [mb, 1]
                present = mask.reshape(mask.shape[:pe.ndim]).to(pe.dtype).expand(pe.shape)
            return pe.sum() / torch.clamp(present.sum(), min=1.0)
        return pe.mean()


def _mse(y, out):
    d = out - y
    return d * d


def _l1(y, out):
    return torch.abs(out - y)


def _xent(y, out):
    out = torch.clamp(out, _EPS, 1.0 - _EPS)
    return -(y * torch.log(out) + (1.0 - y) * torch.log1p(-out))


def _mcxent(y, out):
    return -y * torch.log(torch.clamp(out, _EPS, 1.0))


def _hinge(y, out):
    yy = torch.where(y > 0.5, 1.0, -1.0).to(out.dtype)
    return torch.clamp(1.0 - yy * out, min=0.0)


def _squared_hinge(y, out):
    h = _hinge(y, out)
    return h * h


def _kld(y, out):
    yc = torch.clamp(y, _EPS, 1.0)
    oc = torch.clamp(out, _EPS, 1.0)
    return yc * (torch.log(yc) - torch.log(oc))


def _poisson(y, out):
    return out - y * torch.log(torch.clamp(out, min=_EPS))


def _cosine_proximity(y, out):
    yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=_EPS)
    on = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=_EPS)
    return -(yn * on)


def _mape(y, out):
    return 100.0 * torch.abs((y - out) / torch.clamp(torch.abs(y), min=_EPS))


def _msle(y, out):
    d = (torch.log1p(torch.clamp(out, min=-1 + _EPS))
         - torch.log1p(torch.clamp(y, min=-1 + _EPS)))
    return d * d


_REGISTRY = {
    "mse": Loss("mse", _mse, feature_mean=True),
    "l2": Loss("l2", _mse),
    "l1": Loss("l1", _l1),
    "mae": Loss("mae", _l1, feature_mean=True),
    "xent": Loss("xent", _xent),
    "mcxent": Loss("mcxent", _mcxent),
    "negativeloglikelihood": Loss("negativeloglikelihood", _mcxent),
    "hinge": Loss("hinge", _hinge),
    "squared_hinge": Loss("squared_hinge", _squared_hinge),
    "kl_divergence": Loss("kl_divergence", _kld),
    "poisson": Loss("poisson", _poisson),
    "cosine_proximity": Loss("cosine_proximity", _cosine_proximity),
    "mape": Loss("mape", _mape),
    "msle": Loss("msle", _msle),
}


def get_loss(name) -> Loss:
    if isinstance(name, Loss):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def loss_names() -> list:
    return sorted(_REGISTRY)


def summed_per_example(loss_name, labels, preout, activation="identity",
                       mask=None) -> Tensor:
    """[mb] per-example scores: elementwise loss summed over features and
    any trailing time axis (the output layers' ``score_examples``)."""
    pe = get_loss(loss_name).per_example(labels, preout, activation or "identity", mask)
    return pe.sum(dim=tuple(range(1, pe.ndim))) if pe.ndim > 1 else pe


class _SparseXent(torch.autograd.Function):
    """The reference's ``sparse_softmax_xent`` custom VJP, optionally over
    a vocabulary split across the ranks of ``axis``."""

    @staticmethod
    def forward(ctx, logits, targets, n, axis, v0):
        from ..parallel.collectives import all_reduce, pmax

        v_local = logits.shape[-1]
        lmax = pmax(logits.amax(dim=-1), axis)                  # [...] in dtype
        sumexp = torch.exp((logits - lmax[..., None]).float()).sum(dim=-1)
        local = targets.long() - v0
        inside = (local >= 0) & (local < v_local)
        idx = torch.where(inside, local, torch.zeros_like(local))
        tgt = torch.gather(logits, -1, idx[..., None])[..., 0]
        tgt = torch.where(inside, tgt, torch.zeros_like(tgt))
        if axis is not None and axis.size > 1:
            sumexp = all_reduce(sumexp, axis)
            tgt = all_reduce(tgt, axis)                        # one rank's, exactly
        lse = lmax.float() + torch.log(sumexp)
        ctx.save_for_backward(logits, idx, inside, lse)
        ctx.n = n
        return (lse - tgt.float()).sum() / n

    @staticmethod
    def backward(ctx, g):
        logits, idx, inside, lse = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        onehot = torch.zeros_like(p).scatter_(-1, idx[..., None], inside[..., None].float())
        return ((p - onehot) * (g / ctx.n)).to(logits.dtype), None, None, None, None


def sparse_softmax_xent(logits: Tensor, targets: Tensor, n: Optional[int] = None,
                        axis=None, vocab_offset: int = 0) -> Tensor:
    """Mean token NLL of ``logits`` [..., V] for integer ``targets`` [...]
    without an f32 log-softmax over the vocabulary (the reference's op):
    the max and the target logit in the logits' dtype, the sum of exp and
    the log-sum-exp in f32; the backward rebuilds softmax − onehot from
    the saved LSE, in the logits' dtype.  ``n``: the count the sum is
    divided by (default this call's token count; a data- or
    sequence-parallel caller passes the global one and sums the ranks'
    losses).  ``axis`` (a ``parallel.collectives.Axis``): ``logits`` hold
    vocabulary columns ``vocab_offset .. vocab_offset + V_local - 1`` of
    a vocabulary split over the axis; the max and the sums are reduced
    over it and the loss is the whole vocabulary's."""
    n = targets.numel() if n is None else n
    return _SparseXent.apply(logits, targets, n, axis, vocab_offset)
