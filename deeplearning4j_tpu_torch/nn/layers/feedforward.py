"""Feed-forward layers (mirrors ``deeplearning4j_tpu/nn/layers/feedforward.py``:
``Dense``, ``OutputLayer``, ``LossLayer``, ``ActivationLayer``,
``DropoutLayer``, ``Embedding``, ``EmbeddingSequence``,
``ElementWiseMultiplication``, and the pretrainable ``AutoEncoder`` and
``RBM``).  The two pretrainable layers draw their corruption and Gibbs
samples through ``nn/conf/regularizers.bernoulli``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ...ops.initializers import init_weight
from ...ops.losses import get_loss, summed_per_example
from ..conf import regularizers
from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer

Tensor = torch.Tensor


@register_layer
@dataclasses.dataclass
class Dense(Layer):
    """Fully connected: y = act(x·W + b).  Recurrent inputs [mb, t, f] are
    handled time-distributed, as in the reference."""

    wants = "ff"

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size if in_type.kind in ("ff", "rnn") else in_type.flat_size()

    def output_type(self, in_type: InputType) -> InputType:
        if in_type.kind == "rnn":
            return InputType.recurrent(self.n_out, in_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        p = self._dense_init(generator, self.n_in, self.n_out, dtype)
        if not self.has_bias:
            del p["b"]
        return p

    def _pre(self, params, x: Tensor) -> Tensor:
        y = x @ params["W"].to(x.dtype)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return y

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        return ForwardOut(self._act(self._pre(params, x)), state, mask)


@register_layer
@dataclasses.dataclass
class OutputLayer(Dense):
    """Dense + loss head; ``loss`` names an ``ops.losses`` entry, fused
    with softmax/sigmoid in log space."""

    loss: str = "mcxent"

    def score(self, params, state, x, labels, *, mask: Optional[Tensor] = None) -> Tensor:
        return get_loss(self.loss)(labels, self._pre(params, x),
                                   self.activation or "identity", mask)

    def score_examples(self, params, state, x, labels, *,
                       mask: Optional[Tensor] = None) -> Tensor:
        """[mb] per-example scores (the loss summed over output features)."""
        return summed_per_example(self.loss, labels, self._pre(params, x),
                                  self.activation, mask)


@register_layer
@dataclasses.dataclass
class LossLayer(Layer):
    """Parameter-free loss head: the activation in ``forward``, the loss
    of the input in ``score``."""

    loss: str = "mse"

    def has_params(self) -> bool:
        return False

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        return ForwardOut(self._act(x), state, mask)

    def score(self, params, state, x, labels, *, mask: Optional[Tensor] = None) -> Tensor:
        return get_loss(self.loss)(labels, x, self.activation or "identity", mask)

    def score_examples(self, params, state, x, labels, *,
                       mask: Optional[Tensor] = None) -> Tensor:
        return summed_per_example(self.loss, labels, x, self.activation, mask)


@register_layer
@dataclasses.dataclass
class ActivationLayer(Layer):
    """The activation alone."""

    def has_params(self) -> bool:
        return False

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        return ForwardOut(self._act(x), state, mask)


@register_layer
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Standalone dropout: identity outside training."""

    def has_params(self) -> bool:
        return False

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        return ForwardOut(self._maybe_dropout(x, train, generator), state, mask)


@register_layer
@dataclasses.dataclass
class Embedding(Layer):
    """Index → vector lookup; input is int indices [mb] or [mb, 1]."""

    n_in: int = 0   # vocab size
    n_out: int = 0  # embedding dim
    has_bias: bool = True

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        p = self._dense_init(generator, self.n_in, self.n_out, dtype)
        if not self.has_bias:
            del p["b"]
        return p

    def _lookup(self, params, idx):
        y = params["W"][idx]
        if self.has_bias:
            y = y + params["b"]
        return self._act(y)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        idx = x.long()
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        return ForwardOut(self._lookup(params, idx), state, mask)


@register_layer
@dataclasses.dataclass
class EmbeddingSequence(Embedding):
    """Sequence of indices [mb, t] → [mb, t, n_out]."""

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, in_type.timesteps)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        return ForwardOut(self._lookup(params, x.long()), state, mask)


@register_layer
@dataclasses.dataclass
class ElementWiseMultiplication(Layer):
    """y = act(x ⊙ w + b)."""

    n_in: int = 0

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return {"W": torch.ones((self.n_in,), dtype=dtype),
                "b": torch.full((self.n_in,), float(self.bias_init), dtype=dtype)}

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        y = x * params["W"].to(x.dtype) + params["b"].to(x.dtype)
        return ForwardOut(self._act(y), state, mask)


@register_layer
@dataclasses.dataclass
class AutoEncoder(Layer):
    """Denoising autoencoder: params W, b (hidden) and vb (visible).
    ``forward`` gives the hidden code; ``reconstruction_score`` the
    pretraining loss of the corrupted input's reconstruction."""

    n_in: int = 0
    n_out: int = 0
    corruption_level: float = 0.3
    loss: str = "mse"

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return {
            "W": init_weight((self.n_in, self.n_out), self._winit(), self.n_in,
                             self.n_out, dtype, generator),
            "b": torch.full((self.n_out,), float(self.bias_init), dtype=dtype),
            "vb": torch.zeros((self.n_in,), dtype=dtype),
        }

    def encode(self, params, x):
        return self._act(x @ params["W"].to(x.dtype) + params["b"].to(x.dtype))

    def decode(self, params, h):
        return self._act(h @ params["W"].t().to(h.dtype) + params["vb"].to(h.dtype))

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        return ForwardOut(self.encode(params, x), state, mask)

    def reconstruction_score(self, params, x, *, generator=None, train=False) -> Tensor:
        xin = x
        if train and self.corruption_level > 0 and generator is not None:
            keep = regularizers.bernoulli(generator, 1.0 - self.corruption_level, x.shape)
            xin = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        recon = self.decode(params, self.encode(params, xin))
        return get_loss(self.loss)(x, recon, "identity")


@register_layer
@dataclasses.dataclass
class RBM(Layer):
    """Restricted Boltzmann machine, binary-binary by default: ``forward``
    is propUp (the hidden probabilities), and ``cd_gradients`` gives the
    CD-k statistics as gradients for the layer's own updater.  Params: W
    [n_in, n_out], hidden bias b, visible bias vb."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "sigmoid"
    k: int = 1                  # CD-k steps

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size if in_type.kind in ("ff", "rnn") else in_type.flat_size()

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return {
            "W": init_weight((self.n_in, self.n_out), self._winit(), self.n_in,
                             self.n_out, dtype, generator),
            "b": torch.zeros((self.n_out,), dtype=dtype),
            "vb": torch.zeros((self.n_in,), dtype=dtype),
        }

    def prop_up(self, params, v):
        """Hidden activation under the configured ``activation``."""
        return self._act(v @ params["W"].to(v.dtype) + params["b"].to(v.dtype))

    def prop_down(self, params, h):
        """Visible reconstruction: binary (sigmoid) visible units."""
        return torch.sigmoid(h @ params["W"].t().to(h.dtype) + params["vb"].to(h.dtype))

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        return ForwardOut(self.prop_up(params, x), state, mask)

    def cd_gradients(self, params, v0, generator):
        """CD-k statistics as a gradient dict (minimization convention) and
        the reconstruction error.  Needs sigmoid (binary) hidden units."""
        if (self.activation or "sigmoid") != "sigmoid":
            raise ValueError("contrastive divergence requires activation="
                             f"'sigmoid' (binary hidden units), got {self.activation!r}")
        h_prob = self.prop_up(params, v0)
        h_sample = regularizers.bernoulli(generator, h_prob, h_prob.shape).to(v0.dtype)
        v_neg, h_neg = v0, h_prob
        for _ in range(self.k):
            v_neg = self.prop_down(params, h_sample)
            h_neg = self.prop_up(params, v_neg)
            h_sample = regularizers.bernoulli(generator, h_neg, h_neg.shape).to(v0.dtype)
        mb = v0.shape[0]
        dW = (v0.t() @ h_prob - v_neg.t() @ h_neg) / mb
        db = torch.mean(h_prob - h_neg, dim=0)
        dvb = torch.mean(v0 - v_neg, dim=0)
        grads = {"W": -dW.to(params["W"].dtype), "b": -db.to(params["b"].dtype),
                 "vb": -dvb.to(params["vb"].dtype)}
        err = torch.mean(torch.sum((v0 - v_neg) ** 2, dim=1))
        return grads, err

    def contrastive_divergence(self, params, v0, generator, lr=0.1):
        """One plain-SGD CD-k update → (new_params, reconstruction_error)."""
        grads, err = self.cd_gradients(params, v0, generator)
        return {k: params[k] - lr * grads[k] for k in params}, err
