"""Variational autoencoder layer (mirrors
``deeplearning4j_tpu/nn/layers/variational.py``).

An MLP encoder → Gaussian q(z|x) (mean, log-variance) → MLP decoder → a
Bernoulli or Gaussian reconstruction distribution.  In a network
``forward`` emits the q(z|x) mean; ``elbo_score`` (the negative ELBO) is
its layerwise pretraining objective, and ``reconstruction_log_probability``
the importance-weighted log p(x) used as an anomaly score.

The parameters nest as the reference's: ``enc`` and ``dec`` are LISTS of
``{W, b}`` dicts, beside ``z_mean``, ``z_logvar`` and ``out``; the
updaters, checkpoints and the weight bridge walk them as they walk any
tree.  The noise ε comes from ``regularizers.normal`` with the generator
the caller passes (the network's), one draw of the latent's shape per
sample, in sample order, so a test can feed both packages one stream.
The log(2π) terms are Python floats (no tensor made in the step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

from ...ops.activations import get_activation
from ...ops.initializers import init_weight
from ..conf import regularizers
from ..conf.inputs import InputType
from .base import ForwardOut, Layer, _any_device, register_layer

Tensor = torch.Tensor

_LOG_2PI = math.log(2 * math.pi)


@register_layer
@dataclasses.dataclass
class VariationalAutoencoder(Layer):
    n_in: int = 0
    n_out: int = 0                       # latent size (the reference's nOut = nLatent)
    encoder_layer_sizes: List[int] = dataclasses.field(default_factory=lambda: [256])
    decoder_layer_sizes: List[int] = dataclasses.field(default_factory=lambda: [256])
    activation: str = "leakyrelu"        # the hidden layers'
    pzx_activation: str = "identity"
    reconstruction: str = "bernoulli"    # or "gaussian"
    num_samples: int = 1

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.flat_size()

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def _dense(self, generator, a: int, b: int, dtype) -> Dict[str, Tensor]:
        return {"W": init_weight((a, b), self._winit(), a, b, dtype, generator),
                "b": torch.zeros((b,), dtype=dtype)}

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict:
        enc = [self.n_in] + list(self.encoder_layer_sizes)
        dec = [self.n_out] + list(self.decoder_layer_sizes)
        eh, dh = self.encoder_layer_sizes[-1], self.decoder_layer_sizes[-1]
        out = self.n_in * (2 if self.reconstruction == "gaussian" else 1)
        return {
            "enc": [self._dense(generator, a, b, dtype) for a, b in zip(enc[:-1], enc[1:])],
            "z_mean": self._dense(generator, eh, self.n_out, dtype),
            "z_logvar": self._dense(generator, eh, self.n_out, dtype),
            "dec": [self._dense(generator, a, b, dtype) for a, b in zip(dec[:-1], dec[1:])],
            "out": self._dense(generator, dh, out, dtype),
        }

    def regularization_score(self, params) -> Tensor:
        """l1·|W| + ½·l2·W² over every weight matrix of the tree."""
        dev = _any_device(params)
        ws = [params["z_mean"]["W"], params["z_logvar"]["W"], params["out"]["W"]] + [
            p["W"] for p in params["enc"] + params["dec"]]
        return super().regularization_score({f"W{i}": w for i, w in enumerate(ws)}).to(dev)

    @staticmethod
    def _affine(p, x: Tensor) -> Tensor:
        return x @ p["W"].to(x.dtype) + p["b"].to(x.dtype)

    def _mlp(self, layers, x: Tensor) -> Tensor:
        act = get_activation(self.activation)
        for p in layers:
            x = act(self._affine(p, x))
        return x

    def encode(self, params, x: Tensor):
        """q(z|x) → (mean, log-variance)."""
        h = self._mlp(params["enc"], x)
        mean = get_activation(self.pzx_activation)(self._affine(params["z_mean"], h))
        return mean, self._affine(params["z_logvar"], h)

    def decode(self, params, z: Tensor) -> Tensor:
        """The reconstruction distribution's pre-activations."""
        return self._affine(params["out"], self._mlp(params["dec"], z))

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        mean, _ = self.encode(params, x.reshape(x.shape[0], -1))
        return ForwardOut(mean, state, mask)

    @staticmethod
    def _eps(generator, mean: Tensor) -> Tensor:
        if generator is None:
            raise ValueError("the VAE's sampling needs a generator")
        return regularizers.normal(generator, mean.shape).to(mean.dtype)

    def _recon_log_lik(self, params, z: Tensor, x: Tensor) -> Tensor:
        """log p(x|z) per example."""
        out = self.decode(params, z)
        if self.reconstruction == "bernoulli":
            ll = -(torch.clamp_min(out, 0) - out * x + torch.log1p(torch.exp(-out.abs())))
            return torch.sum(ll, dim=-1)
        mu, lv = out[:, :self.n_in], out[:, self.n_in:]
        return torch.sum(-0.5 * (lv + _LOG_2PI + (x - mu) ** 2 / torch.exp(lv)), dim=-1)

    def elbo_score(self, params, x: Tensor, *, generator,
                   num_samples: Optional[int] = None) -> Tensor:
        """The negative ELBO (to minimize), mean over the batch."""
        x = x.reshape(x.shape[0], -1)
        mean, logvar = self.encode(params, x)
        lls = []
        for _ in range(num_samples or self.num_samples):
            z = mean + torch.exp(0.5 * logvar) * self._eps(generator, mean)
            lls.append(self._recon_log_lik(params, z, x))
        recon_ll = torch.mean(torch.stack(lls), dim=0)
        kl = -0.5 * torch.sum(1 + logvar - mean ** 2 - torch.exp(logvar), dim=-1)
        return torch.mean(kl - recon_ll)

    def reconstruction_score(self, params, x: Tensor, *, generator=None,
                             train: bool = False) -> Tensor:
        """The pretraining objective: ``elbo_score``."""
        return self.elbo_score(params, x, generator=generator)

    def generate(self, params, z: Tensor) -> Tensor:
        """The reconstruction distribution's parameters given latents (the
        reference's generateAtMeanGivenZ)."""
        out = self.decode(params, z)
        if self.reconstruction == "bernoulli":
            return torch.sigmoid(out)
        return out[:, :self.n_in]

    def reconstruction_log_probability(self, params, x: Tensor, *, generator,
                                       num_samples: int = 5) -> Tensor:
        """Importance-weighted log p(x) per example [mb] (IWAE, Burda et
        al. 2015): log (1/K) Σ_k p(x|z_k) p(z_k) / q(z_k|x), z_k ~ q(z|x).
        Higher is more probable."""
        x = x.reshape(x.shape[0], -1)
        mean, logvar = self.encode(params, x)
        lws = []
        for _ in range(num_samples):
            eps = self._eps(generator, mean)
            z = mean + torch.exp(0.5 * logvar) * eps
            log_pz = -0.5 * torch.sum(z ** 2 + _LOG_2PI, dim=-1)
            log_qzx = -0.5 * torch.sum(logvar + _LOG_2PI + eps ** 2, dim=-1)
            lws.append(self._recon_log_lik(params, z, x) + log_pz - log_qzx)
        return torch.logsumexp(torch.stack(lws), dim=0) - math.log(num_samples)

    def reconstruction_probability(self, params, x: Tensor, *, generator,
                                   num_samples: int = 5) -> Tensor:
        """exp of ``reconstruction_log_probability`` (underflows to 0 for
        high-dimensional data; prefer the log form)."""
        return torch.exp(self.reconstruction_log_probability(
            params, x, generator=generator, num_samples=num_samples))
