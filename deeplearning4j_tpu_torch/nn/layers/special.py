"""Special wrappers (mirrors ``deeplearning4j_tpu/nn/layers/special.py``):
``FrozenLayer`` and ``CenterLossOutputLayer``.

``FrozenLayer`` runs its inner layer in inference mode (no dropout,
BatchNormalization on its running statistics, which stay as they are)
on DETACHED parameters, so autograd gives them a zero gradient, as the
reference's ``stop_gradient`` does.  They still pass through the updater
(K4's flat buffer included), so a carried ``updater.npz`` lines up; with
a fresh updater state the update is exactly zero.  It adds no
regularization term.  Its JSON nests the inner layer under ``layer``.

``CenterLossOutputLayer`` is a softmax head plus ½λ·‖x − c_y‖² (Wen et
al. 2016).  The per-class centres [C, n_in] are layer STATE, not
parameters: the containers call ``update_centers`` on the head's
detached input and labels in training and write the result as the
layer's new state (the reference's moving average with ``alpha``), so a
``fit_batches`` graph carries them as it carries BatchNorm's statistics.
Under a data-parallel trainer's dense path the class counts and sums are
taken over the global batch (``normalization.batch_sum``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ...ops.losses import get_loss, summed_per_example
from ..conf.inputs import InputType
from .base import ForwardOut, Layer, _any_device, register_layer, tree_apply
from .feedforward import Dense
from .normalization import batch_sum

Tensor = torch.Tensor


@register_layer
@dataclasses.dataclass
class FrozenLayer(Layer):
    layer: Optional[Layer] = None

    def infer_nin(self, in_type: InputType) -> None:
        self.layer.infer_nin(in_type)

    def output_type(self, in_type: InputType) -> InputType:
        return self.layer.output_type(in_type)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return self.layer.init_params(generator, in_type, dtype)

    def init_state(self, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return self.layer.init_state(in_type, dtype)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        return self.layer.forward(tree_apply(Tensor.detach, params), state, x, train=False,
                                  generator=generator, mask=mask)

    def regularization_score(self, params) -> Tensor:
        return torch.zeros((), dtype=torch.float32, device=_any_device(params))

    def has_params(self) -> bool:
        return self.layer.has_params()


@register_layer
@dataclasses.dataclass
class CenterLossOutputLayer(Dense):
    """Softmax + center loss; ``alpha`` is the centres' moving-average
    rate, ``lambda_`` the weight of the centre term."""

    loss: str = "mcxent"
    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_state(self, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return {"centers": torch.zeros((self.n_out, self.n_in), dtype=dtype)}

    def _center_sq(self, state, x, labels) -> Tensor:
        """‖x − c_y‖² per example [mb]."""
        assigned = labels.to(x.dtype) @ state["centers"].to(x.dtype)
        return torch.sum((x - assigned) ** 2, dim=-1)

    def score(self, params, state, x, labels, *, mask: Optional[Tensor] = None) -> Tensor:
        base = get_loss(self.loss)(labels, self._pre(params, x),
                                   self.activation or "identity", mask)
        return base + 0.5 * self.lambda_ * torch.mean(self._center_sq(state, x, labels))

    def score_examples(self, params, state, x, labels, *,
                       mask: Optional[Tensor] = None) -> Tensor:
        pe = summed_per_example(self.loss, labels, self._pre(params, x),
                                self.activation, mask)
        return pe + 0.5 * self.lambda_ * self._center_sq(state, x, labels)

    def update_centers(self, state, x, labels) -> Dict[str, Tensor]:
        """The moving-average centre update; a class absent from the batch
        keeps its centre."""
        centers = state["centers"]
        lab = labels.to(centers.dtype)
        counts = batch_sum(torch.sum(lab, dim=0))[:, None]                 # [C, 1]
        sums = batch_sum(lab.T @ x.to(centers.dtype))                      # [C, n_in]
        means = sums / torch.clamp_min(counts, 1.0)
        upd = torch.where(counts > 0, centers + self.alpha * (means - centers), centers)
        return {"centers": upd}
