"""YOLOv2 output layer (mirrors ``deeplearning4j_tpu/nn/layers/objdetect.py``).

The input is NHWC, [mb, H, W, B·(5 + C)]: per grid cell and anchor b the
box offsets (tx, ty, tw, th), the objectness logit and C class logits.
The loss is the reference's: λ_coord·((σ(txy) − t_xy)² + (√wh − √wh_t)²)
on the anchors an object is assigned to, (σ(conf) − 1)² there and
λ_noobj·σ(conf)² elsewhere, and per-anchor class cross-entropy on the
assigned anchors; summed per example, mean over the batch.

Labels are a dict (the reference's format):
  ``boxes`` [mb, H, W, B, 4]  target (tx, ty, tw, th) in cell coordinates
  ``obj``   [mb, H, W, B]     1 where an object is assigned to anchor b
  ``cls``   [mb, H, W, C]     one-hot class per cell

The anchors are a tensor made once per device, at the layer's first
score or decode there, and kept.  A step that made a tensor from host
data could not be captured as a CUDA graph; ``fit_batches`` runs its
steps eagerly once before it captures them, so a captured step finds the
anchors already made.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer

Tensor = torch.Tensor


@register_layer
@dataclasses.dataclass
class Yolo2OutputLayer(Layer):
    anchors: List[List[float]] = dataclasses.field(
        default_factory=lambda: [[1.0, 1.0], [2.0, 2.0]])
    n_classes: int = 20
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5

    def __post_init__(self):
        self._anchor_tensors: Dict[torch.device, Tensor] = {}

    def has_params(self) -> bool:
        return False

    def output_type(self, in_type: InputType) -> InputType:
        return in_type

    @property
    def n_boxes(self) -> int:
        return len(self.anchors)

    def _anchors(self, x: Tensor) -> Tensor:
        """The anchors [B, 2] in ``x``'s dtype, on its device."""
        if x.device not in self._anchor_tensors:
            self._anchor_tensors[x.device] = torch.tensor(self.anchors, dtype=torch.float64,
                                                          device=x.device)
        return self._anchor_tensors[x.device].to(x.dtype)

    def _split(self, x: Tensor):
        mb, h, w, _ = x.shape
        x = x.reshape(mb, h, w, self.n_boxes, 5 + self.n_classes)
        return (torch.sigmoid(x[..., 0:2]), x[..., 2:4], torch.sigmoid(x[..., 4]),
                x[..., 5:])

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        return ForwardOut(x, state, mask)

    def score(self, params, state, x, labels, *, mask: Optional[Tensor] = None) -> Tensor:
        txy, twh, conf, cls_logits = self._split(x)
        boxes, obj, cls = labels["boxes"], labels["obj"].to(x.dtype), labels["cls"]
        xy_loss = torch.sum(obj[..., None] * (txy - boxes[..., 0:2]) ** 2, dim=-1)
        anchors = self._anchors(x)
        pred_wh = torch.exp(torch.clamp(twh, -10, 10)) * anchors
        true_wh = torch.exp(torch.clamp(boxes[..., 2:4], -10, 10)) * anchors
        wh_loss = torch.sum(obj[..., None] * (torch.sqrt(pred_wh + 1e-8)
                                              - torch.sqrt(true_wh + 1e-8)) ** 2, dim=-1)
        coord = self.lambda_coord * (xy_loss + wh_loss)
        conf_loss = obj * (conf - 1.0) ** 2 + self.lambda_noobj * (1 - obj) * conf ** 2
        logp = torch.log_softmax(cls_logits, dim=-1)                    # [mb,h,w,B,C]
        cls_loss = -torch.sum(cls[..., None, :] * logp, dim=-1)         # [mb,h,w,B]
        per_cell = torch.sum(coord + conf_loss, dim=-1) + torch.sum(cls_loss * obj, dim=-1)
        return torch.mean(torch.sum(per_cell, dim=(1, 2)))

    def decode_predictions(self, x: Tensor, conf_threshold: float = 0.5) -> Dict[str, Tensor]:
        """Box centres and sizes as fractions of the image, confidences,
        class probabilities and the ``detect`` mask (the reference's
        vectorized ``getPredictedObjects``)."""
        txy, twh, conf, cls_logits = self._split(x)
        h, w = conf.shape[1:3]
        gy = torch.arange(h, dtype=x.dtype, device=x.device)[None, :, None, None]
        gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, :, None]
        wh = torch.exp(torch.clamp(twh, -10, 10)) * self._anchors(x)
        return {"cx": (txy[..., 0] + gx) / w, "cy": (txy[..., 1] + gy) / h,
                "w": wh[..., 0] / w, "h": wh[..., 1] / h,
                "conf": conf, "class_probs": torch.softmax(cls_logits, dim=-1),
                "detect": conf > conf_threshold}
