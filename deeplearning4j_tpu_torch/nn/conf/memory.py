"""Memory estimation reports (a copy of ``deeplearning4j_tpu/nn/conf/memory.py``
for a ``MultiLayerNetwork`` or a ``ComputationGraph``; the CLI's
``summary`` prints one).

Params, optimizer state, one gradient copy and activations are the terms
it prices, from the configuration and the parameters' shapes; it says
nothing of what the allocator really holds (``torch.cuda.max_memory_allocated``
does).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ...ops.dtypes import canonical_dtype
from ..updaters import tree_leaves


@dataclasses.dataclass
class LayerMemoryReport:
    """Per-layer estimate (reference LayerMemoryReport.Builder fields)."""

    name: str
    layer_type: str
    param_count: int
    param_bytes: int
    updater_state_bytes: int
    activation_elements_per_example: int
    activation_bytes_per_example: int


@dataclasses.dataclass
class NetworkMemoryReport:
    """Whole-model estimate (reference NetworkMemoryReport)."""

    layers: List[LayerMemoryReport]
    minibatch: int
    param_dtype: str
    compute_dtype: str

    @property
    def total_param_bytes(self) -> int:
        return sum(l.param_bytes for l in self.layers)

    @property
    def total_updater_bytes(self) -> int:
        return sum(l.updater_state_bytes for l in self.layers)

    @property
    def total_activation_bytes(self) -> int:
        return self.minibatch * sum(l.activation_bytes_per_example for l in self.layers)

    def total_bytes(self, training: bool = True) -> int:
        """Fixed + per-minibatch total; training adds one gradient copy of
        the params (the fused step's peak)."""
        fixed = self.total_param_bytes + (self.total_updater_bytes if training else 0)
        grad = self.total_param_bytes if training else 0
        return fixed + grad + self.total_activation_bytes

    def __str__(self) -> str:
        lines = [
            f"NetworkMemoryReport (mb={self.minibatch}, params={self.param_dtype}, "
            f"compute={self.compute_dtype})",
            f"{'layer':<24}{'type':<22}{'params':>12}{'param MB':>10}{'act KB/ex':>12}",
        ]
        for l in self.layers:
            lines.append(
                f"{l.name or '?':<24}{l.layer_type:<22}{l.param_count:>12,}"
                f"{l.param_bytes / 2**20:>10.2f}"
                f"{l.activation_bytes_per_example / 2**10:>12.1f}")
        lines.append(
            f"TOTAL train ≈ {self.total_bytes(True) / 2**20:.1f} MB "
            f"(params {self.total_param_bytes / 2**20:.1f} + updater "
            f"{self.total_updater_bytes / 2**20:.1f} + grads "
            f"{self.total_param_bytes / 2**20:.1f} + activations "
            f"{self.total_activation_bytes / 2**20:.1f})")
        return "\n".join(lines)


def _updater_state_bytes(updater, pcount: int, param_elem_bytes: int) -> int:
    """Optimizer-state footprint: copies × per-element size.  Narrow
    moment storage (Adam moment_dtype="bfloat16") halves the per-element
    size — the report must price what is actually allocated."""
    md = getattr(updater, "moment_dtype", None)
    if md is not None:
        param_elem_bytes = canonical_dtype(md).itemsize
    return pcount * param_elem_bytes * _updater_copies(updater)


def _updater_copies(updater) -> int:
    """Optimizer-state copies of the params (Adam/AdaMax/Nadam → 2,
    AMSGrad → 3 — m, v, AND the running max-v — momentum-family/AdaGrad/
    RmsProp → 1, Sgd/NoOp → 0)."""
    name = type(updater).__name__.lower()
    if name in ("adam", "adamax", "nadam"):
        return 2
    if name in ("amsgrad",):
        return 3
    if name in ("sgd", "noop"):
        return 0
    return 1


def _safe_elems(out_t) -> int:
    if out_t is None:
        return 0
    try:
        return out_t.flat_size()
    except ValueError:   # variable-length recurrent
        return out_t.size


def memory_report(net, minibatch: int = 32) -> NetworkMemoryReport:
    """Estimate memory for an initialized MultiLayerNetwork or
    ComputationGraph (reference getMemoryReport)."""
    conf = net.conf
    pbytes = canonical_dtype(conf.param_dtype).itemsize
    abytes = canonical_dtype(conf.compute_dtype).itemsize
    reports: List[LayerMemoryReport] = []
    if hasattr(conf, "vertices"):   # a ComputationGraph
        for spec in conf.vertices:
            pcount = sum(int(np.prod(a.shape)) for a in tree_leaves(net.params.get(spec.name, {})))
            layer = getattr(spec.vertex, "layer", None)
            upd = (layer.updater if layer is not None and layer.updater is not None
                   else conf.updater)
            act_elems = _safe_elems(net.vertex_out_types.get(spec.name))
            reports.append(LayerMemoryReport(
                name=spec.name,
                layer_type=type(layer if layer is not None else spec.vertex).__name__,
                param_count=pcount,
                param_bytes=pcount * pbytes,
                updater_state_bytes=_updater_state_bytes(upd, pcount, pbytes),
                activation_elements_per_example=act_elems,
                activation_bytes_per_example=act_elems * abytes,
            ))
        return NetworkMemoryReport(reports, minibatch, conf.param_dtype, conf.compute_dtype)
    for i, layer in enumerate(conf.layers):
        pcount = sum(int(np.prod(a.shape)) for a in tree_leaves(
            net.params[i] if i < len(net.params) else {}))
        out_t = layer.output_type(net.input_types[i]) if net.input_types else None
        act_elems = _safe_elems(out_t)
        upd = layer.updater if layer.updater is not None else conf.updater
        reports.append(LayerMemoryReport(
            name=layer.name or f"layer_{i}",
            layer_type=type(layer).__name__,
            param_count=pcount,
            param_bytes=pcount * pbytes,
            updater_state_bytes=_updater_state_bytes(upd, pcount, pbytes),
            activation_elements_per_example=act_elems,
            activation_bytes_per_example=act_elems * abytes,
        ))
    return NetworkMemoryReport(reports, minibatch, conf.param_dtype,
                               conf.compute_dtype)
