"""ComputationGraph — the arbitrary-DAG model container (mirrors
``deeplearning4j_tpu/nn/graph.py``: the vertices, ``VertexSpec``,
``ComputationGraphConfiguration`` and ``GraphBuilder``, and the runtime:
topological sort, type inference, ``init``, ``output``, ``score``,
``score_examples``, ``evaluate``, training through ``fit_batch`` / ``fit`` /
``fit_batches`` with standard backprop or TBPTT, layerwise pretraining,
listeners, streaming through ``rnn_time_step``, and checkpoints).

Parameters, layer state and updater state are dicts keyed by vertex name
(in ``conf.vertices`` order), each entry a per-layer dict of tensors keyed
as in the JAX trees (``{}`` for a vertex without parameters).  A step is
the reference's: the DAG evaluated in topological order, the output
layers' losses plus every layer's L1/L2, gradients by autograd, then per
vertex gradient normalization, the updater's ``apply`` and the layer's
constraints.  The update builds new tensors; BatchNormalization's new
running statistics replace the state after each step.  Dropout and
weight noise draw from the network's ``torch.Generator`` (on its device,
seeded with ``conf.seed``), vertex by vertex in topological order.  On
the card ``fit_batches`` is one CUDA graph of its k steps
(``nn/train_graph.py``).  Multi-input / multi-output training takes a
``MultiDataSet``; one input and one output work with a ``DataSet``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..datasets.dataset import DataSet, MultiDataSet
from ..datasets.iterators import DataSetIterator, ListDataSetIterator
from ..ops.dtypes import canonical_dtype
from ..optimize.score import LazyScore, materialize_scores
from ..utils.device import DeviceLike, resolve_device
from .conf.inputs import InputType
from .conf.regularizers import apply_constraints, maybe_weight_noise
from .layers.base import (AUX_LOSS_KEY, Layer, config_from_dict, config_to_dict,
                          register_config, tree_apply)
from .multilayer import (MultiLayerNetwork, _detached, _field_at, _host, _objective_and_grads,
                         _stack_field)
from .updaters import (Adam, GradientNormalization, Updater, normalize_gradients,
                       tree_leaves, tree_unflatten)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# graph vertices (non-layer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphVertex:
    """Base of the parameter-free DAG vertices."""

    def forward(self, inputs: List[Tensor], masks: List[Optional[Tensor]]) -> Tensor:
        raise NotImplementedError

    def output_type(self, in_types: List[InputType]) -> InputType:
        return in_types[0]

    def output_mask(self, masks: List[Optional[Tensor]]) -> Optional[Tensor]:
        for m in masks:
            if m is not None:
                return m
        return None


@register_config
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenation along the feature/channel (last) axis."""

    def forward(self, inputs, masks):
        return torch.cat(inputs, dim=-1)

    def output_type(self, in_types):
        t0 = in_types[0]
        if t0.kind == "cnn":
            return InputType.convolutional(t0.height, t0.width,
                                           sum(t.channels for t in in_types))
        if t0.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in in_types), t0.timesteps)
        return InputType.feed_forward(sum(t.size for t in in_types))


@register_config
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """add / subtract / product / average / max of equal-shape inputs."""

    op: str = "add"

    def forward(self, inputs, masks):
        if self.op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if self.op == "subtract":
            return inputs[0] - inputs[1]
        if self.op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if self.op == "average":
            return sum(inputs) / len(inputs)
        if self.op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"unknown ElementWise op {self.op}")


@register_config
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Features (or channels) ``from_idx`` to ``to_idx``, inclusive."""

    from_idx: int = 0
    to_idx: int = 0

    def forward(self, inputs, masks):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def output_type(self, in_types):
        n = self.to_idx - self.from_idx + 1
        t = in_types[0]
        if t.kind == "rnn":
            return InputType.recurrent(n, t.timesteps)
        if t.kind == "cnn":
            return InputType.convolutional(t.height, t.width, n)
        return InputType.feed_forward(n)


@register_config
@dataclasses.dataclass
class StackVertex(GraphVertex):
    """Concatenation along the batch axis."""

    def forward(self, inputs, masks):
        return torch.cat(inputs, dim=0)


@register_config
@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Slice ``index`` of ``stack_size`` equal parts of the batch axis."""

    index: int = 0
    stack_size: int = 1

    def forward(self, inputs, masks):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.index * step:(self.index + 1) * step]


@register_config
@dataclasses.dataclass
class ReshapeVertex(GraphVertex):
    """Reshape of the per-example dims, the batch axis kept."""

    shape: List[int] = dataclasses.field(default_factory=list)

    def forward(self, inputs, masks):
        return inputs[0].reshape((inputs[0].shape[0],) + tuple(self.shape))

    def output_type(self, in_types):
        if len(self.shape) == 1:
            return InputType.feed_forward(self.shape[0])
        if len(self.shape) == 3:
            return InputType.convolutional(*self.shape)
        if len(self.shape) == 2:
            return InputType.recurrent(self.shape[1], self.shape[0])
        return in_types[0]


@register_config
@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    factor: float = 1.0

    def forward(self, inputs, masks):
        return inputs[0] * self.factor


@register_config
@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def forward(self, inputs, masks):
        return inputs[0] + self.shift


@register_config
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """Each example divided by its L2 norm (at least ``eps``)."""

    eps: float = 1e-8

    def forward(self, inputs, masks):
        x = inputs[0]
        norm = torch.sqrt(torch.sum(x * x, dim=tuple(range(1, x.ndim)), keepdim=True))
        return x / torch.clamp_min(norm, self.eps)


@register_config
@dataclasses.dataclass
class L2Vertex(GraphVertex):
    """L2 distance between two inputs, per example → [mb, 1]."""

    eps: float = 1e-8

    def forward(self, inputs, masks):
        a, b = inputs[0], inputs[1]
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + self.eps)

    def output_type(self, in_types):
        return InputType.feed_forward(1)


@register_config
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """An input preprocessor as a vertex."""

    preprocessor: Any = None

    def forward(self, inputs, masks):
        return self.preprocessor.apply(inputs[0])

    def output_type(self, in_types):
        return self.preprocessor.output_type(in_types[0])


@register_config
@dataclasses.dataclass
class PoolHelperVertex(GraphVertex):
    """Drops the first row and column of a CNN activation."""

    def forward(self, inputs, masks):
        return inputs[0][:, 1:, 1:, :]

    def output_type(self, in_types):
        t = in_types[0]
        return InputType.convolutional(t.height - 1, t.width - 1, t.channels)


@register_config
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertex):
    """[mb, t, f] → [mb, f] at each example's last present step (its
    input's mask), or at the last step without a mask.  Clears the mask."""

    def forward(self, inputs, masks):
        x, m = inputs[0], masks[0]
        if m is not None:
            idx = torch.clamp_min(torch.sum(m.to(torch.int32), dim=1) - 1, 0)
            return x[torch.arange(x.shape[0], device=x.device), idx]
        return x[:, -1]

    def output_type(self, in_types):
        return InputType.feed_forward(in_types[0].size)

    def output_mask(self, masks):
        return None


@register_config
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[mb, f] → [mb, t, f], t and the mask taken from the second input."""

    def forward(self, inputs, masks):
        x, ref = inputs[0], inputs[1]
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[1])

    def output_type(self, in_types):
        return InputType.recurrent(in_types[0].size, in_types[1].timesteps)

    def output_mask(self, masks):
        return masks[1] if len(masks) > 1 else None


@register_config
@dataclasses.dataclass
class LayerVertex(GraphVertex):
    """A Layer as a DAG vertex."""

    layer: Optional[Layer] = None


# ---------------------------------------------------------------------------
# configuration + builder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VertexSpec:
    name: str
    vertex: Any              # LayerVertex or GraphVertex subclass
    inputs: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ComputationGraphConfiguration:
    """The DAG's configuration; ``to_dict`` / ``from_dict`` is the JSON a
    checkpoint's ``configuration.json`` carries, the reference's exactly."""

    network_inputs: List[str] = dataclasses.field(default_factory=list)
    input_types: Dict[str, InputType] = dataclasses.field(default_factory=dict)
    vertices: List[VertexSpec] = dataclasses.field(default_factory=list)
    network_outputs: List[str] = dataclasses.field(default_factory=list)
    updater: Updater = dataclasses.field(default_factory=Adam)
    gradient_normalization: str = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0
    seed: int = 12345
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    backprop_type: str = "standard"       # or "tbptt"
    tbptt_length: int = 20

    def to_dict(self) -> dict:
        return {
            "type": "ComputationGraphConfiguration",
            "network_inputs": list(self.network_inputs),
            "input_types": {k: v.to_dict() for k, v in self.input_types.items()},
            "vertices": [
                {"name": v.name, "vertex": config_to_dict(v.vertex), "inputs": list(v.inputs)}
                for v in self.vertices
            ],
            "network_outputs": list(self.network_outputs),
            "updater": config_to_dict(self.updater),
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold": self.gradient_normalization_threshold,
            "seed": self.seed,
            "param_dtype": self.param_dtype,
            "compute_dtype": self.compute_dtype,
            "backprop_type": self.backprop_type,
            "tbptt_length": self.tbptt_length,
        }

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        vertices = [VertexSpec(v["name"], config_from_dict(v["vertex"]), list(v["inputs"]))
                    for v in d["vertices"]]
        for v, raw in zip(vertices, d["vertices"]):
            vx = v.vertex
            if not isinstance(vx, GraphVertex) or (isinstance(vx, LayerVertex)
                                                    and not isinstance(vx.layer, Layer)):
                inner = raw["vertex"].get("layer", raw["vertex"])
                raise ValueError(f"vertex '{v.name}': type "
                                 f"{inner.get('type') if isinstance(inner, dict) else inner!r} "
                                 "is not ported yet")
        return ComputationGraphConfiguration(
            network_inputs=list(d["network_inputs"]),
            input_types={k: InputType.from_dict(v) for k, v in d["input_types"].items()},
            vertices=vertices,
            network_outputs=list(d["network_outputs"]),
            updater=config_from_dict(d["updater"]),
            gradient_normalization=d.get("gradient_normalization", GradientNormalization.NONE),
            gradient_normalization_threshold=d.get("gradient_normalization_threshold", 1.0),
            seed=d.get("seed", 12345),
            param_dtype=d.get("param_dtype", "float32"),
            compute_dtype=d.get("compute_dtype", "float32"),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_length=d.get("tbptt_length", 20),
        )


class GraphBuilder:
    """Fluent DAG builder."""

    def __init__(self):
        self._conf = ComputationGraphConfiguration()

    def seed(self, s: int) -> "GraphBuilder":
        self._conf.seed = s
        return self

    def updater(self, u: Updater) -> "GraphBuilder":
        self._conf.updater = u
        return self

    def gradient_normalization(self, mode: str, threshold: float = 1.0) -> "GraphBuilder":
        self._conf.gradient_normalization = mode
        self._conf.gradient_normalization_threshold = threshold
        return self

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_inputs.extend(names)
        return self

    def set_input_types(self, **types: InputType) -> "GraphBuilder":
        self._conf.input_types.update(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        self._conf.vertices.append(VertexSpec(name, LayerVertex(layer=layer), list(inputs)))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str) -> "GraphBuilder":
        self._conf.vertices.append(VertexSpec(name, vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_outputs.extend(names)
        return self

    def tbptt(self, length: int) -> "GraphBuilder":
        """Truncated BPTT over the time axis, ``length`` steps a chunk."""
        self._conf.backprop_type = "tbptt"
        self._conf.tbptt_length = length
        return self

    def build(self) -> ComputationGraphConfiguration:
        return self._conf


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------


def _layer_of(spec: VertexSpec) -> Optional[Layer]:
    return spec.vertex.layer if isinstance(spec.vertex, LayerVertex) else None


class ComputationGraph:
    """DAG model with the MultiLayerNetwork training surface, on one
    device (``cuda`` unless ``device="cpu"`` is passed)."""

    def __init__(self, conf: ComputationGraphConfiguration, device: DeviceLike = None):
        self.conf = conf
        self.device = resolve_device(device)
        for name in (conf.param_dtype, conf.compute_dtype):
            canonical_dtype(name)   # an unknown dtype name raises here
        self.params: Dict[str, Dict[str, Tensor]] = {}
        self.state: Dict[str, Dict[str, Tensor]] = {}
        self.opt_state: Dict[str, Dict] = {}
        self.iteration = 0
        self._it_dev: Optional[Tensor] = None
        self._it_dev_val = -1
        self.epoch = 0
        self.listeners: List[Any] = []
        self.grad_residual = None
        self._stream_carries: Optional[Dict[str, Any]] = None
        #: captured fit_batches graphs, by (k, batch shapes and dtypes)
        self._fit_graphs: Dict[tuple, Any] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(int(conf.seed))
        self._spec_by_name = {v.name: v for v in conf.vertices}
        self.topo_order = self._topological_sort()
        self.vertex_in_types: Dict[str, List[InputType]] = {}
        self.vertex_out_types: Dict[str, InputType] = {}
        self._infer_types()

    # the pieces of the training surface the two containers share
    _iter_tensor = MultiLayerNetwork._iter_tensor
    _as_tensor = MultiLayerNetwork._as_tensor
    _fire = MultiLayerNetwork._fire
    _end_epoch = MultiLayerNetwork._end_epoch
    set_listeners = MultiLayerNetwork.set_listeners
    add_listener = MultiLayerNetwork.add_listener
    fit_graph_count = MultiLayerNetwork.fit_graph_count

    def _compute_dtype(self) -> torch.dtype:
        return canonical_dtype(self.conf.compute_dtype)

    # -- structure ---------------------------------------------------------

    def _topological_sort(self) -> List[str]:
        """Kahn's sort of the vertex names, sources in name order."""
        spec_by_name = self._spec_by_name
        for s in self.conf.vertices:
            for inp in s.inputs:
                if inp not in spec_by_name and inp not in self.conf.network_inputs:
                    raise ValueError(f"vertex '{s.name}' references unknown input '{inp}'")
        indeg = {v.name: 0 for v in self.conf.vertices}
        dependents: Dict[str, List[str]] = {n: [] for n in indeg}
        for s in self.conf.vertices:
            for inp in s.inputs:
                if inp in spec_by_name:
                    indeg[s.name] += 1
                    dependents[inp].append(s.name)
        queue = [n for n, d in sorted(indeg.items()) if d == 0]
        seen = set(queue)
        result = []
        while queue:
            n = queue.pop(0)
            result.append(n)
            for dep in dependents[n]:
                indeg[dep] -= 1
                if indeg[dep] == 0 and dep not in seen:
                    seen.add(dep)
                    queue.append(dep)
        if len(result) != len(self.conf.vertices):
            cyc = set(indeg) - set(result)
            raise ValueError(f"graph has a cycle involving {sorted(cyc)}")
        return result

    def _spec(self, name: str) -> VertexSpec:
        return self._spec_by_name[name]

    def _infer_types(self) -> None:
        types: Dict[str, InputType] = dict(self.conf.input_types)
        if not types:
            return
        for name in self.topo_order:
            spec = self._spec(name)
            in_types = [types[i] for i in spec.inputs]
            self.vertex_in_types[name] = in_types
            layer = _layer_of(spec)
            if layer is not None:
                layer.infer_nin(in_types[0])
                types[name] = layer.output_type(in_types[0])
            else:
                types[name] = spec.vertex.output_type(in_types)
            self.vertex_out_types[name] = types[name]

    # -- init --------------------------------------------------------------

    def _updater_for(self, layer: Layer) -> Updater:
        return layer.updater if layer.updater is not None else self.conf.updater

    def _draw(self, generator: torch.Generator):
        """Per-vertex (params, state) dicts drawn from ``generator``, vertex
        by vertex in configuration order."""
        dtype = canonical_dtype(self.conf.param_dtype)
        params, state = {}, {}
        for spec in self.conf.vertices:
            layer = _layer_of(spec)
            if layer is None:
                params[spec.name], state[spec.name] = {}, {}
                continue
            t = self.vertex_in_types[spec.name][0]
            params[spec.name] = layer.init_params(generator, t, dtype)
            state[spec.name] = layer.init_state(t, dtype)
        return params, state

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw parameters from ``generator`` (default: a CPU generator
        seeded with ``conf.seed``) and move them to the device."""
        if not self.vertex_out_types:
            raise ValueError("set_input_types(...) required before init()")
        if generator is None:
            generator = torch.Generator().manual_seed(int(self.conf.seed))
        params, state = self._draw(generator)
        self.params = {n: tree_apply(lambda v: v.to(self.device), p) for n, p in params.items()}
        self.state = {n: tree_apply(lambda v: v.to(self.device), s) for n, s in state.items()}
        self.opt_state = self.init_opt_state(self.params)
        self.iteration = 0

    def init_opt_state(self, params) -> Dict[str, Dict]:
        """Fresh per-vertex updater state for ``params`` (zeros)."""
        out = {}
        for spec in self.conf.vertices:
            layer, p = _layer_of(spec), params[spec.name]
            out[spec.name] = self._updater_for(layer).init_state(p) if layer and p else {}
        return out

    def param_templates(self):
        """(params, state) with the structure and shapes ``init`` gives,
        as meta tensors: no weights are drawn (checkpoint loading)."""
        with torch.device("meta"):
            return self._draw(torch.Generator())

    def num_params(self) -> int:
        return sum(int(np.prod(x.shape)) for p in self.params.values() for x in tree_leaves(p))

    def summary(self) -> str:
        """Vertex table in topological order: name, type, inputs, params."""
        if not self.params:
            raise ValueError("call init() before summary()")
        rows = [("vertex", "type", "inputs", "params")]
        for name in self.topo_order:
            spec = self._spec(name)
            layer = _layer_of(spec)
            tname = type(layer).__name__ if layer is not None else type(spec.vertex).__name__
            n = sum(int(np.prod(x.shape)) for x in tree_leaves(self.params.get(name, {})))
            rows.append((name, tname, ",".join(spec.inputs) or "-", f"{n:,}"))
        widths = [max(len(r[c]) for r in rows) for c in range(4)]
        lines = ["  ".join(val.ljust(w) for val, w in zip(r, widths)) for r in rows]
        lines.insert(1, "-" * len(lines[0]))
        lines.append(f"total params: {self.num_params():,}")
        return "\n".join(lines)

    # -- forward / loss ----------------------------------------------------

    def _apply(self, params, state, inputs: Dict[str, Tensor], *, train: bool = False,
               generator: Optional[torch.Generator] = None,
               masks: Optional[Dict[str, Optional[Tensor]]] = None,
               stop_before_output_score: bool = False, carries=None):
        """Evaluate the DAG → (activations, new_state, masks, new_carries),
        dicts by vertex (and input) name.  With
        ``stop_before_output_score`` the output vertices are not applied
        (their ``score`` takes their input).  ``carries`` (name → carry)
        threads recurrent state through the recurrent layer vertices for
        TBPTT and streaming."""
        compute = self._compute_dtype()
        for spec in self.conf.vertices:
            layer = _layer_of(spec)
            if layer is not None:
                layer._compute_dtype = self.conf.compute_dtype
        acts: Dict[str, Tensor] = {}
        mks: Dict[str, Optional[Tensor]] = {}
        for k, v in inputs.items():
            acts[k] = v.to(compute) if v.is_floating_point() else v
            mks[k] = (masks or {}).get(k)
        new_state = dict(state)
        new_carries = dict(carries) if carries is not None else {}
        for name in self.topo_order:
            spec = self._spec(name)
            if stop_before_output_score and name in self.conf.network_outputs:
                continue
            xin = [acts[i] for i in spec.inputs]
            min_ = [mks[i] for i in spec.inputs]
            layer = _layer_of(spec)
            if layer is None:
                acts[name] = spec.vertex.forward(xin, min_)
                mks[name] = spec.vertex.output_mask(min_)
                continue
            kwargs = {}
            if layer.recurrent and carries is not None:
                kwargs["carry"] = carries.get(name)
            p_v = maybe_weight_noise(layer, params[name], train, generator)
            out = layer.forward(p_v, state[name], xin[0], train=train, generator=generator,
                                mask=min_[0], **kwargs)
            acts[name], mks[name] = out.y, out.mask
            new_state[name] = out.state
            if layer.recurrent and carries is not None:
                new_carries[name] = out.carry
        return acts, new_state, mks, new_carries

    def _reg_score(self, params, acc: torch.dtype) -> Tensor:
        total = torch.zeros((), dtype=acc, device=self.device)
        for spec in self.conf.vertices:
            layer = _layer_of(spec)
            if layer is not None and params[spec.name]:
                total = total + layer.regularization_score(params[spec.name]).to(acc)
        return total

    def _loss(self, params, state, inputs, labels, *, train: bool,
              generator: Optional[torch.Generator] = None, masks=None,
              label_masks=None, carries=None):
        """The output layers' losses plus every layer's L1/L2 (in float64
        when computing in float64, else float32) → (loss, new_state,
        new_carries).  In training a center-loss output's
        ``update_centers`` writes its new state, and the ``AUX_LOSS_KEY``
        term of any vertex's new state joins the loss."""
        acts, new_state, _, new_carries = self._apply(
            params, state, inputs, train=train, generator=generator, masks=masks,
            stop_before_output_score=True, carries=carries)
        acc = torch.float64 if self._compute_dtype() == torch.float64 else torch.float32
        total = torch.zeros((), dtype=acc, device=self.device)
        for out_name in self.conf.network_outputs:
            spec = self._spec(out_name)
            layer = spec.vertex.layer
            if not hasattr(layer, "score"):
                raise ValueError(f"output vertex '{out_name}' has no score()")
            h = acts[spec.inputs[0]]
            if train and generator is not None:
                h = layer._maybe_dropout(h, train, generator)
            lm = (label_masks or {}).get(out_name)
            total = total + layer.score(params[out_name], state[out_name], h,
                                        labels[out_name], mask=lm).to(acc)
            if train and hasattr(layer, "update_centers"):
                new_state[out_name] = layer.update_centers(
                    state[out_name], h.detach(), tree_apply(Tensor.detach, labels[out_name]))
        total = total + self._reg_score(params, acc)
        if train:
            for s in new_state.values():
                if AUX_LOSS_KEY in s:
                    total = total + s[AUX_LOSS_KEY].to(acc)
        return total, new_state, new_carries

    # -- batches -----------------------------------------------------------

    @staticmethod
    def _to_mds(ds) -> MultiDataSet:
        if isinstance(ds, MultiDataSet):
            return ds
        if isinstance(ds, DataSet):
            return MultiDataSet([ds.features], [ds.labels], [ds.features_mask],
                                [ds.labels_mask])
        raise TypeError(type(ds))

    def _named(self, names, values) -> Dict[str, Optional[Tensor]]:
        values = values or [None] * len(names)
        return {n: None if v is None else self._as_tensor(v) for n, v in zip(names, values)}

    def _tensors(self, mds: MultiDataSet):
        """(inputs, labels, masks, label masks), dicts of device tensors by
        input and output name."""
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        return (self._named(ins, mds.features), self._named(outs, mds.labels),
                self._named(ins, mds.features_masks), self._named(outs, mds.labels_masks))

    def _stacked(self, mdss: List[MultiDataSet]) -> Dict[str, Optional[Tensor]]:
        """Every input, label and mask of ``mdss`` stacked on a new leading
        axis on the device, keyed ``<field>/<name>`` (None where every
        batch has None); dict labels stack entry by entry, under
        ``labels/<name>/<entry>``."""
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        out: Dict[str, Optional[Tensor]] = {}
        for field, names, get in (
                ("features", ins, lambda m: m.features),
                ("labels", outs, lambda m: m.labels),
                ("features_masks", ins, lambda m: m.features_masks),
                ("labels_masks", outs, lambda m: m.labels_masks)):
            for i, name in enumerate(names):
                _stack_field(out, f"{field}/{name}",
                             [(get(m) or [None] * len(names))[i] for m in mdss],
                             self._as_tensor)
        return out

    def _batch_at(self, stacked: Dict[str, Optional[Tensor]], i: int) -> MultiDataSet:
        """Batch ``i`` of ``_stacked``'s output."""
        def pick(field, names):
            return [_field_at(stacked, f"{field}/{n}", i) for n in names]
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        return MultiDataSet(pick("features", ins), pick("labels", outs),
                            pick("features_masks", ins), pick("labels_masks", outs))

    # -- training ----------------------------------------------------------

    def _apply_updates(self, grads, params, opt_state, it: Tensor):
        """Per layer vertex: gradient normalization, the updater's
        ``apply`` (K4 for Adam/Nadam when ``DL4J_TPU_FUSED_UPDATE=1``), then
        the layer's constraints."""
        conf = self.conf
        new_params, new_opt = dict(params), dict(opt_state)
        for spec in conf.vertices:
            name, layer = spec.name, _layer_of(spec)
            if layer is None or not params[name]:
                continue
            g = grads[name]
            if conf.gradient_normalization != GradientNormalization.NONE:
                g = normalize_gradients(g, conf.gradient_normalization,
                                        conf.gradient_normalization_threshold)
            new_params[name], new_opt[name] = self._updater_for(layer).apply(
                params[name], g, opt_state[name], it)
            if layer.constraints:
                new_params[name] = apply_constraints(layer.constraints, new_params[name])
        return new_params, new_opt

    def _loss_and_grads(self, batch, carries=None, state_out: Optional[dict] = None):
        """The training loss on ``batch`` (a DataSet or MultiDataSet), its
        gradient with respect to every parameter (dicts shaped like
        ``params``) and the recurrent carries after it, detached.
        ``state_out`` receives the vertices' state after the forward,
        detached."""
        inputs, labels, masks, lmasks = self._tensors(self._to_mds(batch))
        live = {n: [t.detach().requires_grad_(True) for t in tree_leaves(p)]
                for n, p in self.params.items()}
        params = {n: tree_unflatten(p, live[n]) for n, p in self.params.items()}
        with torch.enable_grad():
            loss, new_state, new_carries = self._loss(
                params, self.state, inputs, labels, train=True, generator=self._gen,
                masks=masks, label_masks=lmasks, carries=carries)
            flat = [t for ls in live.values() for t in ls]
            gflat = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True) if flat else []
        grads, off = {}, 0
        for n, p in self.params.items():
            grads[n] = tree_unflatten(p, list(gflat[off:off + len(live[n])]))
            off += len(live[n])
        if state_out is not None:
            state_out.clear()
            state_out.update({n: {k: v.detach() for k, v in s.items()}
                              for n, s in new_state.items()})
        return loss.detach(), grads, {n: _detached(c) for n, c in new_carries.items()}

    def _step(self, batch, carries=None):
        """One optimizer step at the current iteration, which it advances
        → (loss, carries after it).  The state is replaced by the step's."""
        new_s: dict = {}
        loss, grads, carries = self._loss_and_grads(batch, carries, state_out=new_s)
        self._commit_step(grads, new_s)
        return loss, carries

    def _commit_step(self, grads, new_s: dict, ok: Optional[Tensor] = None,
                     apply_updates=None) -> None:
        """Apply ``grads`` at the current iteration, install the new
        parameters, updater state and vertex state ``new_s``, and advance
        the iteration (``MultiLayerNetwork._commit_step`` over vertex
        dicts).  Where the device flag ``ok`` is false the old trees are
        kept bitwise; ``apply_updates`` stands in for ``_apply_updates``
        (a tensor-parallel trainer's, over its slices)."""
        it = self._iter_tensor()
        with torch.no_grad():
            new_p, new_o = (apply_updates or self._apply_updates)(
                grads, self.params, self.opt_state, it)
            if ok is not None:
                sel = MultiLayerNetwork._select_tree
                new_p = {n: sel(ok, new_p[n], self.params[n]) for n in self.params}
                new_o = {n: sel(ok, new_o[n], self.opt_state[n]) for n in self.opt_state}
                new_s = {n: sel(ok, new_s[n], self.state[n]) for n in self.state}
            self.params, self.opt_state, self.state = new_p, new_o, new_s
            self._it_dev = it + 1
        self.iteration += 1
        self._it_dev_val = self.iteration

    def fit_batch(self, ds) -> LazyScore:
        """One optimization step on one minibatch (one per chunk under
        TBPTT) → the loss as a :class:`LazyScore`."""
        mds = self._to_mds(ds)
        if self.conf.backprop_type == "tbptt":
            return self._fit_batch_tbptt(mds)
        loss, _ = self._step(mds)
        score = LazyScore(loss)
        self._fire(self.iteration, score)
        return score

    def fit_batches(self, batches) -> List[LazyScore]:
        """k optimizer steps over same-shaped DataSets / MultiDataSets in
        one dispatch: on the card one CUDA graph of the k steps, captured
        at the first call for a given (k, shapes, dtypes) and replayed
        after; on the CPU the k steps eagerly.  TBPTT configurations and
        listeners with ``requires_model_state`` take one ``fit_batch`` per
        batch.  Without dropout or weight noise the losses, parameters,
        state and iteration match k ``fit_batch`` calls bitwise."""
        mdss = [self._to_mds(ds) for ds in batches]
        if not mdss:
            return []
        if self.conf.backprop_type == "tbptt" or any(
                getattr(l, "requires_model_state", False) for l in self.listeners):
            return [self.fit_batch(m) for m in mdss]
        n = len(mdss)
        stacked = self._stacked(mdss)
        if self.device.type == "cuda":
            from .train_graph import replay_steps
            losses = replay_steps(self, stacked, n)
        else:
            losses = torch.stack([self._step(self._batch_at(stacked, i))[0]
                                  for i in range(n)])
        scores = [LazyScore(losses[i]) for i in range(n)]
        for i, score in enumerate(scores):
            self._fire(self.iteration - n + i + 1, score)
        return scores

    def _init_carries(self, mb: int) -> Dict[str, Any]:
        """Zero carries of every recurrent layer vertex."""
        dtype = self._compute_dtype()
        carries: Dict[str, Any] = {}
        for spec in self.conf.vertices:
            layer = _layer_of(spec)
            if layer is not None and layer.recurrent:
                carries[spec.name] = layer.init_carry(mb, dtype, self.device)
        return carries

    def _fit_batch_tbptt(self, mds: MultiDataSet) -> LazyScore:
        """Truncated BPTT: one optimizer step per ``tbptt_length`` chunk of
        the time axis, recurrent state carried from chunk to chunk.  Only
        rank-3 inputs and labels carry the time axis (all the same T);
        rank-2 ones pass whole, and a mask is cut when it is [mb, T].  The
        score folds a ragged tail chunk in as (mean·n + tail) / (n + 1)."""
        feats = [self._as_tensor(f) for f in mds.features]
        labs = [None if l is None else self._as_tensor(l) for l in mds.labels]
        T = None
        for a in feats + [l for l in labs if l is not None]:
            if a.ndim == 3:
                if T is not None and a.shape[1] != T:
                    raise ValueError("TBPTT requires equal time lengths across "
                                     f"inputs/labels (got {a.shape[1]} vs {T})")
                T = a.shape[1]
        if T is None:
            raise ValueError("TBPTT requires at least one [mb, time, f] array")
        L = self.conf.tbptt_length
        n, tail = divmod(T, L)
        fmasks = [None if m is None else self._as_tensor(m)
                  for m in (mds.features_masks or [None] * len(feats))]
        lmasks = [None if m is None else self._as_tensor(m)
                  for m in (mds.labels_masks or [None] * len(labs))]

        def tslice(a, s):
            return None if a is None else (a[:, s:s + L] if a.ndim == 3 else a)

        def mslice(m, s):
            return None if m is None else (
                m[:, s:s + L] if m.ndim == 2 and m.shape[1] == T else m)

        carries = self._init_carries(feats[0].shape[0])
        losses = []
        for s in range(0, T, L):
            chunk = MultiDataSet([tslice(a, s) for a in feats], [tslice(a, s) for a in labs],
                                 [mslice(m, s) for m in fmasks], [mslice(m, s) for m in lmasks])
            loss, carries = self._step(chunk, carries)
            losses.append(loss)
            self._fire(self.iteration, LazyScore(loss))
        mean = torch.stack(losses[:n]).mean() if n else None
        if tail:
            mean = losses[-1] if mean is None else (mean * n + losses[-1]) / (n + 1)
        return LazyScore(mean)

    @staticmethod
    def _as_iterator(data):
        """A DataSetIterator, a DataSet / MultiDataSet or an ``(x, y)`` pair
        as an iterator; any other iterable of batches passes through."""
        if isinstance(data, DataSetIterator):
            return data
        if isinstance(data, (DataSet, MultiDataSet)):
            return ListDataSetIterator([data])
        if isinstance(data, tuple) and len(data) == 2:
            return ListDataSetIterator([DataSet(data[0], data[1])])
        if isinstance(data, (str, bytes)) or not hasattr(data, "__iter__"):
            raise TypeError(f"cannot iterate {type(data)}")
        return data

    def fit(self, data, epochs: int = 1) -> List[LazyScore]:
        """Train for ``epochs`` passes over ``data``; each epoch's scores
        are read in one device copy at its end."""
        it = self._as_iterator(data)
        if epochs > 1 and iter(it) is it:
            raise ValueError("fit(epochs > 1) needs data it can iterate again, "
                             "e.g. a list of DataSets, not a one-shot iterator")
        losses: List[LazyScore] = []
        synced = 0
        for _ in range(epochs):
            for ds in it:
                losses.append(self.fit_batch(ds))
            synced = self._end_epoch(losses, synced)
        return losses

    # -- layerwise unsupervised pretraining --------------------------------

    def pretrainable_layers(self) -> List[str]:
        """Names of the layer vertices with an unsupervised objective."""
        return [s.name for s in self.conf.vertices
                if _layer_of(s) is not None
                and (hasattr(s.vertex.layer, "contrastive_divergence")
                     or hasattr(s.vertex.layer, "reconstruction_score"))]

    def pretrain(self, data, epochs: int = 1) -> Dict[str, List[LazyScore]]:
        """Greedy layerwise pretraining of the pretrainable vertices in
        topological order; labels are ignored → {vertex name: losses}."""
        wanted = set(self.pretrainable_layers())
        return {n: self.pretrain_layer(n, data, epochs) for n in self.topo_order if n in wanted}

    def pretrain_layer(self, name: str, data, epochs: int = 1) -> List[LazyScore]:
        """Unsupervised pretraining of one layer vertex on its input from
        an inference pass of the DAG: CD-k for an RBM, the reconstruction
        loss for an AutoEncoder, the negative ELBO for a
        VariationalAutoencoder, through the layer's own updater with its
        own step counter from 0, gradient normalization and constraints."""
        spec = self._spec_by_name.get(name)
        if spec is None or _layer_of(spec) is None:
            raise ValueError(f"'{name}' is not a LayerVertex")
        layer = spec.vertex.layer
        is_rbm = hasattr(layer, "cd_gradients")
        if not is_rbm and not hasattr(layer, "reconstruction_score"):
            raise ValueError(f"vertex '{name}' ({type(layer).__name__}) has no "
                             "unsupervised objective (RBM / AutoEncoder / "
                             "VariationalAutoencoder)")
        updater = self._updater_for(layer)
        losses: List[LazyScore] = []
        it = 0
        for _ in range(epochs):
            for ds in self._as_iterator(data):
                inputs = self._named(self.conf.network_inputs, self._to_mds(ds).features)
                with torch.no_grad():
                    acts = self._apply(self.params, self.state, inputs,
                                       stop_before_output_score=True)[0]
                src = spec.inputs[0]
                feat = acts[src] if src in acts else inputs[src]
                p = self.params[name]
                if is_rbm:
                    with torch.no_grad():
                        g, loss = layer.cd_gradients(p, feat, self._gen)
                else:
                    loss, g = _objective_and_grads(layer, p, feat, self._gen)
                with torch.no_grad():
                    if self.conf.gradient_normalization != GradientNormalization.NONE:
                        g = normalize_gradients(g, self.conf.gradient_normalization,
                                                self.conf.gradient_normalization_threshold)
                    itf = torch.full((), float(it), dtype=torch.float32, device=self.device)
                    p2, self.opt_state[name] = updater.apply(p, g, self.opt_state[name], itf)
                    self.params[name] = apply_constraints(layer.constraints, p2)
                it += 1
                losses.append(LazyScore(loss))
        materialize_scores(losses)
        return losses

    # -- inference / scoring -----------------------------------------------

    def output(self, *features, masks=None) -> List[Tensor]:
        """Inference activations of every output vertex, in
        ``network_outputs`` order, tensors on the network's device."""
        inputs = self._named(self.conf.network_inputs, features)
        mks = self._named(self.conf.network_inputs, masks) if masks else None
        with torch.inference_mode():
            acts = self._apply(self.params, self.state, inputs, masks=mks)[0]
        return [acts[n] for n in self.conf.network_outputs]

    def rnn_time_step(self, *features) -> List[Tensor]:
        """Streaming inference keeping recurrent state across calls: a
        rank-2 input [mb, f] is one step, a rank-3 one streams its steps.
        One-step outputs squeeze their time axis when every input was one
        step.  A new batch size starts from zero state."""
        arrs, ranks = [], []
        for f in features:
            a = self._as_tensor(f)
            ranks.append(a.ndim)
            arrs.append(a[:, None, :] if a.ndim == 2 else a)
        squeeze = all(r == 2 for r in ranks)
        mb = arrs[0].shape[0]
        if self._stream_carries is not None:
            leaves = [t for c in self._stream_carries.values() if c is not None
                      for t in (c if isinstance(c, tuple) else (c,))]
            if leaves and leaves[0].shape[0] != mb:
                self._stream_carries = None
        if self._stream_carries is None:
            self._stream_carries = self._init_carries(mb)
        with torch.inference_mode():
            acts, _, _, self._stream_carries = self._apply(
                self.params, self.state, dict(zip(self.conf.network_inputs, arrs)),
                carries=self._stream_carries)
        outs = [acts[n] for n in self.conf.network_outputs]
        return [o[:, 0] if squeeze and o.ndim == 3 else o for o in outs]

    def rnn_clear_previous_state(self) -> None:
        """Forget the streaming state."""
        self._stream_carries = None

    def score(self, ds) -> float:
        """Loss on a batch (regularization included) without updating."""
        inputs, labels, masks, lmasks = self._tensors(self._to_mds(ds))
        with torch.no_grad():
            loss = self._loss(self.params, self.state, inputs, labels, train=False,
                              masks=masks, label_masks=lmasks)[0]
        return float(loss)

    def score_examples(self, ds, add_regularization_terms: bool = True) -> Tensor:
        """Per-example scores [N]: each output layer's unreduced loss,
        summed across outputs; a rank-3 output without a label mask takes
        its input's propagated mask; with ``add_regularization_terms`` the
        network's L1/L2 score is added to every example."""
        inputs, labels, masks, lmasks = self._tensors(self._to_mds(ds))
        with torch.no_grad():
            acts, _, mks, _ = self._apply(self.params, self.state, inputs, masks=masks,
                                          stop_before_output_score=True)
            pe = None
            for out_name in self.conf.network_outputs:
                spec = self._spec(out_name)
                layer = spec.vertex.layer
                if not hasattr(layer, "score_examples"):
                    raise ValueError(f"output vertex '{out_name}' "
                                     f"({type(layer).__name__}) has no score_examples()")
                y = labels[out_name]
                lmask = lmasks.get(out_name)
                if lmask is None and y is not None and y.ndim == 3:
                    lmask = mks.get(spec.inputs[0])
                s = layer.score_examples(self.params[out_name], self.state[out_name],
                                         acts[spec.inputs[0]], y, mask=lmask)
                pe = s if pe is None else pe + s
            if add_regularization_terms:
                pe = pe + self._reg_score(self.params, pe.dtype)
        return pe

    def evaluate(self, data, evaluation=None, output_index: int = 0):
        """Metrics of one output (``output_index``), masks honoured, in
        ``evaluation`` — an ``Evaluation`` by default, or any metric of
        ``evaluation/``, fed host arrays."""
        from ..evaluation.evaluation import Evaluation
        ev = evaluation if evaluation is not None else Evaluation()
        for ds in self._as_iterator(data):
            mds = self._to_mds(ds)
            outs = self.output(*mds.features, masks=mds.features_masks)
            lm = None if mds.labels_masks is None else mds.labels_masks[output_index]
            ev.eval(_host(mds.labels[output_index]), _host(outs[output_index]),
                    mask=None if lm is None else _host(lm))
        return ev

    # -- serde -------------------------------------------------------------

    def clone_params(self):
        """A copy of the parameter trees, tensors cloned."""
        return {n: tree_unflatten(p, [t.clone() for t in tree_leaves(p)])
                for n, p in self.params.items()}

    def clone_state(self):
        """A copy of the vertices' state (running statistics), cloned."""
        return {n: {k: v.clone() for k, v in s.items()} for n, s in self.state.items()}

    def save(self, path: str, save_updater: bool = True) -> None:
        from ..utils.serializer import save_model
        save_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device: DeviceLike = None) -> "ComputationGraph":
        from ..utils.serializer import load_model
        return load_model(path, load_updater=load_updater, device=device)
