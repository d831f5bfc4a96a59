"""Layer base: config-as-data plus a plain forward function on tensors
(mirrors ``deeplearning4j_tpu/nn/layers/base.py``).

Each layer is a dataclass whose fields are the JSON hyperparameters; the
serde registry round-trips ``{"type": ClsName, ...}`` dicts exactly as
the reference writes them, so a reference ``configuration.json`` parses
unchanged.  Config types the port has not registered stay plain dicts and
are written back as read.

Parameters are per-layer dicts of tensors keyed as in the JAX trees
(``W``, ``b``, ``P``, ``ln1_g``, ...).  ``forward`` takes ``train`` and
``generator``, the network's ``torch.Generator`` in training (None
otherwise), where the reference takes ``rng``: a layer's input dropout
(``_maybe_dropout``) draws from it, and the container applies a layer's
weight noise (``nn/conf/regularizers.py``) before calling ``forward``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, NamedTuple, Optional

import torch

from ...ops.activations import get_activation
from ...ops.initializers import init_weight
from ..conf.inputs import InputType

Tensor = torch.Tensor

CONFIG_REGISTRY: Dict[str, type] = {}

#: a layer's state entry under this key is an auxiliary loss term: the
#: containers add it to the training loss (the reference's key)
AUX_LOSS_KEY = "__aux_loss__"


def register_config(cls):
    """Class decorator: make a dataclass JSON round-trippable by type name."""
    CONFIG_REGISTRY[cls.__name__] = cls
    return cls


register_layer = register_config


def config_to_dict(obj: Any) -> Any:
    """Recursively encode a registered dataclass to plain JSON types."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d: Dict[str, Any] = {"type": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = config_to_dict(getattr(obj, f.name))
        return d
    if isinstance(obj, (list, tuple)):
        return [config_to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: config_to_dict(v) for k, v in obj.items()}
    return obj


#: config types defined outside the eagerly imported nn tree — imported
#: on first deserialization so saved models load in fresh processes
_LAZY_CONFIG_PROVIDERS = {
    "TransformerBlock": "deeplearning4j_tpu_torch.models.transformer",
    "PositionalEmbedding": "deeplearning4j_tpu_torch.models.transformer",
    "MoE": "deeplearning4j_tpu_torch.parallel.moe",
}


def config_from_dict(d: Any) -> Any:
    """Inverse of :func:`config_to_dict`; unregistered types stay dicts."""
    if isinstance(d, dict) and d.get("type") in _LAZY_CONFIG_PROVIDERS \
            and d["type"] not in CONFIG_REGISTRY:
        import importlib

        importlib.import_module(_LAZY_CONFIG_PROVIDERS[d["type"]])
    if isinstance(d, dict) and d.get("type") in CONFIG_REGISTRY:
        cls = CONFIG_REGISTRY[d["type"]]
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: config_from_dict(v) for k, v in d.items()
                      if k in fields})
    if isinstance(d, dict):
        return {k: config_from_dict(v) for k, v in d.items()}
    if isinstance(d, list):
        return [config_from_dict(v) for v in d]
    return d


def layer_to_dict(layer: "Layer") -> dict:
    return config_to_dict(layer)


def layer_from_dict(d: dict) -> "Layer":
    out = config_from_dict(d)
    if not isinstance(out, Layer):
        raise ValueError(f"not a ported layer type: {d.get('type')!r} "
                         f"(ported: {sorted(k for k, c in CONFIG_REGISTRY.items() if issubclass(c, Layer))})")
    return out


class ForwardOut(NamedTuple):
    """Result of ``Layer.forward``: activations, non-trainable state, the
    per-timestep mask threaded through the stack, and the recurrent
    carry a layer emits when driven with one (TBPTT chunks, streaming)."""

    y: Tensor
    state: Dict[str, Tensor]
    mask: Optional[Tensor]
    carry: Any = None


def tree_apply(fn, tree):
    """``fn`` over every tensor of a nested dict / list tree, keys kept in
    their order."""
    if isinstance(tree, dict):
        return {k: tree_apply(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_apply(fn, v) for v in tree)
    return fn(tree)


def _any_device(tree) -> Optional[torch.device]:
    """The device of the first tensor of a nested dict / list tree."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = _any_device(v)
            if dev is not None:
                return dev
        return None
    return tree.device


@dataclasses.dataclass
class Layer:
    """Base hyperparameters shared by all layers — the reference's field
    set, so configurations round-trip.  ``l1``/``l2`` enter the training
    loss (``regularization_score``) and ``updater`` overrides the
    network's.  ``dropout`` is INPUT dropout in training: a float is the
    drop probability of classic inverted dropout, or a dropout config;
    ``weight_noise`` perturbs the weights in training; ``constraints``
    are applied after every update (``nn/conf/regularizers.py``)."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    bias_init: float = 0.0
    dropout: Any = 0.0
    l1: float = 0.0
    l2: float = 0.0
    updater: Optional[Any] = None
    trainable: bool = True
    weight_noise: Optional[Any] = None
    constraints: Optional[Any] = None

    #: expected input kind: None = any, else "ff" / "cnn" / "rnn"
    wants: ClassVar[Optional[str]] = None
    #: True for layers whose forward() takes a ``carry`` argument
    #: (LSTM, SimpleRnn): TBPTT chunking and streaming thread it
    recurrent: ClassVar[bool] = False

    def init_carry(self, mb: int, dtype=torch.float32, device=None):
        """Zero recurrent carry for batch size ``mb`` (None if stateless)."""
        return None

    def output_type(self, in_type: InputType) -> InputType:
        return in_type

    def infer_nin(self, in_type: InputType) -> None:
        """Fill n_in style fields from the incoming InputType."""

    def init_params(self, generator: torch.Generator, in_type: InputType,
                    dtype=torch.float32) -> Dict[str, Tensor]:
        return {}

    def init_state(self, in_type: InputType, dtype=torch.float32) -> Dict[str, Tensor]:
        return {}

    def forward(self, params: Dict[str, Tensor], state: Dict[str, Tensor],
                x: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                mask: Optional[Tensor] = None) -> ForwardOut:
        raise NotImplementedError

    def has_params(self) -> bool:
        return True

    def _maybe_dropout(self, x: Tensor, train: bool,
                       generator: Optional[torch.Generator]) -> Tensor:
        """The layer's input dropout in training, drawn from ``generator``."""
        d = self.dropout
        if not train or d is None or (isinstance(d, (int, float)) and d <= 0.0):
            return x
        if generator is None:
            raise ValueError(f"layer {self.name}: dropout requires a generator in training")
        from ..conf.regularizers import apply_dropout
        return apply_dropout(d, generator, x, train)

    def regularization_score(self, params: Dict[str, Tensor]) -> Tensor:
        """l1*|W| + 0.5*l2*W² over weight-class params (biases and
        normalization params excluded), in at least float32."""
        leaves = [v for k, v in params.items()
                  if k not in ("b", "beta", "gamma", "mean", "var")]
        if (self.l1 == 0.0 and self.l2 == 0.0) or not leaves:
            return torch.zeros((), dtype=torch.float32, device=_any_device(params))
        acc = torch.promote_types(torch.float32, leaves[0].dtype)
        score = torch.zeros((), dtype=acc, device=leaves[0].device)
        for v in leaves:
            va = v.to(acc)
            if self.l1:
                score = score + self.l1 * va.abs().sum()
            if self.l2:
                score = score + 0.5 * self.l2 * (va * va).sum()
        return score

    def _act(self, x: Tensor) -> Tensor:
        return get_activation(self.activation or "identity")(x)

    def _winit(self) -> str:
        return self.weight_init or "xavier"

    def _dense_init(self, generator, n_in: int, n_out: int, dtype) -> Dict[str, Tensor]:
        return {
            "W": init_weight((n_in, n_out), self._winit(), n_in, n_out,
                             dtype, generator),
            "b": torch.full((n_out,), float(self.bias_init), dtype=dtype),
        }
