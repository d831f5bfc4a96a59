"""Activation functions selected by name on layer configs (mirrors
``deeplearning4j_tpu/ops/activations.py``: the whole registry, with the
parametric forms ``"leakyrelu(0.3)"`` and ``"elu(0.5)"``)."""

from __future__ import annotations

from typing import Callable, Dict, List, Union

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)


def leakyrelu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x: torch.Tensor) -> torch.Tensor:
    return torch.selu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation, and the reference
    # TransformerLM relies on that default
    return F.gelu(x, approximate="tanh")


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    # the reference's (DL4J's) 0.2·x + 0.5, not torch's x/6 + 0.5
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def hardtanh(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -1.0, 1.0)


def rationaltanh(x: torch.Tensor) -> torch.Tensor:
    # ND4J RationalTanh: 1.7159 · a rational approximation of tanh(2x/3)
    a = x * (2.0 / 3.0)
    tanh_a = torch.sign(a) * (1.0 - 1.0 / (1.0 + torch.abs(a) + a * a
                                           + 1.41645 * a * a * a * a))
    return 1.7159 * tanh_a


def rectifiedtanh(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.tanh(x), min=0.0)


def softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-off
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.abs(x) + 1)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def logsoftmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x, dim=-1)


def cube(x: torch.Tensor) -> torch.Tensor:
    return x * x * x


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(softplus(x))


_REGISTRY: Dict[str, Activation] = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softplus": softplus,
    "softsign": softsign,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "cube": cube,
    "swish": swish,
    "mish": mish,
}

#: activations that take a scalar through the "name(value)" form, which
#: keeps layer configs JSON round-trippable
_PARAMETRIC = {"leakyrelu", "elu"}


def get_activation(name: Union[str, Activation]) -> Activation:
    """Resolve an activation by name (case-insensitive).  Parametric
    forms: "leakyrelu(0.3)", "elu(0.5)"."""
    if callable(name):
        return name
    key = name.lower()
    if key.endswith(")") and "(" in key:
        base, _, arg = key.partition("(")
        if base in _PARAMETRIC:
            try:
                alpha = float(arg[:-1])
            except ValueError:
                raise ValueError(
                    f"Bad parametric activation '{name}': expected "
                    f"'{base}(<number>)', e.g. '{base}(0.3)'") from None
            fn = _REGISTRY[base]
            return lambda x: fn(x, alpha)
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def activation_names() -> List[str]:
    return sorted(_REGISTRY)
