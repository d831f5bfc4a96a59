"""Weight-init schemes (mirrors ``deeplearning4j_tpu/ops/initializers.py``).

The formulas match the reference; the values match it only in
distribution, because torch's generator is not jax's threefry.  Draws
come from an explicit CPU ``torch.Generator`` so a seed gives the same
weights whatever device the network lives on.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


class WeightInit:
    """The scheme names ``init_weight`` takes (DL4J's ``WeightInit``)."""

    ZERO = "zero"
    ONES = "ones"
    NORMAL = "normal"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    IDENTITY = "identity"
    VAR_SCALING_NORMAL_FAN_IN = "var_scaling_normal_fan_in"
    VAR_SCALING_NORMAL_FAN_OUT = "var_scaling_normal_fan_out"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"
    VAR_SCALING_UNIFORM_FAN_IN = "var_scaling_uniform_fan_in"
    VAR_SCALING_UNIFORM_FAN_OUT = "var_scaling_uniform_fan_out"
    VAR_SCALING_UNIFORM_FAN_AVG = "var_scaling_uniform_fan_avg"


def draw_normal(shape, std: float, generator) -> torch.Tensor:
    """N(0, std²) of ``shape`` in float32 from ``generator``."""
    return torch.randn(shape, generator=generator) * std


def draw_uniform(shape, limit: float, generator) -> torch.Tensor:
    """U(-limit, limit) of ``shape`` in float32 from ``generator``."""
    return torch.rand(shape, generator=generator) * (2 * limit) - limit


def init_weight(shape: Sequence[int], scheme: str, fan_in: float,
                fan_out: float, dtype=torch.float32,
                generator: torch.Generator = None) -> torch.Tensor:
    """Sample a CPU weight tensor per the named scheme, with the
    reference's scale formulas (XAVIER = N(0, 2/(fan_in+fan_out)), the
    TransformerLM default; RELU = N(0, 2/fan_in); the ``var_scaling_*``
    schemes take fan_in, fan_out or their mean)."""
    scheme = scheme.lower()
    shape = tuple(int(s) for s in shape)
    fi, fo = max(fan_in, 1.0), max(fan_out, 1.0)

    def normal(std):
        return draw_normal(shape, std, generator).to(dtype)

    def uniform(limit):
        return draw_uniform(shape, limit, generator).to(dtype)

    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype)
    if scheme == "ones":
        return torch.ones(shape, dtype=dtype)
    if scheme == "normal":
        return normal(1.0 / math.sqrt(fi))
    if scheme == "uniform":
        return uniform(1.0 / math.sqrt(fi))
    if scheme == "xavier":
        return normal(math.sqrt(2.0 / (fi + fo)))
    if scheme == "xavier_uniform":
        return uniform(math.sqrt(6.0 / (fi + fo)))
    if scheme == "xavier_fan_in":
        return normal(math.sqrt(1.0 / fi))
    if scheme == "relu":
        return normal(math.sqrt(2.0 / fi))
    if scheme == "relu_uniform":
        return uniform(math.sqrt(6.0 / fi))
    if scheme == "sigmoid_uniform":
        return uniform(4.0 * math.sqrt(6.0 / (fi + fo)))
    if scheme == "lecun_normal":
        return normal(math.sqrt(1.0 / fi))
    if scheme == "lecun_uniform":
        return uniform(math.sqrt(3.0 / fi))
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError(f"IDENTITY init needs a square 2-D shape, got {shape}")
        return torch.eye(shape[0], dtype=dtype)
    if scheme.startswith("var_scaling"):
        fan = {"fan_in": fi, "fan_out": fo, "fan_avg": (fi + fo) / 2.0}[
            scheme.rsplit("_", 2)[-2] + "_" + scheme.rsplit("_", 2)[-1]]
        if "normal" in scheme:
            return normal(math.sqrt(1.0 / fan))
        return uniform(math.sqrt(3.0 / fan))
    raise ValueError(f"Unknown weight init scheme '{scheme}'")
