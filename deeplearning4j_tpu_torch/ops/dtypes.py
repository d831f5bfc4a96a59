"""Dtype names as configuration JSON carries them, the dtype policy, and
the checkpoint's bfloat16 leaf scheme (mirrors
``deeplearning4j_tpu/ops/dtypes.py`` and the v2 rule of
``utils/serializer.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple, Union

import numpy as np
import torch

_BY_NAME = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int64": torch.int64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}

#: checkpoint entry-name suffix of a bfloat16 leaf stored as uint16 bits
#: (np.savez cannot round-trip bfloat16)
BF16_SUFFIX = "#bfloat16"


def canonical_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Resolve a torch dtype from its JSON name (``"float32"``, ...)."""
    if isinstance(name, torch.dtype):
        return name
    key = str(name).lower()
    if key.startswith("torch."):
        key = key[len("torch."):]
    if key not in _BY_NAME:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_BY_NAME)}")
    return _BY_NAME[key]


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Parameter, compute and output dtypes of a layer: ``param_dtype``
    stores the parameters (float32), ``compute_dtype`` runs activations
    and matmuls, ``output_dtype`` accumulates losses and metrics
    (float32)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.compute_dtype)

    def cast_to_param(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.param_dtype)

    def cast_to_output(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.output_dtype)


_DEFAULT = DTypePolicy()
_MIXED = DTypePolicy(compute_dtype=torch.bfloat16)


def default_policy() -> DTypePolicy:
    """Full precision (parity and tests)."""
    return _DEFAULT


def mixed_policy() -> DTypePolicy:
    """bfloat16 compute, float32 parameters and outputs."""
    return _MIXED


def tensor_to_leaf(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(entry-name suffix, numpy array) for one checkpoint leaf: bfloat16
    tensors become their raw bits viewed uint16 under ``#bfloat16``."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return BF16_SUFFIX, t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def leaf_to_tensor(a: np.ndarray, bf16: bool = False) -> torch.Tensor:
    """Inverse of :func:`tensor_to_leaf`.  A 0-d leaf stays 0-d
    (``np.ascontiguousarray`` alone makes it [1])."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))
    if bf16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under JAX's dtype promotion.  Where the reference
    multiplies an activation by a weight it leaves uncast (a bfloat16
    input against float32 parameters), JAX computes in the promoted dtype
    (float32), while ``torch.matmul`` raises on mixed dtypes: both
    operands go to ``torch.promote_types`` of the two.  Operands that
    already agree are used as they are."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)
