"""Bridges between numpy parameter trees and the port's parameters.

The JAX package keeps a network's parameters, and its optimizer state,
as lists of per-layer (nested) dicts; ``params_to_numpy`` of a port
network's ``params`` or ``opt_state`` and ``np.asarray`` over the JAX
tree give the same structure, so tests start both packages from
identical weights and Adam moments with these two functions.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.dtypes import leaf_to_tensor
from .device import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None, dtype=None) -> Any:
    """A (nested) list/dict tree of arrays → the same tree of tensors on
    ``device`` (default ``cuda``), optionally cast to ``dtype``.  A
    bfloat16 array (numpy's ``ml_dtypes`` extension type, as ``np.asarray``
    of a JAX bfloat16 leaf gives) becomes a bfloat16 tensor of the same
    bits."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        a = np.asarray(x)
        t = (leaf_to_tensor(a.view(np.uint16), bf16=True) if a.dtype.name == "bfloat16"
             else torch.from_numpy(np.array(a, copy=True)))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return conv(tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse: a tree of tensors → the same tree of numpy arrays
    (bfloat16 leaves widen to float32, which numpy can hold)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return conv(tree)
