"""LazyScore — a loss still on the device that reads as a float
(mirrors ``deeplearning4j_tpu/optimize/score.py``).

``fit_batch`` returns the step's loss as a 0-dim tensor on the device,
wrapped so a loop that chains steps never waits for the card: the value
is copied to the host the first time something reads it (``float``,
formatting, comparison, arithmetic), and cached.  ``materialize_scores``
reads many pending scores in one copy.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..obs import trace as obs_trace


def materialize_scores(scores) -> None:
    """Read every unread LazyScore in ``scores`` with one device copy."""
    lazy = [s for s in scores if isinstance(s, LazyScore) and not s.materialized]
    if not lazy:
        return
    # the batched device barrier (one copy for the whole epoch): the other
    # place a step's device time shows on the host timeline
    with obs_trace.span("train/device_sync", cat="train", n_scores=len(lazy)):
        vals = torch.stack([s._dev.detach().reshape(()).double()
                            for s in lazy]).cpu().tolist()
    for s, v in zip(lazy, vals):
        s._val = float(v)
        s._dev = None


class LazyScore:
    """Float-like view of a device scalar; syncs only on first read.
    ``device_value()`` hands back the unread tensor."""

    __slots__ = ("_dev", "_val")

    def __init__(self, device_scalar: torch.Tensor, value: Optional[float] = None):
        self._dev = device_scalar
        self._val = value

    def value(self) -> float:
        if self._val is None:
            # the host-device barrier of the step: the only blocking read
            # in a chained fit_batch loop (docs/OBSERVABILITY.md)
            with obs_trace.span("train/device_sync", cat="train"):
                self._val = float(self._dev)
            self._dev = None          # drop the device buffer once read
        return self._val

    def device_value(self):
        """The 0-dim tensor, or the cached float once read."""
        return self._dev if self._dev is not None else self._val

    @property
    def materialized(self) -> bool:
        return self._val is not None

    def __float__(self) -> float:
        return self.value()

    def __int__(self) -> int:
        return int(self.value())

    def __bool__(self) -> bool:
        return bool(self.value())

    def __round__(self, ndigits=None):
        return round(self.value(), ndigits)

    def __format__(self, spec: str) -> str:
        return format(self.value(), spec)

    def __repr__(self) -> str:
        return repr(self.value())

    def __str__(self) -> str:
        return str(self.value())

    def __hash__(self) -> int:
        return hash(self.value())

    def __array__(self, dtype=None, copy=None):
        import numpy as np
        return np.asarray(self.value(), dtype=dtype)

    @staticmethod
    def _coerce(other):
        return other.value() if isinstance(other, LazyScore) else other

    def __eq__(self, other):
        return self.value() == self._coerce(other)

    def __ne__(self, other):
        return self.value() != self._coerce(other)

    def __lt__(self, other):
        return self.value() < self._coerce(other)

    def __le__(self, other):
        return self.value() <= self._coerce(other)

    def __gt__(self, other):
        return self.value() > self._coerce(other)

    def __ge__(self, other):
        return self.value() >= self._coerce(other)

    def __add__(self, other):
        return self.value() + self._coerce(other)

    def __radd__(self, other):
        return self._coerce(other) + self.value()

    def __sub__(self, other):
        return self.value() - self._coerce(other)

    def __rsub__(self, other):
        return self._coerce(other) - self.value()

    def __mul__(self, other):
        return self.value() * self._coerce(other)

    def __rmul__(self, other):
        return self._coerce(other) * self.value()

    def __truediv__(self, other):
        return self.value() / self._coerce(other)

    def __rtruediv__(self, other):
        return self._coerce(other) / self.value()

    def __neg__(self):
        return -self.value()

    def __abs__(self):
        return abs(self.value())
