"""Int8 quantized serving matmul: per-channel symmetric weights, int32
accumulation, calibrated activation scales (mirrors
``deeplearning4j_tpu/ops/quantize.py``, operation for operation).

  weights      per output channel, symmetric: ``q[:, j] = round(W[:, j] /
               s_j)`` with ``s_j = max|W[:, j]| / 127``, int8 in
               [-127, 127], no zero points.
  activations  per tensor, symmetric, the scale from a calibration pass
               that runs representative inputs through the float model and
               records each matmul's incoming ``max|x|``.
  accumulate   int8 x int8 → int32 (``torch._int_mm``), dequantized once:
               ``y = acc · (s_x · s_j)`` in float32, then cast to the
               input's dtype.  Rounding is half to even (``torch.round``).

The injection is duck-typed, not a layer rewrite: an ``Int8Weight``
replaces a Dense-style ``W`` leaf in the params tree.  ``Dense`` computes
``x @ params["W"].to(x.dtype)``; ``Int8Weight.to(dtype)`` returns itself
and ``x @ w`` lands in ``__rmatmul__`` (a tensor's ``__matmul__`` gives
way to an operand it does not know).  Layers that use their ``W`` any
other way keep the float leaf: calibration quantizes only the weights it
saw in a matmul.  The reference's calibration stand-in has no indexing,
so its calibration raises on a network whose 2-D ``W`` is gathered from
(``EmbeddingSequence``); the port's stand-in passes an index through
unrecorded, so a TransformerLM quantizes its head and keeps its
embedding in float.

``torch._int_mm`` takes 2-D operands, and on a card it refuses fewer
than 17 rows and a K or N that is not a multiple of 8.  So the leading
dimensions of ``x`` are flattened, the weight is zero-padded to K and N
multiples of 8 once at quantization, and each call pads the activation's
rows and columns with zeros and slices the product back: exact, since a
zero product adds nothing to an int32 sum.  The padding runs on every
device, so the CPU runs the code the card runs.  Nothing in the product
syncs the host, so it captures into a CUDA graph; calibration reads
``float(max|x|)`` per matmul and runs eagerly, before any capture.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Int8Weight", "quantize_weight", "calibrate", "quantize_params",
           "quantize_model", "QuantizedModel"]

#: ``torch._int_mm``'s CUDA path: K and N multiples of this, M above MIN_ROWS
_ALIGN = 8
_MIN_ROWS = 16


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Int8Weight:
    """A quantized stand-in for a 2-D float weight leaf.

    ``values`` int8 [in, out] (a view of ``padded``, the same values
    zero-padded to multiples of 8 for ``torch._int_mm``); ``scales``
    float32 [out] (per-output-channel weight scales, amax/127);
    ``act_scale`` float32 [] (the per-tensor activation scale, calibrated
    amax/127)."""

    __slots__ = ("padded", "values", "scales", "act_scale")

    def __init__(self, padded: torch.Tensor, shape: Tuple[int, int],
                 scales: torch.Tensor, act_scale: torch.Tensor):
        self.padded = padded
        self.values = padded[:shape[0], :shape[1]]
        self.scales = scales
        self.act_scale = act_scale

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return torch.int8

    @property
    def device(self) -> torch.device:
        return self.padded.device

    def to(self, target) -> "Int8Weight":
        """``to(dtype)`` is the identity (the layer casts its weight to the
        activation's dtype; the quantized product casts its output
        instead); ``to(device)`` moves the three tensors."""
        if isinstance(target, torch.dtype):
            return self
        device = torch.device(target)
        if device == self.padded.device:
            return self
        return Int8Weight(self.padded.to(device), tuple(self.values.shape),
                          self.scales.to(device), self.act_scale.to(device))

    def dequantize(self) -> torch.Tensor:
        """The float32 reconstruction, values · scales."""
        return self.values.to(torch.float32) * self.scales[None, :]

    def int_mm(self, xq: torch.Tensor) -> torch.Tensor:
        """int8 [..., K] @ values → int32 [..., N] through ``torch._int_mm``
        on zero-padded 2-D operands."""
        k, n = self.values.shape
        lead = xq.shape[:-1]
        x2 = xq.reshape(-1, k)
        m = x2.shape[0]
        kp, _ = self.padded.shape
        mp = max(_round_up(m, _ALIGN), _round_up(_MIN_ROWS + 1, _ALIGN))
        x2 = F.pad(x2, (0, kp - k, 0, mp - m))
        acc = torch._int_mm(x2, self.padded)
        return acc[:m, :n].reshape(*lead, n)

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """The activation in int8 at the calibrated scale (saturating)."""
        xq = torch.clamp(torch.round(x.to(torch.float32) / self.act_scale), -127.0, 127.0)
        return xq.to(torch.int8)

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ w``: quantize the activation with the calibrated scale,
        int8 product with int32 accumulation, dequantize once."""
        acc = self.int_mm(self.quantize_input(x))
        # int32 * float32 promotes: each sum converts to float32 and is
        # scaled in one pass, the same rounding as a cast then a multiply
        y = acc * (self.act_scale * self.scales)
        return y.to(x.dtype)


def quantize_weight(w: torch.Tensor, act_amax: float) -> Int8Weight:
    """Per-output-channel symmetric int8 quantization of a 2-D float
    weight; ``act_amax`` is the calibrated max|x| of the activations
    feeding this matmul.  An all-zero channel gets scale 1 (its values
    are zero anyway), as does a zero ``act_amax`` (a dead input)."""
    w = w.detach().to(torch.float32)
    amax = torch.amax(torch.abs(w), dim=0)
    # a tensor divisor: by a Python scalar the card multiplies by its
    # reciprocal, one rounding away from the reference's quotient
    scales = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                         torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scales[None, :]), -127, 127).to(torch.int8)
    k, n = q.shape
    padded = F.pad(q, (0, _round_up(n, _ALIGN) - n, 0, _round_up(k, _ALIGN) - k))
    act_scale = torch.tensor(act_amax / 127.0 if act_amax > 0 else 1.0,
                             dtype=torch.float32, device=w.device)
    return Int8Weight(padded, (k, n), scales, act_scale)


class _CalibWeight:
    """Calibration stand-in: passes the float product through unchanged
    while recording the max|x| of every activation that meets this weight
    in a matmul.  An index passes through unrecorded.  Eager only (a host
    read per product)."""

    __slots__ = ("w", "stats", "key")

    def __init__(self, w: torch.Tensor, stats: Dict[Any, float], key):
        self.w = w
        self.stats = stats
        self.key = key

    @property
    def shape(self):
        return self.w.shape

    @property
    def ndim(self):
        return self.w.ndim

    @property
    def dtype(self):
        return self.w.dtype

    def to(self, target) -> "_CalibWeight":
        return _CalibWeight(self.w.to(target), self.stats, self.key)

    def __getitem__(self, idx):
        return self.w[idx]

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        amax = float(torch.amax(torch.abs(x.to(torch.float32))))
        self.stats[self.key] = max(self.stats.get(self.key, 0.0), amax)
        return x @ self.w


Path = Tuple[Any, ...]


def _leaves(tree, path: Path = ()):
    """(path, leaf) of a params tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _weight_paths(params) -> List[Path]:
    """Paths of the quantization candidates: 2-D floating leaves whose dict
    key is ``W`` (the Dense/OutputLayer matmul weight)."""
    return [p for p, leaf in _leaves(params)
            if p and p[-1] == "W" and isinstance(leaf, torch.Tensor)
            and leaf.ndim == 2 and leaf.is_floating_point()]


def _tree_replace(tree, repl: Dict[Path, Any], path: Path = ()):
    """The tree rebuilt with ``repl[path]`` at those paths."""
    if path in repl:
        return repl[path]
    if isinstance(tree, dict):
        return {k: _tree_replace(v, repl, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_replace(v, repl, path + (i,)) for i, v in enumerate(tree))
    return tree


def _get_path(tree, path: Path):
    for p in path:
        tree = tree[p]
    return tree


def _model_device(model) -> torch.device:
    for _, leaf in _leaves(model.params):
        if isinstance(leaf, (torch.Tensor, Int8Weight)):
            return leaf.device
    return torch.device("cpu")


def _as_input(model, x) -> torch.Tensor:
    """A calibration batch as a float32 tensor on the model's device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=_model_device(model), dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(_model_device(model))


def calibrate(model, xs) -> Dict[Path, float]:
    """Run the calibration batches through the float model eagerly and
    record max|activation| per candidate weight.  ``xs`` is one array or
    a list of arrays (leading batch axis).  Deterministic: the same model
    and inputs give the same stats.  Returns {path: amax} for every
    candidate a matmul used; a path is a tuple of list indices and dict
    keys, e.g. ``(4, "W")``."""
    batches = xs if isinstance(xs, (list, tuple)) else [xs]
    stats: Dict[Path, float] = {}
    calib = _tree_replace(model.params, {
        p: _CalibWeight(_get_path(model.params, p), stats, p)
        for p in _weight_paths(model.params)})
    with torch.inference_mode():
        for x in batches:
            model._apply_layers(calib, model.state, _as_input(model, x), None,
                                train=False)
    return stats


def quantize_params(params, stats: Dict[Path, float]):
    """Every calibrated candidate weight quantized; the other leaves
    (weights no matmul used) stay float."""
    return _tree_replace(params, {p: quantize_weight(_get_path(params, p), amax)
                                  for p, amax in stats.items()})


class QuantizedModel:
    """Serving view of a model with quantized params: the model's own
    ``_apply_layers`` (the ``Int8Weight`` leaves redirect the matmuls),
    state and conf, so the predict ``Engine`` captures the quantized
    forward like any other."""

    def __init__(self, model, params):
        self._model = model
        self.params = params
        self.state = model.state
        self.conf = getattr(model, "conf", None)

    def _apply_layers(self, params, state, x, mask=None, **kw):
        return self._model._apply_layers(params, state, x, mask, **kw)

    def output(self, x) -> torch.Tensor:
        with torch.inference_mode():
            return self._apply_layers(self.params, self.state, _as_input(self, x),
                                      None, train=False)[0]


def quantize_model(model, xs) -> QuantizedModel:
    """Calibrate on ``xs`` and return the int8 view of ``model``.  Raises
    when calibration found nothing to quantize: serving float under an
    int8 flag would be a lie."""
    stats = calibrate(model, xs)
    if not stats:
        raise ValueError(
            "int8 calibration found no quantizable matmul weights "
            "(no 2-D 'W' leaf was exercised by the calibration forward)")
    return QuantizedModel(model, quantize_params(model.params, stats))
