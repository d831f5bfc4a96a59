"""Updaters, learning-rate schedules and gradient normalization (mirrors
``deeplearning4j_tpu/nn/updaters.py``).

An updater is a dataclass with ``init_state(params)`` and
``update(grads, state, it)`` → (updates, new_state); ``apply`` adds the
param step ``params - updates`` in f32.  ``it`` is the iteration before
this step as a 0-dim f32 tensor on the params' device, so the learning
rate and the bias corrections are f32 tensor math there, as
``jnp.power`` in f32 is in the reference, and a step needs no host sync.

Trees are the per-layer ``{name: tensor}`` dicts (nested dicts and lists
work too, as the VAE's encoder and decoder lists);
leaves are taken in sorted key order, as ``jax.tree_util`` flattens a
dict, so a norm over a layer sums its leaves in the reference's order and
the state dicts come out with the reference's key order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from .layers.base import register_config

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> List[Tensor]:
    """Leaves of a nested dict (sorted key order) or list (list order), as
    ``jax.tree_util`` flattens them."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves: List[Tensor]):
    """A tree shaped like ``template`` (keys sorted) from its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` leafwise over ``tree`` and trees of its structure."""
    flat = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def _tree_update(fn, grads, *state_trees):
    """``fn(g, *state_leaves) -> (out1, out2, ...)`` leafwise over the
    gradient tree → one tree per output slot."""
    flat_g = tree_leaves(grads)
    flat_s = [tree_leaves(s) for s in state_trees]
    outs = [fn(g, *(fs[i] for fs in flat_s)) for i, g in enumerate(flat_g)]
    return tuple(tree_unflatten(grads, [o[j] for o in outs])
                 for j in range(len(outs[0])))


def _zeros_like_tree(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------


@register_config
@dataclasses.dataclass
class Schedule:
    """Fixed LR (the base class doubles as the trivial schedule)."""

    lr: float = 1e-3

    def __call__(self, it: Tensor) -> Tensor:
        return torch.full((), self.lr, dtype=torch.float32, device=it.device)


@register_config
@dataclasses.dataclass
class ExponentialSchedule(Schedule):
    decay: float = 0.99

    def __call__(self, it):
        return self.lr * torch.pow(self.decay, it)


@register_config
@dataclasses.dataclass
class InverseSchedule(Schedule):
    decay: float = 0.01
    power: float = 1.0

    def __call__(self, it):
        return self.lr / torch.pow(1.0 + self.decay * it, self.power)


@register_config
@dataclasses.dataclass
class PolySchedule(Schedule):
    power: float = 1.0
    max_iter: int = 10000

    def __call__(self, it):
        frac = torch.clamp(it / self.max_iter, 0.0, 1.0)
        return self.lr * torch.pow(1.0 - frac, self.power)


@register_config
@dataclasses.dataclass
class SigmoidSchedule(Schedule):
    decay: float = 0.01
    steps: int = 1000

    def __call__(self, it):
        return self.lr / (1.0 + torch.exp(-self.decay * (it - self.steps)))


@register_config
@dataclasses.dataclass
class StepSchedule(Schedule):
    decay: float = 0.1
    steps: int = 1000

    def __call__(self, it):
        return self.lr * torch.pow(self.decay, torch.floor(it / self.steps))


def resolve_schedule(lr_or_schedule) -> Schedule:
    if isinstance(lr_or_schedule, Schedule):
        return lr_or_schedule
    return Schedule(lr=float(lr_or_schedule))


# ---------------------------------------------------------------------------
# updaters
# ---------------------------------------------------------------------------


def _bias_corrections(beta1: float, beta2: float, it: Tensor):
    """(1 - beta1^t, 1 - beta2^t) in f32 with t = it + 1."""
    t = it + 1.0
    return 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)


@dataclasses.dataclass
class Updater:
    """Base updater config; ``lr`` is a Schedule or a float."""

    lr: Any = 1e-3

    def lr_at(self, it: Tensor) -> Tensor:
        return resolve_schedule(self.lr)(it)

    def init_state(self, params) -> Dict:
        return {}

    def update(self, grads, state, it: Tensor):
        raise NotImplementedError

    def apply(self, params, grads, state, it: Tensor):
        """Updater math plus the param step (``params - updates`` in f32,
        cast back to each leaf's dtype), one layer at a time."""
        updates, new_state = self.update(grads, state, it)
        new_params = tree_map(lambda pp, uu: (pp.float() - uu).to(pp.dtype),
                              params, updates)
        return new_params, new_state


@register_config
@dataclasses.dataclass
class Sgd(Updater):
    def update(self, grads, state, it):
        lr = self.lr_at(it)
        return tree_map(lambda g: lr * g.float(), grads), state


@register_config
@dataclasses.dataclass
class Nesterovs(Updater):
    lr: Any = 0.1
    momentum: float = 0.9

    def init_state(self, params):
        return {"v": _zeros_like_tree(params)}

    def update(self, grads, state, it):
        lr, mu = self.lr_at(it), self.momentum

        def upd(g, v):
            # ND4J Nesterovs.java: vNew = mu*v - lr*g; update = mu*v - (1+mu)*vNew
            g = g.float()
            v_new = mu * v - lr * g
            return mu * v - (1.0 + mu) * v_new, v_new

        updates, new_v = _tree_update(upd, grads, state["v"])
        return updates, {"v": new_v}


@register_config
@dataclasses.dataclass
class Adam(Updater):
    """Adam.  ``moment_dtype`` (e.g. "bfloat16") stores both moments in a
    narrower dtype; the update math always runs in f32.  ``apply`` routes
    through the fused one-pass step (``ops/update_kernel.py``, kernel K4
    on the card) when ``DL4J_TPU_FUSED_UPDATE=1``."""

    lr: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    moment_dtype: Any = None

    def _moments_like(self, params):
        z = _zeros_like_tree(params)
        if self.moment_dtype is None:
            return z
        from ..ops.dtypes import canonical_dtype
        dt = canonical_dtype(self.moment_dtype)
        return tree_map(lambda a: a.to(dt), z)

    def init_state(self, params):
        return {"m": self._moments_like(params), "v": self._moments_like(params)}

    def update(self, grads, state, it):
        lr = self.lr_at(it)
        bc1, bc2 = _bias_corrections(self.beta1, self.beta2, it)

        def upd(g, m, v):
            g = g.float()
            m_new = self.beta1 * m.float() + (1 - self.beta1) * g
            v_new = self.beta2 * v.float() + (1 - self.beta2) * g * g
            step = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            return step, m_new.to(m.dtype), v_new.to(v.dtype)

        updates, new_m, new_v = _tree_update(upd, grads, state["m"], state["v"])
        return updates, {"m": new_m, "v": new_v}

    def apply(self, params, grads, state, it):
        """The fused one-pass step when it is switched on and applies
        (exact Adam/Nadam, no float64 leaf); else the per-leaf path."""
        from ..ops import update_kernel

        kind = update_kernel.kind_of(self)
        if kind is not None:
            fused = update_kernel.fused_apply(kind, self, params, grads, state, it)
            if fused is not None:
                return fused
        return super().apply(params, grads, state, it)


@register_config
@dataclasses.dataclass
class AdaMax(Adam):
    def update(self, grads, state, it):
        lr = self.lr_at(it)
        bc1, _ = _bias_corrections(self.beta1, self.beta2, it)

        def upd(g, m, u):
            g = g.float()
            m_new = self.beta1 * m.float() + (1 - self.beta1) * g
            u_new = torch.maximum(self.beta2 * u.float(), torch.abs(g))
            step = lr * (m_new / bc1) / (u_new + self.eps)
            return step, m_new.to(m.dtype), u_new.to(u.dtype)

        updates, new_m, new_v = _tree_update(upd, grads, state["m"], state["v"])
        return updates, {"m": new_m, "v": new_v}


@register_config
@dataclasses.dataclass
class Nadam(Adam):
    def update(self, grads, state, it):
        lr = self.lr_at(it)
        bc1, bc2 = _bias_corrections(self.beta1, self.beta2, it)

        def upd(g, m, v):
            g = g.float()
            m_new = self.beta1 * m.float() + (1 - self.beta1) * g
            v_new = self.beta2 * v.float() + (1 - self.beta2) * g * g
            m_hat = self.beta1 * (m_new / bc1) + (1 - self.beta1) * g / bc1
            step = lr * m_hat / (torch.sqrt(v_new / bc2) + self.eps)
            return step, m_new.to(m.dtype), v_new.to(v.dtype)

        updates, new_m, new_v = _tree_update(upd, grads, state["m"], state["v"])
        return updates, {"m": new_m, "v": new_v}


@register_config
@dataclasses.dataclass
class AMSGrad(Adam):
    """Adam with a monotone max on the second moment; state m, v, vhat."""

    def init_state(self, params):
        return {"m": self._moments_like(params), "v": self._moments_like(params),
                "vhat": self._moments_like(params)}

    def update(self, grads, state, it):
        lr = self.lr_at(it)
        bc1, bc2 = _bias_corrections(self.beta1, self.beta2, it)

        def upd(g, m, v, vh):
            g = g.float()
            m_new = self.beta1 * m.float() + (1 - self.beta1) * g
            v_new = self.beta2 * v.float() + (1 - self.beta2) * g * g
            vh_new = torch.maximum(vh.float(), v_new)
            step = lr * (m_new / bc1) / (torch.sqrt(vh_new / bc2) + self.eps)
            return step, m_new.to(m.dtype), v_new.to(v.dtype), vh_new.to(vh.dtype)

        updates, new_m, new_v, new_vh = _tree_update(
            upd, grads, state["m"], state["v"], state["vhat"])
        return updates, {"m": new_m, "v": new_v, "vhat": new_vh}


@register_config
@dataclasses.dataclass
class AdaGrad(Updater):
    lr: Any = 1e-1
    eps: float = 1e-6

    def init_state(self, params):
        return {"h": _zeros_like_tree(params)}

    def update(self, grads, state, it):
        lr = self.lr_at(it)

        def upd(g, h):
            g = g.float()
            h_new = h + g * g
            return lr * g / (torch.sqrt(h_new) + self.eps), h_new

        updates, new_h = _tree_update(upd, grads, state["h"])
        return updates, {"h": new_h}


@register_config
@dataclasses.dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    eps: float = 1e-6

    def init_state(self, params):
        return {"g2": _zeros_like_tree(params), "dx2": _zeros_like_tree(params)}

    def update(self, grads, state, it):
        def upd(g, g2, dx2):
            g = g.float()
            g2_new = self.rho * g2 + (1 - self.rho) * g * g
            step = torch.sqrt(dx2 + self.eps) / torch.sqrt(g2_new + self.eps) * g
            dx2_new = self.rho * dx2 + (1 - self.rho) * step * step
            return step, g2_new, dx2_new

        updates, new_g2, new_dx2 = _tree_update(upd, grads, state["g2"], state["dx2"])
        return updates, {"g2": new_g2, "dx2": new_dx2}


@register_config
@dataclasses.dataclass
class RmsProp(Updater):
    lr: Any = 1e-3
    rms_decay: float = 0.95
    eps: float = 1e-8

    def init_state(self, params):
        return {"g2": _zeros_like_tree(params)}

    def update(self, grads, state, it):
        lr = self.lr_at(it)

        def upd(g, g2):
            g = g.float()
            g2_new = self.rms_decay * g2 + (1 - self.rms_decay) * g * g
            return lr * g / (torch.sqrt(g2_new) + self.eps), g2_new

        updates, new_g2 = _tree_update(upd, grads, state["g2"])
        return updates, {"g2": new_g2}


@register_config
@dataclasses.dataclass
class NoOp(Updater):
    def update(self, grads, state, it):
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads), state


# ---------------------------------------------------------------------------
# gradient normalization
# ---------------------------------------------------------------------------


class GradientNormalization:
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENTWISE_ABSOLUTE = "clip_elementwise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


def _sq_norm(g: Tensor) -> Tensor:
    return torch.sum(g.float() ** 2)


def _clip_scale(norm: Tensor, threshold: float) -> Tensor:
    return torch.where(norm > threshold, threshold / (norm + 1e-8), torch.ones_like(norm))


def normalize_gradients(layer_grads: Dict[str, Tensor], mode: str,
                        threshold: float, sq_norms: Optional[Callable] = None
                        ) -> Dict[str, Tensor]:
    """One layer's gradient normalization (the reference's preApply).
    ``sq_norms(leaves)`` gives each leaf's squared L2 norm (default: its
    own); a tensor-parallel caller whose leaves are slices sums them over
    the ranks holding the other slices."""
    if mode in (None, GradientNormalization.NONE):
        return layer_grads
    leaves = tree_leaves(layer_grads)
    G = GradientNormalization
    sq = (lambda: [_sq_norm(g) for g in leaves]) if sq_norms is None else \
        (lambda: sq_norms(leaves))
    if mode == G.RENORMALIZE_L2_PER_LAYER:
        norm = torch.sqrt(sum(sq()))
        scale = 1.0 / torch.clamp(norm, min=1e-8)
        out = [g * scale.to(g.dtype) for g in leaves]
    elif mode == G.RENORMALIZE_L2_PER_PARAM_TYPE:
        out = [g / torch.clamp(torch.sqrt(n), min=1e-8).to(g.dtype)
               for g, n in zip(leaves, sq())]
    elif mode == G.CLIP_ELEMENTWISE_ABSOLUTE:
        out = [torch.clamp(g, -threshold, threshold) for g in leaves]
    elif mode == G.CLIP_L2_PER_LAYER:
        norm = torch.sqrt(sum(sq()))
        scale = _clip_scale(norm, threshold)
        out = [g * scale.to(g.dtype) for g in leaves]
    elif mode == G.CLIP_L2_PER_PARAM_TYPE:
        out = [g * _clip_scale(torch.sqrt(n), threshold).to(g.dtype)
               for g, n in zip(leaves, sq())]
    else:
        raise ValueError(f"unknown gradient normalization mode {mode}")
    return tree_unflatten(layer_grads, out)
