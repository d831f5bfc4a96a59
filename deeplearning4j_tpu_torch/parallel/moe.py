"""Mixture-of-Experts with expert parallelism (mirrors
``deeplearning4j_tpu/parallel/moe.py``).

  - router: tokens → top-k experts, softmax over the selected logits;
    the Switch load-balance term E·Σ f_e·p_e as the auxiliary loss
  - experts: per-expert FFN [d_model → d_ff → d_model], parameters stacked
    on a leading expert dim, all experts as one batched einsum
  - capacity: fixed per-expert slots ceil(k·N/E·capacity_factor); tokens
    past an expert's capacity are dropped (contribute zero), as in Switch

``moe_forward_dense`` is the exact path (every expert sees every token's
input, combined by the sparse gates): the ``MoE`` layer and the parity
reference.  ``moe_forward_ep`` is the expert-parallel path over a
``RankMesh``: each rank takes its ``model`` slice of the experts and its
``data`` rows of the tokens, builds dispatch/combine one-hots for its
local experts, and ``collectives.psum`` over ``model`` merges the
gate-weighted outputs (its backward passes the gradient through; the
router and the tokens enter through ``pvary``, whose backward sums
their gradient over ``model``).  The einsums are plain ``torch.einsum``,
as the reference's are XLA's, not a Pallas kernel's.

Tie order: the router's top-k is a stable descending sort of the logits,
so of two equal logits the lower expert index ranks first, the order
``jax.lax.top_k`` documents (``torch.topk`` leaves ties unspecified).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..nn.conf.inputs import InputType
from ..nn.layers.base import AUX_LOSS_KEY, ForwardOut, Layer, register_layer
from .collectives import Axis, psum, pvary

Tensor = torch.Tensor


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int,
                    dtype=torch.float32, device=None) -> Dict[str, Tensor]:
    """He-normal router and expert weights drawn from ``generator``, zero
    biases (the reference's scales)."""
    s_in = (2.0 / d_model) ** 0.5
    s_ff = (2.0 / d_ff) ** 0.5

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (t * scale).to(device=device, dtype=dtype)

    return {
        "Wg": normal((d_model, n_experts), s_in),
        "W1": normal((n_experts, d_model, d_ff), s_in),
        "b1": torch.zeros((n_experts, d_ff), dtype=dtype, device=device),
        "W2": normal((n_experts, d_ff, d_model), s_ff),
        "b2": torch.zeros((n_experts, d_model), dtype=dtype, device=device),
    }


def init_moe_params_numpy(seed: int, d_model: int, d_ff: int, n_experts: int,
                          dtype=np.float32) -> Dict[str, np.ndarray]:
    """The same tree from ``np.random.default_rng(seed)`` (numpy arrays
    both packages take)."""
    rng = np.random.default_rng(seed)
    s_in = (2.0 / d_model) ** 0.5
    s_ff = (2.0 / d_ff) ** 0.5
    return {
        "Wg": (rng.standard_normal((d_model, n_experts)) * s_in).astype(dtype),
        "W1": (rng.standard_normal((n_experts, d_model, d_ff)) * s_in).astype(dtype),
        "b1": np.zeros((n_experts, d_ff), dtype),
        "W2": (rng.standard_normal((n_experts, d_ff, d_model)) * s_ff).astype(dtype),
        "b2": np.zeros((n_experts, d_model), dtype),
    }


def top_k(logits: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """(values, indices) of the ``k`` largest logits per row, descending,
    ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(params, x: Tensor, k: int):
    """→ (gates [N, E], nonzero only on each token's top-k, the Switch
    load-balance auxiliary loss)."""
    logits = x @ params["Wg"].to(x.dtype)
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(logits, k)
    gate_v = torch.softmax(topv, dim=-1)
    gates = torch.zeros_like(probs).scatter(1, topi, gate_v)
    frac = (gates > 0).to(x.dtype).mean(dim=0)
    mean_p = probs.mean(dim=0)
    aux = E * torch.sum(frac * mean_p)
    return gates, aux


def moe_forward_dense(params: Dict[str, Tensor], x: Tensor, k: int = 2
                      ) -> Tuple[Tensor, Tensor]:
    """Exact MoE: every expert processes every token, combined by the
    gates.  x [N, d_model] → (y [N, d_model], aux_loss)."""
    gates, aux = _router(params, x, k)
    dt = x.dtype
    h = torch.einsum("nd,edf->nef", x, params["W1"].to(dt))
    h = torch.relu(h + params["b1"].to(dt)[None])
    y_e = torch.einsum("nef,efd->ned", h, params["W2"].to(dt)) + params["b2"].to(dt)[None]
    return torch.einsum("ne,ned->nd", gates, y_e), aux


def capacity(n_tokens: int, n_experts: int, k: int, capacity_factor: float = 1.25) -> int:
    """Per-expert token slots (Switch capacity)."""
    return max(1, int(math.ceil(k * n_tokens / n_experts * capacity_factor)))


def dispatch(local_gates: Tensor, C: int) -> Tensor:
    """[N, e, C] one-hot of each routed token's slot in its expert's
    capacity buffer (its rank among the tokens routed there before it);
    a token past slot C - 1 is dropped (an all-zero row)."""
    routed = (local_gates > 0).to(torch.int64)
    pos = torch.cumsum(routed, dim=0) - routed
    keep = routed * (pos < C)
    slots = torch.arange(C, device=local_gates.device)
    return keep[..., None].to(local_gates.dtype) * (pos[..., None] == slots).to(local_gates.dtype)


def moe_forward_ep(params: Dict[str, Tensor], x: Tensor, mesh, expert_axis: str = "model",
                   k: int = 2, capacity_factor: float = 1.25,
                   data_axis: Optional[str] = "data") -> Tuple[Tensor, Tensor]:
    """Expert-parallel MoE over ``mesh`` (a ``RankMesh``), DP-composable.

    Every rank passes the WHOLE ``params`` and the GLOBAL tokens ``x``
    [N, d_model]; it computes its ``expert_axis`` slice of the experts on
    its ``data_axis`` rows (when the mesh has that axis) and returns
    (y of its rows [N / D, d_model], the global aux loss).  Capacity is
    per data shard; over-capacity tokens are dropped, as in the
    reference.  A parameter's gradient lands in this rank's slice of it
    (the router's summed over ``model``)."""
    E = params["Wg"].shape[-1]
    M = mesh.shape.get(expert_axis, 1)
    if E % M:
        raise ValueError(f"n_experts {E} not divisible by {expert_axis} "
                         f"axis size {M}")
    if data_axis is not None and data_axis not in mesh.shape:
        data_axis = None
    D = mesh.shape[data_axis] if data_axis else 1
    N = x.shape[0]
    if N % D:
        raise ValueError(f"token count {N} not divisible by {data_axis} "
                         f"axis size {D}")
    C = capacity(N // D, E, k, capacity_factor)
    e_loc = E // M
    ea = Axis(mesh, expert_axis)
    da = Axis(mesh, data_axis) if data_axis else None
    di = da.index if da else 0
    xs = pvary(x[di * (N // D):(di + 1) * (N // D)], ea)
    gates, aux = _router({"Wg": pvary(params["Wg"], ea)}, xs, k)
    aux = aux / M
    if da is not None:
        aux = psum(aux, da) / D
    lo = ea.index * e_loc
    local_gates = gates[:, lo:lo + e_loc]
    disp = dispatch(local_gates, C)
    exp_in = torch.einsum("nec,nd->ecd", disp, xs)
    dt = xs.dtype
    W1, b1 = params["W1"][lo:lo + e_loc].to(dt), params["b1"][lo:lo + e_loc].to(dt)
    W2, b2 = params["W2"][lo:lo + e_loc].to(dt), params["b2"][lo:lo + e_loc].to(dt)
    h = torch.relu(torch.einsum("ecd,edf->ecf", exp_in, W1) + b1[:, None, :])
    out = torch.einsum("ecf,efd->ecd", h, W2) + b2[:, None, :]
    combine = disp * local_gates[..., None]
    y = psum(torch.einsum("nec,ecd->nd", combine, out), ea)
    return y, psum(aux, ea)


def dropped_tokens(params: Dict[str, Tensor], x: Tensor, k: int = 2,
                   capacity_factor: float = 1.25) -> Tensor:
    """[N, E] bool: the (token, expert) routings ``moe_forward_ep`` drops
    past capacity on one data shard of ``x``."""
    gates, _ = _router(params, x, k)
    C = capacity(x.shape[0], gates.shape[-1], k, capacity_factor)
    routed = gates > 0
    return routed & (dispatch(gates, C).sum(-1) == 0)


# ---------------------------------------------------------------------------
# the layer (the exact dense combine)
# ---------------------------------------------------------------------------


@register_layer
@dataclasses.dataclass
class MoE(Layer):
    """Mixture-of-Experts FFN layer (exact dense combine; ``moe_forward_ep``
    is the sharded path).  Takes [mb, d] or [mb, t, d] (per token).  The
    Switch auxiliary loss rides the ``AUX_LOSS_KEY`` state slot, which the
    containers add to the training objective."""

    n_in: int = 0
    d_ff: int = 0
    n_experts: int = 4
    top_k: int = 2
    aux_weight: float = 0.01

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size
        if self.d_ff == 0:
            self.d_ff = 4 * self.n_in

    def output_type(self, in_type: InputType) -> InputType:
        return in_type

    def init_params(self, generator: torch.Generator, in_type: InputType,
                    dtype=torch.float32) -> Dict[str, Tensor]:
        return init_moe_params(generator, self.n_in, self.d_ff, self.n_experts, dtype)

    def init_state(self, in_type: InputType, dtype=torch.float32) -> Dict[str, Tensor]:
        return {AUX_LOSS_KEY: torch.zeros((), dtype=torch.float32)}

    def forward(self, params, state, x, *, train=False, generator=None, mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        shape = x.shape
        y, aux = moe_forward_dense(params, x.reshape(-1, shape[-1]), self.top_k)
        new_state = dict(state)
        new_state[AUX_LOSS_KEY] = (self.aux_weight * aux).to(torch.float32)
        return ForwardOut(self._act(y.reshape(shape)), new_state, mask)
