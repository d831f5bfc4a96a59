"""Line-search and second-order solvers (mirrors
``deeplearning4j_tpu/optimize/solvers.py``): Armijo backtracking, L-BFGS
(two-loop recursion, history 4), Polak-Ribière conjugate gradient and
line gradient descent, the alternatives to SGD that the reference
selects by OptimizationAlgorithm.

The parameters are raveled into one float32 vector on the network's
device; the loss and its gradient (autograd) are computed there, and the
solver's control flow (history, step decisions) runs on the host as the
reference's does, reading back the scalars each decision needs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch

from ..nn.updaters import tree_leaves, tree_unflatten

Tensor = torch.Tensor


@dataclasses.dataclass
class SolverResult:
    params: object            # the input's tree structure
    loss: float
    losses: List[float]
    iterations: int
    converged: bool


def _ravel(params):
    """(flat float32 vector, unravel) for a tree of tensors; ``unravel``
    gives each leaf back its shape and dtype."""
    leaves = tree_leaves(params)
    shapes = [l.shape for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [l.numel() for l in leaves]
    flat = torch.cat([l.detach().reshape(-1).to(torch.float32) for l in leaves])

    def unravel(v: Tensor):
        parts = torch.split(v, sizes)
        return tree_unflatten(params, [p.reshape(s).to(d)
                                       for p, s, d in zip(parts, shapes, dtypes)])
    return flat, unravel


def backtrack_line_search(f: Callable[[Tensor], Tensor], x: Tensor, fx: float,
                          g: Tensor, direction: Tensor,
                          initial_step: float = 1.0,
                          c1: float = 1e-4, rho: float = 0.5,
                          max_steps: int = 20) -> Tuple[float, float]:
    """Armijo backtracking: shrink ``step`` until f(x + step·d) <= f(x) +
    c1·step·gᵀd; when the first step already passes, grow it while f keeps
    falling.  Returns (step, f_new); step 0.0 when nothing decreased."""
    gd = float(g @ direction)
    if gd >= 0:
        return 0.0, fx
    step = initial_step
    for i in range(max_steps):
        f_new = float(f(x + step * direction))
        if math.isfinite(f_new) and f_new <= fx + c1 * step * gd:
            if i == 0:
                for _ in range(10):
                    f_try = float(f(x + 2.0 * step * direction))
                    if math.isfinite(f_try) and f_try < f_new:
                        step *= 2.0
                        f_new = f_try
                    else:
                        break
            return step, f_new
        step *= rho
    return 0.0, fx


def minimize(loss_fn: Callable, params, method: str = "lbfgs",
             max_iterations: int = 100, tol: float = 1e-6,
             history: int = 4) -> SolverResult:
    """Full-batch minimization of ``loss_fn(params)`` (a scalar tensor of
    a tree of tensors); ``method`` is lbfgs, cg or line_gd, ``history``
    the L-BFGS memory."""
    if method not in ("lbfgs", "cg", "line_gd"):
        raise ValueError(f"unknown method '{method}' — use lbfgs | cg | line_gd")
    x, unravel = _ravel(params)

    def vg(flat: Tensor):
        live = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(unravel(live))
            (grad,) = torch.autograd.grad(loss, live)
        return loss.detach(), grad

    def f_only(flat: Tensor):
        with torch.no_grad():
            return loss_fn(unravel(flat))

    fx, g = vg(x)
    fx = float(fx)
    losses = [fx]
    converged = False
    s_hist: List[Tensor] = []
    y_hist: List[Tensor] = []
    prev_g: Optional[Tensor] = None
    prev_d: Optional[Tensor] = None
    it = 0
    for it in range(1, max_iterations + 1):
        if method == "line_gd":
            d = -g
        elif method == "cg":
            if prev_g is None:
                d = -g
            else:
                # Polak-Ribière with the automatic reset max(0, β)
                beta = float(torch.dot(g, g - prev_g)
                             / torch.clamp_min(torch.dot(prev_g, prev_g), 1e-20))
                d = -g + max(0.0, beta) * prev_d
        else:
            q = g
            alphas = []
            for s, y in zip(reversed(s_hist), reversed(y_hist)):
                rho_i = 1.0 / float(torch.dot(y, s))
                a = rho_i * float(torch.dot(s, q))
                alphas.append((a, rho_i, s, y))
                q = q - a * y
            if y_hist:
                s_l, y_l = s_hist[-1], y_hist[-1]
                gamma = float(torch.dot(s_l, y_l)
                              / torch.clamp_min(torch.dot(y_l, y_l), 1e-20))
                q = q * gamma
            for a, rho_i, s, y in reversed(alphas):
                b = rho_i * float(torch.dot(y, q))
                q = q + (a - b) * s
            d = -q
        step, f_new = backtrack_line_search(f_only, x, fx, g, d)
        if step == 0.0:
            # the line search failed: restart from steepest descent once
            if method != "line_gd" and (prev_g is not None or s_hist):
                s_hist, y_hist, prev_g, prev_d = [], [], None, None
                step, f_new = backtrack_line_search(f_only, x, fx, g, -g)
                d = -g
            if step == 0.0:
                break
        x_new = x + step * d
        _, g_new = vg(x_new)
        if method == "lbfgs":
            s_vec, y_vec = x_new - x, g_new - g
            if float(torch.dot(s_vec, y_vec)) > 1e-10:        # curvature condition
                s_hist.append(s_vec)
                y_hist.append(y_vec)
                if len(s_hist) > history:
                    s_hist.pop(0)
                    y_hist.pop(0)
        prev_g, prev_d = g, d
        rel = abs(fx - f_new) / max(abs(fx), 1e-12)
        x, fx, g = x_new, f_new, g_new
        losses.append(fx)
        if rel < tol:
            converged = True
            break
    return SolverResult(unravel(x), fx, losses, it, converged)


def fit_solver(net, ds, method: str = "lbfgs", max_iterations: int = 100,
               tol: float = 1e-6) -> SolverResult:
    """Full-batch solver training of a MultiLayerNetwork (the reference's
    Solver.optimize with LBFGS / CONJUGATE_GRADIENT /
    LINE_GRADIENT_DESCENT): the loss in inference mode, regularization
    included.  Replaces ``net.params``."""
    x, y, m, lm = net._batch(ds)

    def loss_fn(params):
        return net._loss(params, net.state, x, y, train=False, mask=m, label_mask=lm)[0]

    result = minimize(loss_fn, net.params, method=method,
                      max_iterations=max_iterations, tol=tol)
    net.params = result.params
    return result
