"""Numeric against analytic gradients (mirrors
``deeplearning4j_tpu/utils/gradient_check.py``, the reference's
GradientCheckUtil.checkGradients): central differences of a network's
score against autograd's gradient.  Run a float64 network (the
``("float64", "float64")`` dtype pair) for the reference's tolerances to
mean anything.

Arrays are taken in ``jax.tree_util``'s flatten order (list order, sorted
dict keys; a graph's vertices by sorted name) and an array larger than
``max_params_per_array`` is sampled with numpy's ``default_rng(seed)``
as the reference samples it, so both check the same entries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.updaters import tree_leaves, tree_unflatten


def _score_fn(net, ds):
    """The network's inference-mode score as a function of its parameters."""
    if isinstance(net.params, dict):                # a ComputationGraph
        inputs, labels, masks, lmasks = net._tensors(net._to_mds(ds))

        def score(params):
            return net._loss(params, net.state, inputs, labels, train=False,
                             masks=masks, label_masks=lmasks)[0]
    else:
        x, y, m, lm = net._batch(ds)

        def score(params):
            return net._loss(params, net.state, x, y, train=False, mask=m, label_mask=lm)[0]
    return score


def check_gradients(net, ds, epsilon: float = 1e-6, max_rel_error: float = 1e-3,
                    min_abs_error: float = 1e-8, max_params_per_array: int = 16,
                    seed: int = 0, verbose: bool = False) -> bool:
    """Central-difference check of d(score)/d(params): the relative error
    |a − n| / max(|a|, |n|) must stay below ``max_rel_error`` unless
    |a − n| < ``min_abs_error``."""
    score_fn = _score_fn(net, ds)
    leaves = [t.detach() for t in tree_leaves(net.params)]
    live = [t.clone().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        grads = torch.autograd.grad(score_fn(tree_unflatten(net.params, live)), live,
                                    allow_unused=True, materialize_grads=True)
    work = [t.clone() for t in leaves]
    rng = np.random.default_rng(seed)
    total, failures = 0, []
    with torch.no_grad():
        for ai, (p, g) in enumerate(zip(work, grads)):
            if not p.is_floating_point():
                continue
            size = p.numel()
            idxs = (np.arange(size) if size <= max_params_per_array
                    else rng.choice(size, size=max_params_per_array, replace=False))
            flat, gflat = p.view(-1), g.reshape(-1)
            for idx in idxs:
                idx = int(idx)
                orig = flat[idx].item()
                flat[idx] = orig + epsilon
                plus = float(score_fn(tree_unflatten(net.params, work)))
                flat[idx] = orig - epsilon
                minus = float(score_fn(tree_unflatten(net.params, work)))
                flat[idx] = orig
                numeric = (plus - minus) / (2 * epsilon)
                a = float(gflat[idx])
                abs_err = abs(a - numeric)
                denom = max(abs(a), abs(numeric))
                rel_err = abs_err / denom if denom > 0 else 0.0
                total += 1
                if rel_err > max_rel_error and abs_err > min_abs_error:
                    failures.append((ai, idx, a, numeric, rel_err))
                    if verbose:
                        print(f"FAIL array {ai} idx {idx}: analytic={a:.6e} "
                              f"numeric={numeric:.6e} rel={rel_err:.3e}")
    if verbose:
        print(f"checked {total} params, {len(failures)} failures")
    return not failures
