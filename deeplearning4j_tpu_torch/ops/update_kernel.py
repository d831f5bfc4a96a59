"""Fused Adam/Nadam step: both moment EMAs, the bias-corrected step and
the param subtract in one pass over a layer's flat buffers (mirrors
``deeplearning4j_tpu/ops/update_kernel.py``).

``fused_update`` is kernel K4.  For CUDA tensors it launches the CUDA
C++ kernel in ``csrc/fused_update.cu`` (which replaces the TPU kernel
``deeplearning4j_tpu/ops/update_kernel.py::_kernel``); for CPU tensors,
and only then, it runs ``fused_update_plain``, which is ``_update_math``
over the flat buffers.  The kernel writes the chain with round-to-nearest
intrinsics in ``_update_math``'s order, so it matches the plain version
bitwise on the card, and the plain version over the flat buffers matches
the per-leaf ``Adam.apply`` bitwise (the same elementwise ops on the same
values; concatenation only changes the layout).

As in the reference the fused path is opt-in: ``DL4J_TPU_FUSED_UPDATE=1``.
The switch is read at each call, not at import: eager PyTorch has no
trace time, so one process can run both arms.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Optional, Tuple

import torch

Tensor = torch.Tensor

#: the opt-in switch, as in the reference
ENV_SWITCH = "DL4J_TPU_FUSED_UPDATE"


def enabled() -> bool:
    """Whether the fused step is switched on (read now, at each call)."""
    return os.environ.get(ENV_SWITCH, "0") == "1"


def _update_math(kind: str, p, g, m, v, lr, bc1, bc2,
                 beta1: float, beta2: float, eps: float):
    """The fused step's single source of truth: plain Adam/Nadam math
    from ``nn/updaters.py`` plus the param subtract, f32 operands →
    (p_new, m_new, v_new)."""
    m_new = beta1 * m + (1 - beta1) * g
    v_new = beta2 * v + (1 - beta2) * g * g
    if kind == "nadam":
        m_hat = beta1 * (m_new / bc1) + (1 - beta1) * g / bc1
        step = lr * m_hat / (torch.sqrt(v_new / bc2) + eps)
    else:
        step = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    return p - step, m_new, v_new


def fused_update_plain(kind: str, p: Tensor, g: Tensor, m: Tensor, v: Tensor,
                       scalars: Tensor, beta1: float, beta2: float,
                       eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K4's plain PyTorch version over flat f32 buffers; ``scalars`` is
    [lr, bc1, bc2] f32."""
    return _update_math(kind, p, g, m, v, scalars[0], scalars[1], scalars[2],
                        beta1, beta2, eps)


@functools.lru_cache(maxsize=None)
def _update_fn():
    """``dl4j_fused_update`` from the built library, its C signature set once."""
    from ..utils import cuda_build

    fn = cuda_build.load("fused_update").dl4j_fused_update
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    return fn


def fused_update_cuda(kind: str, p: Tensor, g: Tensor, m: Tensor, v: Tensor,
                      scalars: Tensor, beta1: float, beta2: float,
                      eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch K4 (``csrc/fused_update.cu``) on flat contiguous f32 CUDA
    buffers of one length.  Raises for anything the kernel does not take."""
    flats = (p, g, m, v)
    if kind not in ("adam", "nadam"):
        raise ValueError(f"the fused update takes 'adam' or 'nadam', got {kind!r}")
    if not all(t.is_cuda and t.device == p.device for t in flats + (scalars,)):
        raise ValueError("fused_update_cuda needs every buffer on one CUDA device")
    if any(t.dtype != torch.float32 for t in flats + (scalars,)):
        raise TypeError("the fused update kernel takes float32 buffers")
    if any(t.ndim != 1 or t.shape != p.shape or not t.is_contiguous() for t in flats) \
            or tuple(scalars.shape) != (3,) or p.numel() == 0:
        raise ValueError("the fused update kernel takes non-empty flat contiguous "
                         "buffers of one length and scalars [lr, bc1, bc2]")
    outs = [torch.empty_like(p) for _ in range(3)]
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = _update_fn()(*(t.data_ptr() for t in flats), scalars.contiguous().data_ptr(),
                          *(t.data_ptr() for t in outs), p.numel(),
                          int(kind == "nadam"), beta1, 1 - beta1, beta2, 1 - beta2,
                          eps, stream)
    if rc != 0:
        raise RuntimeError(f"fused update kernel launch failed (code {rc})")
    fused_update_cuda.launches += 1
    return tuple(outs)


fused_update_cuda.launches = 0


def fused_update(kind: str, p: Tensor, g: Tensor, m: Tensor, v: Tensor,
                 scalars: Tensor, beta1: float, beta2: float,
                 eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K4: → (p_new, m_new, v_new).  CPU tensors run the plain version;
    CUDA tensors run the kernel."""
    if p.device.type == "cpu":
        return fused_update_plain(kind, p, g, m, v, scalars, beta1, beta2, eps)
    return fused_update_cuda(kind, p, g, m, v, scalars, beta1, beta2, eps)


def kind_of(updater) -> Optional[str]:
    """"adam"/"nadam" for exact Adam/Nadam configs (subclasses such as
    AdaMax and AMSGrad carry other math), else None."""
    from ..nn.updaters import Adam, Nadam

    if type(updater) is Nadam:
        return "nadam"
    if type(updater) is Adam:
        return "adam"
    return None


def fused_apply(kind: str, updater, params, grads, state, it: Tensor):
    """The fused one-pass update of one layer: its {params, grads, m, v}
    trees concatenated into flat f32 buffers, one K4 launch, split back.
    Returns ``(new_params, new_state)`` as ``Updater.apply`` does, or
    None when the fused path does not apply (switched off, a float64
    leaf, or an empty tree): the caller then runs the per-leaf path."""
    from ..nn.updaters import _bias_corrections, tree_leaves, tree_unflatten

    if not enabled():
        return None
    p_leaves = tree_leaves(params)
    if not p_leaves:
        return None
    g_leaves = tree_leaves(grads)
    m_leaves, v_leaves = tree_leaves(state["m"]), tree_leaves(state["v"])
    every = p_leaves + g_leaves + m_leaves + v_leaves
    if any(t.dtype == torch.float64 for t in every):
        return None   # exact-gradient-check configs stay on the plain path

    # the same scalar prelude as the per-leaf Adam.update
    lr = updater.lr_at(it)
    bc1, bc2 = _bias_corrections(updater.beta1, updater.beta2, it)
    scalars = torch.stack([lr.float(), bc1, bc2])

    def flat(leaves: List[Tensor]) -> Tensor:
        return torch.cat([t.reshape(-1).float() for t in leaves])

    new_p, new_m, new_v = fused_update(
        kind, flat(p_leaves), flat(g_leaves), flat(m_leaves), flat(v_leaves),
        scalars, updater.beta1, updater.beta2, updater.eps)

    def unflat(buf: Tensor, like: List[Tensor], template):
        out, off = [], 0
        for t in like:
            out.append(buf[off:off + t.numel()].reshape(t.shape).to(t.dtype))
            off += t.numel()
        return tree_unflatten(template, out)

    return (unflat(new_p, p_leaves, params),
            {"m": unflat(new_m, m_leaves, state["m"]),
             "v": unflat(new_v, v_leaves, state["v"])})


def jit_apply(updater):
    """Standalone optimizer-update harness (mirrors the reference's
    ``jit_apply``): ``run(params, grads, state, it) -> (new_params,
    new_state)``, each call wrapped in the ``train/update`` span
    (docs/OBSERVABILITY.md taxonomy).  It compiles nothing: eager PyTorch
    has no trace, so ``run.jitted`` is the plain callable the span
    wraps."""
    from ..obs import trace as obs_trace

    def fn(params, grads, state, it):
        return updater.apply(params, grads, state, it)

    def run(params, grads, state, it) -> Tuple:
        with obs_trace.span("train/update", cat="train"):
            return fn(params, grads, state, it)

    run.jitted = fn
    return run
