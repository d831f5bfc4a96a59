"""Model serialization — the reference's checkpoint zip, read and written
by the port (mirrors ``deeplearning4j_tpu/utils/serializer.py``).

The zip holds ``configuration.json``, ``meta.json`` (iteration, epoch),
``params.npz`` / ``state.npz`` with entries ``<layer_idx>/<param_name>``
and ``updater.npz``, the optimizer state, with entries
``<layer_idx>/<slot>/<param_name>`` (``net.opt_state``).  A
``ComputationGraph``'s entries are keyed by vertex name where a
``MultiLayerNetwork``'s have the layer index; ``load_model`` builds the
container that ``configuration.json``'s ``type`` names.  Versions 1-4
load: v2 stores bfloat16 leaves as uint16 bits under ``<name>#bfloat16``,
v4 records a sha256 per entry in ``meta.json["integrity"]``, verified on
load.  ``grad_residual.npz`` (v3+) is the error-feedback residual of
compressed data-parallel training (``parallel/trainer.py``), keyed as
``params.npz`` with a leading axis of the slice count; it is read into
``net.grad_residual`` and written from it.  A zip written by either
package loads, and resumes training, in the other.
"""

from __future__ import annotations

import hashlib
import io
import json
import zipfile
from typing import Dict

import numpy as np

from ..ops.dtypes import BF16_SUFFIX, leaf_to_tensor, tensor_to_leaf
from .device import DeviceLike

FORMAT_VERSION = 4
SUPPORTED_VERSIONS = (1, 2, 3, 4)


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint entry's bytes do not match the digest in meta.json."""


def _flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_tree(v, f"{prefix}{i}/"))
    elif tree is not None:
        suffix, a = tensor_to_leaf(tree)
        out[prefix[:-1] + suffix] = a
    return out


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load_npz(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def _unflatten_into(template, flat: Dict[str, np.ndarray], device, prefix="",
                    lead: bool = False):
    """Rebuild the template's structure from name → array, on ``device``;
    with ``lead`` each array has one more leading axis than its template
    leaf (the residual's slice axis)."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, device, f"{prefix}{k}/", lead)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten_into(v, flat, device, f"{prefix}{i}/", lead)
               for i, v in enumerate(template)]
        return type(template)(seq) if isinstance(template, tuple) else seq
    key = prefix[:-1]
    if key in flat:
        t = leaf_to_tensor(flat[key])
    elif key + BF16_SUFFIX in flat:
        t = leaf_to_tensor(flat[key + BF16_SUFFIX], bf16=True)
    else:
        raise KeyError(f"checkpoint missing parameter '{key}' (bfloat16 "
                       f"leaves are stored under '<name>{BF16_SUFFIX}')")
    shape = tuple(t.shape)[1:] if lead else tuple(t.shape)
    if (lead and t.ndim == 0) or shape != tuple(template.shape):
        raise ValueError(f"checkpoint parameter '{key}' has shape "
                         f"{tuple(t.shape)}, the configuration wants "
                         f"{'(slices, ...) + ' if lead else ''}{tuple(template.shape)}")
    return t.to(device)


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def save_model(net, path: str, save_updater: bool = True,
               compression: int = zipfile.ZIP_DEFLATED) -> None:
    """Write ``net`` as a format-v4 checkpoint zip."""
    entries = {"configuration.json":
               json.dumps(net.conf.to_dict(), indent=1).encode(),
               "params.npz": _npz_bytes(_flatten_tree(net.params)),
               "state.npz": _npz_bytes(_flatten_tree(net.state))}
    if save_updater:
        entries["updater.npz"] = _npz_bytes(_flatten_tree(net.opt_state))
    residual = getattr(net, "grad_residual", None)
    if residual is not None:
        entries["grad_residual.npz"] = _npz_bytes(_flatten_tree(residual))
    meta = {
        "format_version": FORMAT_VERSION,
        "iteration": net.iteration,
        "epoch": net.epoch,
        "model_class": type(net).__name__,
        "integrity": {name: _digest(data) for name, data in entries.items()},
    }
    with zipfile.ZipFile(path, "w", compression) as zf:
        zf.writestr("meta.json", json.dumps(meta))
        for name, data in entries.items():
            zf.writestr(name, data)


def _read_verified(zf: zipfile.ZipFile, name: str, integrity, path) -> bytes:
    data = zf.read(name)
    want = (integrity or {}).get(name)
    if want is not None and _digest(data) != want:
        raise CheckpointIntegrityError(
            f"checkpoint entry {name!r} in {path!r} fails its sha256 digest "
            "— the file is corrupt (torn write / bit flip)")
    return data


def load_model(path: str, load_updater: bool = True, device: DeviceLike = None):
    """Read a checkpoint zip into a ``MultiLayerNetwork`` or a
    ``ComputationGraph`` (as ``configuration.json``'s ``type`` says) on
    ``device`` (default ``cuda``)."""
    from ..nn.graph import ComputationGraph, ComputationGraphConfiguration
    from ..nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork

    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        ver = meta.get("format_version", 1)
        if ver not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"checkpoint format v{ver} not supported (reader knows "
                f"{SUPPORTED_VERSIONS})")
        integrity = meta.get("integrity")  # absent in v1-v3: load unverified
        conf_d = json.loads(_read_verified(zf, "configuration.json",
                                           integrity, path))
        params_flat = _load_npz(_read_verified(zf, "params.npz", integrity, path))
        state_flat = _load_npz(_read_verified(zf, "state.npz", integrity, path))
        names = zf.namelist()
        upd_flat = _load_npz(_read_verified(zf, "updater.npz", integrity, path)) if (
            load_updater and "updater.npz" in names) else None
        resid_flat = _load_npz(_read_verified(zf, "grad_residual.npz", integrity, path)) if (
            "grad_residual.npz" in names) else None

    if conf_d.get("type") == "ComputationGraphConfiguration":
        net = ComputationGraph(ComputationGraphConfiguration.from_dict(conf_d), device=device)
        typed = net.vertex_out_types
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf_d), device=device)
        typed = net.input_types
    if not typed:
        raise ValueError("checkpoint configuration has no input type")
    params_t, state_t = net.param_templates()
    net.params = _unflatten_into(params_t, params_flat, net.device)
    net.state = _unflatten_into(state_t, state_flat, net.device)
    net.opt_state = (net.init_opt_state(net.params) if upd_flat is None else
                     _unflatten_into(net.init_opt_state(params_t), upd_flat, net.device))
    if resid_flat is not None:
        net.grad_residual = _unflatten_into(params_t, resid_flat, net.device, lead=True)
    net.iteration = meta.get("iteration", 0)
    net.epoch = meta.get("epoch", 0)
    return net
