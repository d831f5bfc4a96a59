"""Zero-cold-start plumbing: the persistent kernel-build cache and the
serving engines' warm-up bundles (mirrors
``deeplearning4j_tpu/serving/warmcache.py``).

``enable_compile_cache(cache_dir)`` is the port's counterpart of the
reference's persistent JAX compile cache.  What the port compiles ahead
of use is its CUDA C++ kernels: ``utils/cuda_build.py`` builds each
``csrc/*.cu`` with ``nvcc`` into one shared library whose name carries a
digest of the source, the headers and the flags.  The cache is that
build directory: pointed at a shared ``DIR``, a respawned serve host, a
``launch`` worker or the next run finds every library already built and
skips ``nvcc``.  Library writes are atomic (a temp file renamed over the
target), so a process killed mid-build never leaves half a library.
Nothing else is cached: a CUDA graph cannot be saved, and the engines
capture theirs at ``load()``.

The reference serializes its ahead-of-time XLA executables into a zip
next to the checkpoint (``model.zip`` → ``model.zip.warm``), so a fresh
process deserializes instead of compiling.  A CUDA graph cannot be
serialized, so the port's bundle NAMES the graphs a ``load()`` captures
and does not hold them: one entry per (bucket, input dtype) pair, with
the per-example shape it was captured at.  The zip keeps the reference's
layout: a ``meta.json`` with the format version, tag, device fingerprint
and torch version, a sha256 digest per entry, and an atomic write (a temp
file renamed over the target).

A bundle saves no capture time: the engine captures every pair either
way and counts each pair the bundle named in ``bundle_hits`` and every
other one in ``bundle_misses``, as the reference counts deserialized and
compiled executables.  ``load_bundle`` never raises: an absent file is the
normal first run and stays silent; an unusable one (truncated or corrupt
zip, a digest, fingerprint, tag, format or torch-version mismatch, a
reference bundle) warns exactly once and returns ``{}``, so the engine
captures as if there were no bundle.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
import zipfile
from typing import Any, Dict, Optional

import torch

BUNDLE_FORMAT = "deeplearning4j_tpu_torch.cuda_graphs"
BUNDLE_FORMAT_VERSION = 1
BUNDLE_SUFFIX = ".warm"

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")


def _csrc_digest() -> str:
    """sha256 over the kernel sources' names and bytes: a bundle captured
    against other kernels names graphs this build would capture
    differently."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(_CSRC)):
        h.update(name.encode())
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


ENV_VAR = "DL4J_TPU_COMPILE_CACHE"

_enabled_dir: Optional[str] = None


def enable_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Build the kernels into (and load them from) a persistent
    directory, process-wide.  An explicit ``cache_dir`` wins, then the
    ``DL4J_TPU_COMPILE_CACHE`` variable; with neither this is a no-op
    returning None.  The variable is exported, so ``launch``'s workers
    and any subprocess inherit the directory (``utils/cuda_build.py``
    reads it when imported).  Idempotent; returns the absolute path."""
    global _enabled_dir
    d = cache_dir or os.environ.get(ENV_VAR)
    if not d:
        return None
    d = os.path.abspath(d)
    if _enabled_dir == d:
        return d
    from pathlib import Path

    from ..utils import cuda_build

    os.makedirs(d, exist_ok=True)
    cuda_build.BUILD_DIR = Path(d)
    os.environ[ENV_VAR] = d
    _enabled_dir = d
    return d


def device_fingerprint(device: Optional[torch.device] = None,
                       mesh: Optional[Any] = None) -> str:
    """Identity of the device set a bundle's graphs were captured on: the
    card's name, the card count, its compute capability, the torch and
    CUDA versions, and a digest of the kernel sources (``cpu`` and no
    capability on the CPU).  ``mesh`` (a tensor-parallel decode
    program's) appends ``mesh(axis=size,...)``, so a bundle of one
    topology is refused by a process whose mesh differs."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if device.type == "cuda":
        idx = device.index if device.index is not None else torch.cuda.current_device()
        cap = torch.cuda.get_device_capability(idx)
        parts = [torch.cuda.get_device_name(idx), str(torch.cuda.device_count()),
                 f"sm_{cap[0]}{cap[1]}"]
    else:
        parts = ["cpu", "1", "none"]
    parts += [torch.__version__, str(torch.version.cuda), _csrc_digest()]
    if mesh is not None:
        axes = ",".join(f"{n}={int(k)}" for n, k in dict(mesh.shape).items())
        parts.append(f"mesh({axes})")
    return "|".join(parts)


def bundle_path_for(checkpoint_path: str) -> str:
    """The bundle's place: next to the checkpoint zip."""
    return str(checkpoint_path) + BUNDLE_SUFFIX


def save_bundle(path: str, tag: str, entries: Dict[str, dict],
                device: Optional[torch.device] = None,
                mesh: Optional[Any] = None) -> str:
    """Write ``entries`` ({key: JSON-able description of one graph}) to
    ``path`` as a bundle for ``tag`` captured on ``device`` (over
    ``mesh``, for a sharded decode program); atomic."""
    names, blobs = {}, {}
    for i, key in enumerate(sorted(entries)):
        ename = f"graph_{i}.json"
        names[ename] = key
        blobs[ename] = json.dumps(entries[key], sort_keys=True).encode()
    meta = {
        "format": BUNDLE_FORMAT,
        "format_version": BUNDLE_FORMAT_VERSION,
        "tag": tag,
        "fingerprint": device_fingerprint(device, mesh),
        "torch_version": torch.__version__,
        "entries": names,
        "integrity": {e: hashlib.sha256(b).hexdigest() for e, b in blobs.items()},
    }
    tmp = str(path) + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=2))
        for ename, blob in blobs.items():
            z.writestr(ename, blob)
    os.replace(tmp, path)
    return str(path)


class _BundleMiss(Exception):
    """Why a bundle cannot be used."""


def load_bundle(path: Optional[str], tag: Optional[str] = None,
                device: Optional[torch.device] = None,
                mesh: Optional[Any] = None) -> Dict[str, dict]:
    """The bundle's entries ({key: description}), or ``{}`` on any miss;
    never raises.  An absent file is silent; an unusable one warns once
    with the reason (``RuntimeWarning``).  ``mesh`` must be the one the
    bundle was saved with."""
    if not path or not os.path.exists(path):
        return {}
    try:
        with zipfile.ZipFile(path, "r") as z:
            meta = json.loads(z.read("meta.json"))
            if meta.get("format") != BUNDLE_FORMAT:
                raise _BundleMiss(f"format {meta.get('format')!r} is not "
                                  f"{BUNDLE_FORMAT!r} (another package's bundle)")
            if meta.get("format_version") != BUNDLE_FORMAT_VERSION:
                raise _BundleMiss(f"format_version {meta.get('format_version')!r}")
            if tag is not None and meta.get("tag") != tag:
                raise _BundleMiss(f"tag {meta.get('tag')!r} != wanted {tag!r}")
            if meta.get("torch_version") != torch.__version__:
                raise _BundleMiss(f"torch {meta.get('torch_version')!r} != "
                                  f"{torch.__version__!r}")
            fp = device_fingerprint(device, mesh)
            if meta.get("fingerprint") != fp:
                raise _BundleMiss(f"device fingerprint {meta.get('fingerprint')!r} != {fp!r}")
            integrity = meta.get("integrity", {})
            out = {}
            for ename, key in meta.get("entries", {}).items():
                blob = z.read(ename)
                if integrity.get(ename) != hashlib.sha256(blob).hexdigest():
                    raise _BundleMiss(f"integrity mismatch on {ename}")
                out[key] = json.loads(blob)
            return out
    except Exception as exc:  # the contract: an unusable bundle means capture as usual
        warnings.warn(f"warmup bundle {path!r} unusable ({exc!r}); falling back to "
                      "capture", RuntimeWarning, stacklevel=2)
        return {}
