"""Versioned model registry with alias pinning and hot-swap (mirrors
``deeplearning4j_tpu/serving/registry.py``).

Versions are immutable once registered; deployment is a pointer move:

    reg = ModelRegistry()
    v1 = reg.load("lenet", "ckpt_v1.zip")     # serializer v1-v4 zips
    v2 = reg.load("lenet", "ckpt_v2.zip")
    reg.set_alias("lenet", "prod", v1)        # pin
    eng = Engine.from_registry(reg, "lenet", "prod").load()
    reg.set_alias("lenet", "prod", v2)        # hot-swap: drains in-flight
    reg.set_alias("lenet", "prod", v1)        # rollback = alias move

``set_alias`` notifies subscribed engines synchronously and returns only
after each has warmed the incoming version, flipped its current pointer
and drained every in-flight batch on the outgoing one.

Lineage: ``register``/``load`` take a ``lineage=`` provenance record
(run, data slice, eval scores, parent version, weights hash), immutable
beside the version; ``rollback_target`` follows it to the last
eval-passing ancestor.  Not ported here: canary promotion
(``set_alias(..., canary=frac)``) and its history.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.device import DeviceLike

#: lineage-record fields every record carries (absent inputs become None)
LINEAGE_FIELDS = ("run_id", "data_fingerprint", "parent_version",
                  "eval_score", "eval_passed", "weights_sha",
                  "checkpoint_path")


class ModelRegistry:
    """name -> {version -> model} and name -> {alias -> version}.
    ``device`` is where ``load`` puts a checkpoint's network (default
    ``cuda``)."""

    def __init__(self, clock=time.monotonic, device: DeviceLike = None):
        self._models: Dict[str, Dict[int, Any]] = {}
        self._aliases: Dict[str, Dict[str, int]] = {}
        self._lock = threading.Lock()
        self.clock = clock
        self.device = device
        self._last_access: Dict[str, float] = {}
        self._subs: Dict[Tuple[str, str], List[Callable[[int, Any], None]]] = {}
        self._paths: Dict[Tuple[str, int], str] = {}
        self._lineage: Dict[Tuple[str, int], dict] = {}

    # -- registration ------------------------------------------------------

    def register(self, name: str, model, version: Optional[int] = None,
                 lineage: Optional[dict] = None) -> int:
        """Register an in-memory model → its version number (the next one
        when not given).  Re-registering a (name, version) raises:
        versions are immutable.  ``lineage`` attaches a provenance record
        (``LINEAGE_FIELDS``; extra keys kept)."""
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version is None:
                version = max(versions, default=0) + 1
            version = int(version)
            if version in versions:
                raise ValueError(f"{name} v{version} already registered — "
                                 "versions are immutable; register a new one")
            versions[version] = model
            if lineage is not None:
                rec = {k: None for k in LINEAGE_FIELDS}
                rec.update(lineage)
                rec["name"] = name
                rec["version"] = version
                self._lineage[(name, version)] = rec
            return version

    def lineage(self, name: str, version: Optional[int] = None):
        """The record of ``version`` (None if it has none), or with
        ``version=None`` every record of ``name``, version-ascending."""
        with self._lock:
            if version is not None:
                rec = self._lineage.get((name, int(version)))
                return dict(rec) if rec is not None else None
            return [dict(self._lineage[(n, v)])
                    for (n, v) in sorted(self._lineage) if n == name]

    def rollback_target(self, name: str,
                        version: Optional[int] = None) -> Optional[int]:
        """The version a failed promotion of ``version`` (default: the
        newest) rolls back to: the nearest eval-passing ancestor along the
        ``parent_version`` chain, else the newest eval-passing older
        version; None when there is none."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise KeyError(f"no model named {name!r} registered")
            start = max(versions) if version is None else int(version)

            def passing(v: int) -> bool:
                rec = self._lineage.get((name, v))
                return bool(rec is not None and rec.get("eval_passed"))

            seen = set()
            rec = self._lineage.get((name, start))
            cur = rec.get("parent_version") if rec is not None else None
            while cur is not None and cur not in seen:
                seen.add(cur)
                cur = int(cur)
                if cur in versions and passing(cur):
                    return cur
                nxt = self._lineage.get((name, cur))
                cur = nxt.get("parent_version") if nxt is not None else None
            for v in sorted(versions, reverse=True):
                if v < start and passing(v):
                    return v
            return None

    def load(self, name: str, path: str, version: Optional[int] = None,
             lineage: Optional[dict] = None) -> int:
        """Load a checkpoint zip (serializer format 1-4) onto the
        registry's device and register it; the path is kept as provenance
        (``models_snapshot``)."""
        from ..utils.serializer import load_model

        model = load_model(path, device=self.device)
        if lineage is not None:
            lineage = dict(lineage)
            lineage.setdefault("checkpoint_path", str(path))
        version = self.register(name, model, version=version, lineage=lineage)
        with self._lock:
            self._paths[(name, version)] = str(path)
        return version

    # -- lookup ------------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def versions(self, name: str) -> List[int]:
        with self._lock:
            return sorted(self._models.get(name, {}))

    def aliases(self, name: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._aliases.get(name, {}))

    def models_snapshot(self) -> Dict[str, dict]:
        """Inventory: every name with its versions, aliases, prod-pinned
        version, a lineage summary, the pinned (or newest) version's
        checkpoint path and the registry-clock stamp of its last
        ``resolve``."""
        with self._lock:
            out: Dict[str, dict] = {}
            for name in sorted(self._models):
                versions = self._models[name]
                aliases = dict(self._aliases.get(name, {}))
                pinned = aliases.get("prod")
                head = pinned if pinned is not None else max(versions)
                recs = [self._lineage[(n, v)]
                        for (n, v) in sorted(self._lineage) if n == name]
                head_rec = self._lineage.get((name, head))
                out[name] = {
                    "versions": sorted(versions),
                    "aliases": aliases,
                    "pinned": pinned,
                    "lineage": {
                        "recorded": len(recs),
                        "eval_passed": sum(1 for r in recs if r.get("eval_passed")),
                        "head": ({"version": head,
                                  "parent_version": head_rec.get("parent_version"),
                                  "eval_passed": head_rec.get("eval_passed"),
                                  "run_id": head_rec.get("run_id")}
                                 if head_rec is not None else None),
                    },
                    "checkpoint_path": self._paths.get((name, head)),
                    "last_access": self._last_access.get(name),
                }
            return out

    def resolve(self, name: str, ref: Any = "latest") -> Tuple[int, Any]:
        """(version, model) for a ref: an int version, ``"latest"``, a
        ``"v<N>"`` string, or an alias."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise KeyError(f"no model named {name!r} registered")
            v = self._resolve_version_locked(name, ref)
            self._last_access[name] = self.clock()
            return v, versions[v]

    def _resolve_version_locked(self, name: str, ref: Any) -> int:
        versions = self._models[name]
        if isinstance(ref, int):
            v = ref
        elif ref == "latest":
            v = max(versions)
        elif isinstance(ref, str) and ref.startswith("v") and ref[1:].isdigit():
            v = int(ref[1:])
        else:
            alias = self._aliases.get(name, {})
            if ref not in alias:
                raise KeyError(
                    f"{name}: unknown version ref {ref!r} (have versions "
                    f"{sorted(versions)}, aliases {sorted(alias)})")
            v = alias[ref]
        if v not in versions:
            raise KeyError(f"{name}: version {v} not registered "
                           f"(have {sorted(versions)})")
        return v

    # -- aliases and hot swap ----------------------------------------------

    def set_alias(self, name: str, alias: str, version: Any) -> Optional[int]:
        """Move ``alias`` to ``version`` and hot-swap every subscribed
        engine, synchronously (returns after the old versions drained) →
        the alias's previous version (None if new).  Rollback is another
        ``set_alias`` to the old version."""
        with self._lock:
            if name not in self._models:
                raise KeyError(f"no model named {name!r} registered")
            version = self._resolve_version_locked(name, version)
            amap = self._aliases.setdefault(name, {})
            prev = amap.get(alias)
            model = self._models[name][version]
            subs = list(self._subs.get((name, alias), ()))
            amap[alias] = version
        if prev != version:
            # outside the lock: a swap blocks on draining in-flight
            # batches, whose replica threads must never need this lock
            for cb in subs:
                cb(version, model)
        return prev

    def subscribe(self, name: str, alias: str,
                  callback: Callable[[int, Any], None]) -> None:
        """Engine hook: ``callback(version, model)`` fires on every
        ``set_alias`` move of (name, alias)."""
        with self._lock:
            self._subs.setdefault((name, alias), []).append(callback)
