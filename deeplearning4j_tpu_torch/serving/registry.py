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

``set_alias(..., canary=frac)`` promotes through a canary instead: every
subscribed engine mirrors ``frac`` of its live batches to the incoming
version as shadow traffic (users still get the incumbent's results),
compares error rate, p99 and prediction divergence over a decision window
and votes.  The alias moves only if every engine votes promote; otherwise
the promotion rolls back and the alias stays.  The decision, with each
engine's numbers, is returned and kept in ``canary_history``.

Lineage: ``register``/``load`` take a ``lineage=`` provenance record
(run, data slice, eval scores, parent version, weights hash), immutable
beside the version; ``rollback_target`` follows it to the last
eval-passing ancestor.  ``load`` also stamps the checkpoint path on the
model (``_checkpoint_path``), which is how serving finds a version's warm
bundle (``<checkpoint>.warm``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.device import DeviceLike


class CanaryRejectedError(RuntimeError):
    """``set_alias(..., canary=frac, raise_on_reject=True)`` did not
    promote: an engine voted rollback (or its window never filled).
    ``record`` is the decision ``canary_history`` keeps."""

    def __init__(self, record: dict):
        reasons = [r for d in record.get("decisions", ())
                   for r in d.get("reasons", ())]
        super().__init__(
            f"canary rejected {record.get('name')} "
            f"v{record.get('from')} -> v{record.get('to')} on alias "
            f"{record.get('alias')!r}: {'; '.join(reasons) or 'no votes'}")
        self.record = record
        self.name = record.get("name")
        self.alias = record.get("alias")
        self.incumbent = record.get("from")
        self.candidate = record.get("to")
        self.reasons = reasons


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
        # (name, alias) -> [(callback(version, model), canary callback or None)]
        self._subs: Dict[Tuple[str, str],
                         List[Tuple[Callable[[int, Any], None], Optional[Callable]]]] = {}
        self._canary_log: Dict[str, List[dict]] = {}
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
        registry's device and register it.  The path is kept as provenance,
        on the registry (``checkpoint_path``) and on the model
        (``_checkpoint_path``), where serving looks for the warm bundle."""
        from ..utils.serializer import load_model

        model = load_model(path, device=self.device)
        model._checkpoint_path = str(path)
        if lineage is not None:
            lineage = dict(lineage)
            lineage.setdefault("checkpoint_path", str(path))
        version = self.register(name, model, version=version, lineage=lineage)
        with self._lock:
            self._paths[(name, version)] = str(path)
        return version

    def checkpoint_path(self, name: str, ref: Any = "latest") -> Optional[str]:
        """The checkpoint zip a version was loaded from (None for in-memory
        registrations)."""
        with self._lock:
            if name not in self._models:
                return None
            try:
                v = self._resolve_version_locked(name, ref)
            except KeyError:
                return None
            return self._paths.get((name, v))

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

    def list_aliases(self) -> Dict[str, Dict[str, int]]:
        """Every alias pin in the registry, name -> {alias -> version}; a
        name without aliases is left out (the deployable view)."""
        with self._lock:
            return {n: dict(a) for n, a in sorted(self._aliases.items()) if a}

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

    def set_alias(self, name: str, alias: str, version: Any,
                  canary: Optional[float] = None, canary_window: int = 32,
                  canary_timeout_s: float = 60.0,
                  canary_thresholds: Optional[Dict[str, Any]] = None,
                  raise_on_reject: bool = False):
        """Move ``alias`` to ``version`` and hot-swap every subscribed
        engine, synchronously (returns after the old versions drained) →
        the alias's previous version (None if new).  Rollback is another
        ``set_alias`` to the old version.

        With ``canary=frac`` (0 < frac <= 1) the move goes through a canary
        first: each subscribed engine mirrors ``frac`` of its live batches
        to the incoming version over ``canary_window`` mirrored batches
        (bounded by ``canary_timeout_s``), judged by ``canary_thresholds``
        (``max_error_rate``, ``p99_factor``, ``max_divergence``: see
        ``Engine.run_canary``).  The alias moves only if every engine votes
        promote.  Returns the decision record (kept in ``canary_history``)
        instead of the previous version; with ``raise_on_reject`` a
        rejection raises ``CanaryRejectedError`` carrying the record.  A
        first pin or a move to the same version goes directly."""
        with self._lock:
            if name not in self._models:
                raise KeyError(f"no model named {name!r} registered")
            version = self._resolve_version_locked(name, version)
            amap = self._aliases.setdefault(name, {})
            prev = amap.get(alias)
            model = self._models[name][version]
            subs = list(self._subs.get((name, alias), ()))
            canary_pairs = [(cb, c) for cb, c in subs if c is not None]
            run_canary = (canary is not None and prev is not None
                          and prev != version and canary_pairs)
            if not run_canary:
                amap[alias] = version
        if run_canary:
            # the alias has not moved: engines judge the candidate on
            # shadow traffic first, outside the lock (the window is live
            # serving time)
            thresholds = dict(canary_thresholds or {})
            decisions = [c(version, model, frac=canary, window=canary_window,
                           timeout_s=canary_timeout_s, **thresholds)
                         for _, c in canary_pairs]
            promoted = all(d.get("promote") for d in decisions)
            record = {"name": name, "alias": alias, "from": prev, "to": version,
                      "promoted": promoted, "decisions": decisions}
            with self._lock:
                self._canary_log.setdefault(name, []).append(record)
                if promoted:
                    self._aliases[name][alias] = version
                incumbent_model = self._models[name][prev]
            if promoted:
                # the canary engines swapped inside run_canary; plain
                # subscribers still need the swap
                for cb, canary_cb in subs:
                    if canary_cb is None:
                        cb(version, model)
            else:
                # an engine that voted promote has already swapped: swap it
                # back so every engine serves the alias's version
                for (cb, _), d in zip(canary_pairs, decisions):
                    if d.get("promote"):
                        cb(prev, incumbent_model)
                if raise_on_reject:
                    raise CanaryRejectedError(record)
            return record
        if prev != version:
            # outside the lock: a swap blocks on draining in-flight
            # batches, whose replica threads must never need this lock
            for cb, _ in subs:
                cb(version, model)
        return prev

    def canary_history(self, name: str) -> List[dict]:
        """Every canary decision recorded for ``name``."""
        with self._lock:
            return list(self._canary_log.get(name, ()))

    def subscribe(self, name: str, alias: str,
                  callback: Callable[[int, Any], None],
                  canary: Optional[Callable] = None) -> None:
        """Engine hook: ``callback(version, model)`` fires on every
        ``set_alias`` move of (name, alias); ``canary(version, model,
        frac=, window=, timeout_s=, **thresholds)``, when given, judges a
        ``set_alias(..., canary=frac)`` and returns the decision dict
        (``Engine.run_canary``'s)."""
        with self._lock:
            self._subs.setdefault((name, alias), []).append((callback, canary))
