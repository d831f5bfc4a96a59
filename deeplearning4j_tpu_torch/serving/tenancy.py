"""Multi-tenant admission: SLO classes, fair-share weights, quotas (a
copy of ``deeplearning4j_tpu/serving/tenancy.py``).

One fleet serves N models for M tenants.  The isolation contract has two halves, both implemented
here and consumed by ``serving/batcher.py``:

* **Quotas (admission)**: each tenant holds a concurrent-request cap
  and an optional QPS token bucket, checked-and-charged ATOMICALLY in
  :meth:`TenantTable.admit` (one critical section — no check-then-act
  window, so racing submits can never over-admit past the cap).  A
  tenant over its own quota sheds with :class:`TenantOverloadedError`,
  which carries the tenant and its shed counter so clients (and the
  429 path in ui/server.py) can tell "my quota" from "fleet overload".
* **Fair share (scheduling)**: each tenant carries a ``weight``; the
  batcher's per-tenant lanes are drained by stride scheduling — always
  the lane with the smallest virtual time ``served_rows / weight`` —
  so a bursting tenant's backlog cannot add queue delay to a victim
  tenant's requests.

A ``TenantConfig`` registers per ``(tenant, model)``; lookup falls
back from the exact pair to the tenant-wide row to the table default,
so one row can cover a tenant's whole zoo with a per-model override
where it matters.  Clocks are injectable: the QPS bucket and
last-activity stamps never read a wall clock.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from ..obs import trace as obs_trace
from .batcher import ADMISSION_POLICIES, OverloadedError


class TenantOverloadedError(OverloadedError):
    """This tenant's own quota (concurrent cap or QPS bucket) is spent —
    the fleet may be idle.  Carries the tenant and its running shed
    count so a 429 can say whose budget ran out."""

    def __init__(self, message: str, tenant: str, shed_count: int,
                 reason: str = "quota"):
        super().__init__(message)
        self.tenant = tenant
        self.shed_count = int(shed_count)
        self.reason = reason


class TenantConfig:
    """Admission/scheduling class for one tenant (optionally scoped to
    one model).  ``slo_ms`` is the default deadline budget for requests
    that do not pass their own; ``weight`` is the fair-share ratio
    (2.0 drains twice the rows per scheduling round of 1.0);
    ``quota_concurrent`` caps queued+in-flight requests;
    ``quota_qps`` refills a token bucket (burst = max(1, quota_qps)
    unless ``burst`` says otherwise).  ``admission`` is what happens at
    the cap: ``"shed"`` raises :class:`TenantOverloadedError`
    synchronously, ``"block"`` backpressures the submitter until a slot
    frees or the engine drains."""

    __slots__ = ("tenant", "model", "slo_ms", "weight", "quota_qps",
                 "quota_concurrent", "admission", "burst")

    def __init__(self, tenant: str, model: Optional[str] = None, *,
                 slo_ms: Optional[float] = None, weight: float = 1.0,
                 quota_qps: Optional[float] = None,
                 quota_concurrent: Optional[int] = None,
                 admission: str = "shed",
                 burst: Optional[float] = None):
        if not tenant:
            raise ValueError("tenant name must be non-empty")
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if slo_ms is not None and slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        if quota_qps is not None and quota_qps <= 0:
            raise ValueError(f"quota_qps must be > 0, got {quota_qps}")
        if quota_concurrent is not None and quota_concurrent < 1:
            raise ValueError(
                f"quota_concurrent must be >= 1, got {quota_concurrent}")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {admission!r}")
        self.tenant = str(tenant)
        self.model = model
        self.slo_ms = float(slo_ms) if slo_ms is not None else None
        self.weight = float(weight)
        self.quota_qps = float(quota_qps) if quota_qps is not None else None
        self.quota_concurrent = (int(quota_concurrent)
                                 if quota_concurrent is not None else None)
        self.admission = admission
        self.burst = (float(burst) if burst is not None
                      else (max(1.0, self.quota_qps)
                            if self.quota_qps is not None else None))

    @classmethod
    def from_dict(cls, d: dict) -> "TenantConfig":
        """Build from one row of a ``--tenants tenants.json`` spec."""
        known = {"tenant", "model", "slo_ms", "weight", "quota_qps",
                 "quota_concurrent", "admission", "burst"}
        extra = set(d) - known
        if extra:
            raise ValueError(
                f"unknown tenant-spec keys {sorted(extra)}; "
                f"known: {sorted(known)}")
        if "tenant" not in d:
            raise ValueError("tenant spec row needs a 'tenant' key")
        kw = {k: v for k, v in d.items() if k not in ("tenant", "model")}
        return cls(d["tenant"], d.get("model"), **kw)

    def to_dict(self) -> dict:
        return {"tenant": self.tenant, "model": self.model,
                "slo_ms": self.slo_ms, "weight": self.weight,
                "quota_qps": self.quota_qps,
                "quota_concurrent": self.quota_concurrent,
                "admission": self.admission}


class _TenantState:
    """Mutable accounting for one tenant (across all its models)."""

    __slots__ = ("concurrent", "admitted", "shed", "completed",
                 "tokens", "token_t")

    def __init__(self):
        self.concurrent = 0
        self.admitted = 0
        self.shed = 0
        self.completed = 0
        self.tokens: Optional[float] = None   # lazily seeded to burst
        self.token_t: Optional[float] = None


class TenantTable:
    """Thread-safe registry of :class:`TenantConfig` rows plus the live
    per-tenant accounting.  One table is shared by every batcher on a
    host (predict + decode), so the concurrent cap really is the
    tenant's host-wide budget.

    Lock ordering: callers (the batchers) hold their own lock when
    calling in; this table's lock is strictly inner and nothing here
    calls back out — no inversion is possible.
    """

    def __init__(self, configs=(), *,
                 default: Optional[TenantConfig] = None,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._configs: Dict[Tuple[str, Optional[str]], TenantConfig] = {}
        self._states: Dict[str, _TenantState] = {}
        self._default = default
        self.clock = clock
        for c in configs:
            self.register(c)

    @classmethod
    def from_specs(cls, rows, **kw) -> "TenantTable":
        """Build from a list of dict rows (the ``tenants.json`` shape)."""
        return cls([TenantConfig.from_dict(r) for r in rows], **kw)

    # -- configuration ---------------------------------------------------

    def register(self, config: TenantConfig) -> None:
        with self._lock:
            self._configs[(config.tenant, config.model)] = config
            self._states.setdefault(config.tenant, _TenantState())

    def resolve(self, tenant: str,
                model: Optional[str] = None) -> Optional[TenantConfig]:
        """Most specific row that covers (tenant, model): the exact
        pair, else the tenant-wide row, else the table default (which
        may be None — an unknown tenant is then unlimited)."""
        with self._lock:
            return self._resolve_locked(tenant, model)

    def _resolve_locked(self, tenant, model):
        c = self._configs.get((tenant, model))
        if c is None and model is not None:
            c = self._configs.get((tenant, None))
        if c is None:
            c = self._default
        return c

    def tenants(self):
        with self._lock:
            return sorted({t for t, _ in self._configs})

    def weight(self, tenant: str) -> float:
        """Fair-share weight for the batcher's stride scheduler; the
        anonymous lane (untagged traffic) weighs 1.0."""
        if not tenant:
            return 1.0
        with self._lock:
            c = self._resolve_locked(tenant, None)
        return c.weight if c is not None else 1.0

    def slo_ms_for(self, tenant: str,
                   model: Optional[str] = None) -> Optional[float]:
        c = self.resolve(tenant, model)
        return c.slo_ms if c is not None else None

    def admission_for(self, tenant: str,
                      model: Optional[str] = None) -> str:
        c = self.resolve(tenant, model)
        return c.admission if c is not None else "shed"

    # -- admission accounting --------------------------------------------

    def try_admit(self, tenant: str, model: Optional[str] = None,
                  now: Optional[float] = None) -> bool:
        """Check-and-charge in ONE critical section: returns True and
        charges the tenant's concurrent slot + QPS token, or returns
        False having charged nothing (the caller sheds or blocks).
        Untagged traffic ("" tenant) is never limited here."""
        if not tenant:
            return True
        now = self.clock() if now is None else now
        with self._lock:
            c = self._resolve_locked(tenant, model)
            s = self._states.setdefault(tenant, _TenantState())
            if c is None:
                s.concurrent += 1
                s.admitted += 1
                return True
            if (c.quota_concurrent is not None
                    and s.concurrent >= c.quota_concurrent):
                return False
            if c.quota_qps is not None:
                if s.tokens is None:
                    s.tokens, s.token_t = c.burst, now
                else:
                    s.tokens = min(c.burst, s.tokens
                                   + (now - s.token_t) * c.quota_qps)
                    s.token_t = now
                if s.tokens < 1.0:
                    return False
                s.tokens -= 1.0
            s.concurrent += 1
            s.admitted += 1
        return True

    def shed(self, tenant: str, model: Optional[str] = None,
             reason: str = "quota") -> TenantOverloadedError:
        """Charge one shed to the tenant and build the typed error the
        caller raises (the error carries the updated counter)."""
        with self._lock:
            s = self._states.setdefault(tenant, _TenantState())
            s.shed += 1
            n = s.shed
        obs_trace.instant("tenant/shed", cat="serve", tenant=tenant,
                          model=model, reason=reason)
        return TenantOverloadedError(
            f"tenant {tenant!r} over its {reason} "
            f"({n} sheds so far); victims are unaffected",
            tenant, n, reason=reason)

    def release(self, tenant: str) -> None:
        """Free the concurrent slot charged by :meth:`try_admit` —
        wired to ``future.add_done_callback``, so the engine invariant
        (every future resolves) guarantees exactly one release."""
        if not tenant:
            return
        with self._lock:
            s = self._states.get(tenant)
            if s is None:
                return
            s.concurrent = max(0, s.concurrent - 1)
            s.completed += 1

    def concurrent(self, tenant: str) -> int:
        with self._lock:
            s = self._states.get(tenant)
            return s.concurrent if s else 0

    def shed_count(self, tenant: str) -> int:
        with self._lock:
            s = self._states.get(tenant)
            return s.shed if s else 0

    def snapshot(self) -> dict:
        """Per-tenant accounting for /metrics: admitted/shed/completed
        counters plus the live concurrent occupancy and config."""
        with self._lock:
            out = {}
            for t, s in sorted(self._states.items()):
                c = self._resolve_locked(t, None)
                out[t] = {
                    "admitted": s.admitted, "shed": s.shed,
                    "completed": s.completed, "concurrent": s.concurrent,
                    "weight": c.weight if c else 1.0,
                    "slo_ms": c.slo_ms if c else None,
                    "quota_qps": c.quota_qps if c else None,
                    "quota_concurrent": (c.quota_concurrent if c
                                         else None),
                }
            return out
