"""Typed findings + the rule catalog for graftcheck (docs/STATIC_ANALYSIS.md;
a copy of ``deeplearning4j_tpu/analysis/findings.py``: the same ids and
severities, so a finding's JSON is the reference's).

Every rule has a STABLE id (``GC<family><nn>``) — baselines and inline
pragmas key on it, so ids are append-only: retire a rule by deleting its
checker, never by reusing its number.  Families:

- ``GC0xx`` — meta (suppression hygiene: the analyzer analyzing its own
  pragmas/baseline)
- ``GC1xx`` — JIT purity (host effects inside traced code)
- ``GC2xx`` — determinism (wall clock / global RNG / hash-seed
  dependence on paths that back the bit-identity gates)
- ``GC3xx`` — thread safety (21+ ``threading.Thread`` spawn sites after
  PRs 6-9; lock discipline, teardown joins, acquisition order)
- ``GC4xx`` — repo contracts (span taxonomy, metric naming, nothing-
  stranded futures, justified exception suppression)
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Dict, Optional

ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: str
    summary: str


# the catalog — ids are stable, see module docstring
RULES: Dict[str, Rule] = {r.id: r for r in [
    # meta
    Rule("GC001", "unknown-pragma-rule", WARNING,
         "a `# graftcheck: disable=` pragma names a rule id that does "
         "not exist — the suppression does nothing"),
    Rule("GC002", "pragma-missing-justification", ERROR,
         "a suppression pragma has no `(reason)` — every accepted "
         "finding must say why it is accepted"),
    Rule("GC003", "unused-pragma", WARNING,
         "a suppression pragma matched no finding — stale suppressions "
         "hide future regressions"),
    # JIT purity
    Rule("GC101", "host-sync-in-traced-code", ERROR,
         "`.item()`/`.tolist()`/`.block_until_ready()`/`float()/int()/"
         "bool()` on a traced value inside traced code forces a device "
         "sync per call (or fails under jit)"),
    Rule("GC102", "impure-call-in-traced-code", ERROR,
         "`print`/`time.*`/`random`/`np.random`/env/file I/O inside "
         "traced code runs at TRACE time only — silently frozen into "
         "the compiled program"),
    Rule("GC103", "state-mutation-in-traced-code", ERROR,
         "assigning `self.*`/`global` state inside traced code mutates "
         "host state at trace time, not per step — stale after the "
         "first compile"),
    Rule("GC104", "jit-in-loop", WARNING,
         "`jax.jit(...)` constructed inside a loop body builds a fresh "
         "callable (new cache) per iteration — a recompile hazard"),
    # determinism
    Rule("GC201", "wall-clock", WARNING,
         "`time.time()`/`datetime.now()` is nondeterministic; on a "
         "step/replay/export path it breaks the bit-identity gates — "
         "inject a clock or pragma-tag the site as a wall-anchor"),
    Rule("GC202", "global-rng", WARNING,
         "`random.*`/`np.random.*` global-state RNG (or unseeded "
         "`default_rng()`) is process-lifetime nondeterministic — "
         "thread a seeded generator instead"),
    Rule("GC203", "seed-dependent-hash", WARNING,
         "builtin `hash()` of a str/bytes varies per process "
         "(PYTHONHASHSEED) — never stable across workers or replays"),
    # thread safety
    Rule("GC301", "unlocked-shared-mutation", ERROR,
         "read-modify-write of an attribute shared between a Thread "
         "target and other methods without holding a common lock"),
    Rule("GC302", "non-daemon-thread-without-join", ERROR,
         "a non-daemon thread with no join() on any teardown path "
         "keeps the process alive after main exits"),
    Rule("GC303", "lock-order-cycle", ERROR,
         "two locks are acquired in opposite nesting orders on "
         "different paths — a deadlock waiting for the right schedule"),
    # contracts
    Rule("GC401", "span-name-not-in-taxonomy", ERROR,
         "a span()/instant() name is missing from the "
         "docs/OBSERVABILITY.md taxonomy table — pod timelines become "
         "unreadable and the docs rot"),
    Rule("GC402", "metric-name-convention", ERROR,
         "metric names must be snake_case; counters on the GLOBAL "
         "registry end in `_total` (docs/OBSERVABILITY.md schema)"),
    Rule("GC403", "future-resolution-not-guaranteed", WARNING,
         "a function that resolves futures has an exception path that "
         "neither resolves nor re-raises — the serving \"nothing "
         "stranded\" invariant cannot be shown to hold"),
    Rule("GC404", "silent-exception-swallow", ERROR,
         "`except Exception: pass` (or broader) drops the failure on "
         "the floor — narrow the type, record an obs instant/counter, "
         "or pragma with a justification"),
]}

FAMILIES = {"meta": ("GC0",), "purity": ("GC1",), "determinism": ("GC2",),
            "threads": ("GC3",), "contracts": ("GC4",)}


@dataclass(frozen=True)
class Finding:
    """One analyzer hit.  ``symbol`` is the dotted in-module qualname of
    the enclosing function/class ("" at module level) — baselines match
    on (rule, path, symbol) so they survive line drift."""

    rule: str
    path: str          # repo-relative posix path
    line: int
    col: int
    symbol: str
    message: str
    context: str = ""  # e.g. "traced via jax.jit at nn/multilayer.py:418"

    @property
    def severity(self) -> str:
        r = RULES.get(self.rule)
        return r.severity if r else ERROR

    def key(self):
        return (self.rule, self.path, self.symbol)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["severity"] = self.severity
        return d

    def format(self) -> str:
        ctx = f"  [{self.context}]" if self.context else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"({self.severity}) {self.message}{ctx}")
