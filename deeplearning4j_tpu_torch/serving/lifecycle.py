"""The production flywheel: continuous train→eval→canary→fleet-promote.

Every prior layer proved train and serve in isolation; this controller
runs the full lifecycle end-to-end and *repeatedly* (docs/LIFECYCLE.md):

    TRAIN ──▶ EVAL ──▶ REGISTER ──▶ CANARY ──▶ ROLL ──▶ PROMOTED
                │                      │          │
                └──────────────────────┴──────────┴────▶ ROLLED_BACK

* **TRAIN** — launch/resume a training run.  ``train_fn(generation)``
  returns an :class:`~..parallel.elastic.ElasticTrainer` (its
  ``run_id`` / ``final_checkpoint_path`` seam stamps lineage without
  filename parsing), or a ``{"model": ..., "run_id": ...,
  "checkpoint_path": ...}`` dict, or a bare model.
* **EVAL** — an explicit-threshold gate (:class:`EvalGate`) over the
  ``earlystopping`` score calculators; a non-finite score fails the
  gate by construction (the InvalidScore guard for NaN-params runs).
* **REGISTER** — the version lands in the :class:`ModelRegistry` with
  a **lineage** provenance record (run id, data-slice fingerprint,
  parent version, eval score, weights sha); eval *failures* are also
  registered — flagged ``eval_passed=False`` — as an audit trail, and
  ``ModelRegistry.rollback_target`` skips them.  The warm bundle is
  built here, at save time (PR 15 seam), so every later swap
  deserializes instead of compiling.
* **CANARY** — ``set_alias(..., canary=frac, raise_on_reject=True)``:
  subscribed engines judge the candidate on mirrored live traffic; a
  rejection surfaces as a typed :class:`CanaryRejectedError`.
* **ROLL** — ``FleetRouter.rolling_swap(warm_bundle=)`` rolls the
  version host-by-host under live traffic; a mid-roll host death
  aborts the generation (the fleet machinery already rolled the
  survivors back).
* **ROLLED_BACK** — any failure re-aliases to the registry's
  *lineage-selected* rollback target (the last eval-passing ancestor,
  not version−1) and re-rolls the fleet if it is not already serving
  that version.

Every stage runs with bounded retries and a per-stage wall-clock
deadline, journaling progress to an append-only JSON-lines
:class:`PipelineJournal` — a crash of the controller *itself* resumes
mid-flywheel from the journal (same discipline as ElasticTrainer's
checkpoint-resume).  ``pipeline/*`` spans and a ``lifecycle`` metrics
collector make the flywheel observable.

This is the port of ``deeplearning4j_tpu/serving/lifecycle.py``: the
same state machine, journal format, metrics and spans, over the port's
``ModelRegistry``, ``Engine`` and ``FleetRouter``.  A warm bundle names
the graphs a host captures (``serving/warmcache.py``), and
``weights_sha`` renders the parameter tree's structure as
``jax.tree_util`` prints it, so a model whose weights were carried across
packages hashes to the reference's digest.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..obs.metrics import get_registry
from .registry import CanaryRejectedError, ModelRegistry

logger = logging.getLogger("deeplearning4j_tpu_torch")

# -- the typed state machine -------------------------------------------------

TRAIN = "TRAIN"
EVAL = "EVAL"
REGISTER = "REGISTER"
CANARY = "CANARY"
ROLL = "ROLL"
PROMOTED = "PROMOTED"
ROLLED_BACK = "ROLLED_BACK"

#: stage execution order; terminals are PROMOTED / ROLLED_BACK
STAGE_ORDER = (TRAIN, EVAL, REGISTER, CANARY, ROLL)
TERMINAL_STATES = (PROMOTED, ROLLED_BACK)


class PipelineStageError(RuntimeError):
    """A pipeline stage failed for good (retries exhausted, deadline
    blown, or a roll that reported failure) — the generation rolls
    back."""

    def __init__(self, stage: str, generation: int, reason: str):
        super().__init__(f"generation {generation} {stage}: {reason}")
        self.stage = stage
        self.generation = generation
        self.reason = reason


class StageDeadlineError(PipelineStageError):
    """A stage exceeded its wall-clock deadline budget."""


# -- provenance helpers ------------------------------------------------------

def _structure(tree) -> str:
    """A parameter tree's structure as ``jax.tree_util.tree_structure``
    prints it inside ``PyTreeDef(...)``: dicts with their keys sorted and
    ``repr``-ed, lists ``[...]``, tuples ``(...)`` (one element ``(*,)``),
    None ``None``, every other value a leaf ``*``."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "*"


def _leaves(tree) -> list:
    """The leaves in ``jax.tree_util`` order (dict keys sorted; None holds
    none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _leaf_bytes(leaf):
    """(dtype name, shape, raw bytes) of an array or tensor, as numpy names
    them (a bfloat16 tensor's raw bytes under ``bfloat16``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        dtype = str(t.dtype).replace("torch.", "")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return dtype, tuple(t.shape), raw.numpy().tobytes()
    arr = np.asarray(leaf)
    return str(arr.dtype), arr.shape, arr.tobytes()


def weights_sha(model) -> str:
    """Content hash ("git of weights") of a model's parameters:
    sha256 over the tree structure plus every leaf's dtype/shape/bytes
    in tree order.  Two versions with identical weights hash identically
    regardless of which checkpoint file they came from, and in either
    package."""
    h = hashlib.sha256()
    h.update(f"PyTreeDef({_structure(model.params)})".encode())
    for leaf in _leaves(model.params):
        dtype, shape, raw = _leaf_bytes(leaf)
        h.update(dtype.encode())
        h.update(str(shape).encode())
        h.update(raw)
    return h.hexdigest()


def data_fingerprint(*slices) -> str:
    """Fingerprint of the data slice a run trained/evaluated on: sha256
    over each slice's arrays (ndarrays directly; DataSet-likes via
    their features/labels).  Stamped into lineage so "which data
    produced this version" is answerable from the registry."""
    h = hashlib.sha256()

    def eat(a) -> None:
        if a is None:
            return
        arr = np.asarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())

    for s in slices:
        if hasattr(s, "features"):
            eat(s.features)
            eat(getattr(s, "labels", None))
        else:
            eat(s)
    return h.hexdigest()[:16]


# -- the eval gate -----------------------------------------------------------

class EvalGate:
    """Explicit-threshold eval gate over an ``earlystopping`` score
    calculator (``DataSetLossCalculator``, ``AccuracyScoreCalculator``,
    or anything with ``calculate_score(model) -> float``).

    ``minimize`` inherits the calculator's ``minimize_score`` direction
    when omitted.  A non-finite score always fails — the
    InvalidScoreIterationTerminationCondition semantics applied at the
    gate, which is what catches a NaN-params run before it ever
    reaches a canary."""

    def __init__(self, calculator, threshold: float,
                 minimize: Optional[bool] = None):
        self.calculator = calculator
        self.threshold = float(threshold)
        self.minimize = (bool(getattr(calculator, "minimize_score", True))
                         if minimize is None else bool(minimize))

    def check(self, model) -> dict:
        """→ ``{"score", "passed", "reason"}`` (reason None on pass)."""
        score = float(self.calculator.calculate_score(model))
        if not math.isfinite(score):
            return {"score": score, "passed": False,
                    "reason": f"non-finite eval score {score!r} "
                              "(invalid-score guard)"}
        passed = (score <= self.threshold if self.minimize
                  else score >= self.threshold)
        reason = None if passed else (
            f"eval score {score:.6g} "
            f"{'above' if self.minimize else 'below'} "
            f"threshold {self.threshold:.6g}")
        return {"score": score, "passed": bool(passed), "reason": reason}


# -- the persistent journal --------------------------------------------------

class PipelineJournal:
    """Append-only JSON-lines journal of pipeline progress.

    Each ``append`` writes one fsynced line, so a controller crash
    leaves at worst a torn FINAL line; ``replay`` drops it (with a
    warning) and returns every intact record — the resume contract
    mirrors CheckpointManager's atomic-write discipline, scaled down
    to one line per state transition."""

    def __init__(self, path: str):
        self.path = str(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def append(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def replay(self) -> List[dict]:
        if not os.path.exists(self.path):
            return []
        out: List[dict] = []
        with open(self.path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                # a torn line can only be the last (appends are fsynced
                # in order); anything else is corruption worth hearing
                # about — either way the intact prefix is the truth
                logger.warning("journal %s: dropping unparsable line %d "
                               "(%r)", self.path, i + 1, line[:80])
        return out


def _normalize_train_result(res: Any, generation: int) -> dict:
    """Accept the three train_fn return shapes (ElasticTrainer / dict /
    bare model) and normalize to one record."""
    if isinstance(res, dict):
        return {"model": res["model"],
                "run_id": res.get("run_id") or f"gen{generation}",
                "checkpoint_path": res.get("checkpoint_path"),
                "ckpt_manager": res.get("checkpoint_manager")}
    if hasattr(res, "run_id") and hasattr(res, "net"):
        # the ElasticTrainer seam: run_id + final checkpoint, no
        # filename parsing
        return {"model": res.net, "run_id": res.run_id,
                "checkpoint_path": res.final_checkpoint_path,
                "ckpt_manager": getattr(res, "ckpt", None)}
    return {"model": res, "run_id": f"gen{generation}",
            "checkpoint_path": getattr(res, "_checkpoint_path", None),
            "ckpt_manager": None}


class PromotionPipeline:
    """The flywheel controller (module docstring has the state machine).

    >>> pipe = PromotionPipeline(registry, fleet, "m", train_fn, gate,
    ...                          journal_path="runs/pipeline.jsonl")
    >>> reports = pipe.run(generations=5)

    ``train_fn(generation)`` produces the candidate (see
    ``_normalize_train_result`` for accepted shapes).  ``fleet`` may be
    None for a canary-only deployment (promotion ends at the alias
    flip).  A second controller constructed over the same
    ``journal_path`` resumes mid-flywheel: completed generations are
    skipped, a partially-complete generation continues from its first
    unfinished stage (TRAIN results are recovered from the journaled
    checkpoint path — never retrained).

    ``stage_retries`` / ``stage_deadline_s`` take a single value or a
    per-stage dict ({"TRAIN": 2, ...}).  Deadlines are wall-clock
    budgets checked when the stage completes (hang detection *inside* a
    stage belongs to the stage's own machinery, e.g. ElasticTrainer's
    ``step_timeout``).  ``stage_hook(stage, generation)`` is the
    chaos/test seam, called before each stage attempt — raising from it
    simulates a controller crash mid-flywheel.
    """

    def __init__(self, registry: ModelRegistry, fleet, name: str,
                 train_fn: Callable[[int], Any], eval_gate: EvalGate, *,
                 alias: str = "prod",
                 journal_path: str,
                 canary_frac: float = 0.2,
                 canary_window: int = 32,
                 canary_timeout_s: float = 60.0,
                 canary_thresholds: Optional[Dict[str, Any]] = None,
                 build_warm_bundle: bool = True,
                 bundle_engine_kwargs: Optional[Dict[str, Any]] = None,
                 stage_retries: Any = 1,
                 stage_deadline_s: Any = None,
                 drain_timeout_s: float = 30.0,
                 data_slice: Any = None,
                 loader: Optional[Callable[[str], Any]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 stage_hook: Optional[Callable[[str, int], None]] = None):
        self.registry = registry
        self.fleet = fleet
        self.name = name
        self.alias = alias
        self.train_fn = train_fn
        self.eval_gate = eval_gate
        self.journal = PipelineJournal(journal_path)
        self.canary_frac = canary_frac
        self.canary_window = canary_window
        self.canary_timeout_s = canary_timeout_s
        self.canary_thresholds = dict(canary_thresholds or {})
        self.build_warm_bundle = build_warm_bundle
        self.bundle_engine_kwargs = dict(bundle_engine_kwargs
                                         or {"max_batch": 8, "replicas": 1,
                                             "slo_ms": 30_000.0})
        self._retries = stage_retries
        self._deadlines = stage_deadline_s
        self.drain_timeout_s = drain_timeout_s
        # the data slice this pipeline trains/evals on — a fingerprint
        # string, arrays/DataSets (fingerprinted once), or a callable
        # (generation -> either), stamped into every lineage record
        self.data_slice = data_slice
        self.loader = loader or self._default_loader
        self.clock = clock
        self.stage_hook = stage_hook

        self._resumed = False
        self._completed: Dict[int, dict] = {}    # gen -> terminal record
        self._partial: Optional[dict] = None     # in-flight gen state
        self._history: List[dict] = []           # this controller's reports
        self._current: Optional[dict] = None     # live {gen, stage} view

        reg = get_registry()
        self._m_generations = reg.counter("pipeline_generations_total")
        self._m_promoted = reg.counter("pipeline_promoted_total")
        self._m_rolled_back = reg.counter("pipeline_rolled_back_total")
        self._m_canary_rej = reg.counter("pipeline_canary_rejected_total")
        self._m_eval_failed = reg.counter("pipeline_eval_failed_total")
        self._m_retries = reg.counter("pipeline_stage_retries_total")
        self._m_resumes = reg.counter("pipeline_resumes_total")
        self.resumes = 0
        reg.register_collector("lifecycle", self.stats, unique=True)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Structured flywheel state (the ``lifecycle`` collector)."""
        outcomes = [r.get("outcome") for r in self._completed.values()]
        return {"name": self.name, "alias": self.alias,
                "generations_done": len(self._completed),
                "promoted": outcomes.count(PROMOTED),
                "rolled_back": outcomes.count(ROLLED_BACK),
                "resumes": self.resumes,
                "current": dict(self._current) if self._current else None}

    @property
    def completed(self) -> Dict[int, dict]:
        """Terminal records by generation number (a copy)."""
        return dict(self._completed)

    # -- configuration helpers ---------------------------------------------

    def _default_loader(self, path: str):
        """A journaled checkpoint, loaded onto the registry's device."""
        from ..utils.serializer import load_model
        model = load_model(path, device=self.registry.device)
        model._checkpoint_path = str(path)
        return model

    def _per_stage(self, spec: Any, stage: str, default: Any):
        if isinstance(spec, dict):
            return spec.get(stage, default)
        return default if spec is None else spec

    def _data_fingerprint(self, generation: int) -> Optional[str]:
        s = self.data_slice
        if callable(s):
            s = s(generation)
        if s is None or isinstance(s, str):
            return s
        if isinstance(s, (list, tuple)):
            return data_fingerprint(*s)
        return data_fingerprint(s)

    # -- journal replay / resume -------------------------------------------

    def resume(self) -> dict:
        """Replay the journal and rebuild flywheel state; called
        implicitly by ``run``/``run_generation`` on first use.  Returns
        ``{"completed": [...], "partial": gen|None}``."""
        records = self.journal.replay()
        self._completed.clear()
        partial: Dict[int, dict] = {}
        for rec in records:
            g = int(rec.get("gen", 0))
            stage = rec.get("stage")
            if stage in TERMINAL_STATES:
                partial.pop(g, None)
                rec = dict(rec)
                rec["outcome"] = stage
                self._completed[g] = rec
                continue
            if rec.get("status") != "done":
                continue
            st = partial.setdefault(g, self._fresh_state(g))
            st["done"].append(stage)
            for k in ("run_id", "checkpoint_path", "eval_score",
                      "eval_passed", "eval_reason", "version",
                      "parent_version", "weights_sha", "bundle_path"):
                if k in rec:
                    st[k] = rec[k]
        self._partial = (partial[max(partial)] if partial else None)
        was_fresh = not records
        self._resumed = True
        if not was_fresh:
            self.resumes += 1
            self._m_resumes.inc()
            obs_trace.instant("pipeline/resume", cat="pipeline",
                              completed=len(self._completed),
                              partial=(self._partial or {}).get("gen"))
        return {"completed": sorted(self._completed),
                "partial": (self._partial or {}).get("gen")}

    def _ensure_resumed(self) -> None:
        if not self._resumed:
            self.resume()

    def _fresh_state(self, gen: int) -> dict:
        return {"gen": gen, "done": [], "model": None, "ckpt_manager": None,
                "run_id": None, "checkpoint_path": None,
                "eval_score": None, "eval_passed": None, "eval_reason": None,
                "version": None, "parent_version": None,
                "weights_sha": None, "bundle_path": None}

    def _next_generation_number(self) -> int:
        gens = list(self._completed)
        if self._partial is not None:
            gens.append(self._partial["gen"])
        return max(gens, default=0) + 1

    # -- stage machinery ---------------------------------------------------

    def _journal_done(self, st: dict, stage: str, **fields) -> None:
        st["done"].append(stage)
        rec = {"gen": st["gen"], "stage": stage, "status": "done"}
        rec.update(fields)
        self.journal.append(rec)

    def _attempt(self, st: dict, stage: str, fn: Callable[[], Any],
                 no_retry: tuple = ()) -> Any:
        """One stage body under the retry budget + deadline.  Exceptions
        in ``no_retry`` (verdicts, not faults) propagate immediately."""
        retries = int(self._per_stage(self._retries, stage, 1))
        deadline = self._per_stage(self._deadlines, stage, None)
        attempt = 0
        while True:
            attempt += 1
            self._current = {"gen": st["gen"], "stage": stage,
                             "attempt": attempt}
            if self.stage_hook is not None:
                # the chaos seam runs OUTSIDE the retry try: a raise here
                # is a controller crash, not a stage failure
                self.stage_hook(stage, st["gen"])
            t0 = self.clock()
            try:
                with obs_trace.span("pipeline/stage", cat="pipeline",
                                    stage=stage, generation=st["gen"],
                                    attempt=attempt):
                    out = fn()
                elapsed = self.clock() - t0
                if deadline is not None and elapsed > float(deadline):
                    raise StageDeadlineError(
                        stage, st["gen"],
                        f"took {elapsed:.2f}s > deadline {deadline:.2f}s")
                return out
            except no_retry:
                raise
            except Exception as exc:
                if attempt > retries:
                    if isinstance(exc, PipelineStageError):
                        raise
                    raise PipelineStageError(
                        stage, st["gen"],
                        f"failed after {attempt} attempts: "
                        f"{type(exc).__name__}: {exc}") from exc
                logger.warning("pipeline %s gen %d attempt %d failed: %s — "
                               "retrying", stage, st["gen"], attempt, exc)
                obs_trace.instant("pipeline/retry", cat="pipeline",
                                  stage=stage, generation=st["gen"],
                                  attempt=attempt)
                self._m_retries.inc()

    def _model_for(self, st: dict):
        """The generation's candidate model, recovered on resume from
        the journaled checkpoint (never retrained) or the registry."""
        if st["model"] is not None:
            return st["model"]
        if st["version"] is not None:
            try:
                st["model"] = self.registry.resolve(self.name,
                                                    st["version"])[1]
                return st["model"]
            # graftcheck: disable=GC403 (registry.resolve is a model-version lookup, not a future resolution; fresh-process resume falls through to the checkpoint on disk)
            except KeyError:
                pass
        if st["checkpoint_path"]:
            st["model"] = self.loader(st["checkpoint_path"])
            return st["model"]
        raise PipelineStageError(
            st.get("_stage", EVAL), st["gen"],
            "no model recoverable: journal has neither a registered "
            "version nor a checkpoint path")

    # -- stages ------------------------------------------------------------

    def _do_train(self, st: dict) -> None:
        if TRAIN in st["done"]:
            return
        res = self._attempt(st, TRAIN,
                            lambda: self.train_fn(st["gen"]))
        tr = _normalize_train_result(res, st["gen"])
        st["model"] = tr["model"]
        st["run_id"] = tr["run_id"]
        st["checkpoint_path"] = tr["checkpoint_path"]
        st["ckpt_manager"] = tr["ckpt_manager"]
        self._journal_done(st, TRAIN, run_id=st["run_id"],
                           checkpoint_path=st["checkpoint_path"])

    def _do_eval(self, st: dict) -> None:
        if EVAL in st["done"]:
            return
        verdict = self._attempt(
            st, EVAL, lambda: self.eval_gate.check(self._model_for(st)))
        st["eval_score"] = verdict["score"]
        st["eval_passed"] = verdict["passed"]
        st["eval_reason"] = verdict["reason"]
        if not verdict["passed"]:
            self._m_eval_failed.inc()
        self._journal_done(st, EVAL, eval_score=st["eval_score"],
                           eval_passed=st["eval_passed"],
                           eval_reason=st["eval_reason"])

    def _do_register(self, st: dict) -> None:
        if REGISTER in st["done"] and st["version"] is not None \
                and st["version"] in self.registry.versions(self.name):
            return

        def register():
            # idempotency across crash-resume: the run may already have
            # landed (crash between registry call and journal append)
            sha = st["weights_sha"] or weights_sha(self._model_for(st))
            st["weights_sha"] = sha
            for rec in self.registry.lineage(self.name):
                if rec.get("run_id") == st["run_id"] \
                        and rec.get("weights_sha") == sha:
                    return rec["version"], rec.get("parent_version")
            try:
                parent = self.registry.resolve(self.name, self.alias)[0]
            # graftcheck: disable=GC403 (registry.resolve is a model-version lookup, not a future resolution; no alias yet means no parent)
            except KeyError:
                parent = None
            lineage = {"run_id": st["run_id"],
                       "data_fingerprint":
                           self._data_fingerprint(st["gen"]),
                       "parent_version": parent,
                       "eval_score": st["eval_score"],
                       "eval_passed": st["eval_passed"],
                       "weights_sha": sha}
            if st["checkpoint_path"]:
                v = self.registry.load(self.name, st["checkpoint_path"],
                                       version=st["version"],
                                       lineage=lineage)
            else:
                v = self.registry.register(self.name, self._model_for(st),
                                           version=st["version"],
                                           lineage=lineage)
            return v, parent

        st["version"], st["parent_version"] = self._attempt(
            st, REGISTER, register)
        # downstream stages serve the REGISTRY's copy (it carries the
        # checkpoint provenance canary/bundle seams key on)
        st["model"] = self.registry.resolve(self.name, st["version"])[1]
        ckpt_mgr = st.get("ckpt_manager")
        if ckpt_mgr is not None and st["checkpoint_path"] \
                and hasattr(ckpt_mgr, "note_registered"):
            ckpt_mgr.note_registered(st["checkpoint_path"], self.name,
                                     st["version"])
        if self.build_warm_bundle and st["checkpoint_path"] \
                and st["eval_passed"]:
            st["bundle_path"] = self._build_bundle(st)
        self._journal_done(st, REGISTER, version=st["version"],
                           parent_version=st["parent_version"],
                           weights_sha=st["weights_sha"],
                           bundle_path=st["bundle_path"])

    def _build_bundle(self, st: dict) -> Optional[str]:
        """Warm bundle at save time: load the candidate ONCE here,
        pipeline-side, on the model's device, and write the bundle that
        names the (bucket, dtype) graphs it captured, so every fleet
        host's swap counts bundle hits (``serving/warmcache.py``)."""
        from . import warmcache
        from .engine import Engine

        path = warmcache.bundle_path_for(st["checkpoint_path"])
        if os.path.exists(path):
            return path
        tag = f"{self.name}:v{st['version']}"
        model = self._model_for(st)
        kw = dict(self.bundle_engine_kwargs)
        kw.setdefault("device", getattr(model, "device", None))
        eng = Engine(model, **kw)
        try:
            eng.load()
            # the bundle tag must match the tag hosts swap under, or
            # the load-side tag check rejects it
            with eng._vlock:
                eng._current.tag = tag
            return eng.save_warmup_bundle(path)
        except Exception as exc:
            # bundle building is an optimization: a model the Engine
            # can't warm still promotes, its hosts count bundle misses
            logger.warning("warm-bundle build failed for %s (%s) — hosts "
                           "will capture without one", tag, exc)
            return None
        finally:
            eng.shutdown()

    def _do_canary(self, st: dict) -> None:
        v = st["version"]
        try:
            cur = self.registry.resolve(self.name, self.alias)[0]
        # graftcheck: disable=GC403 (registry.resolve is a model-version lookup, not a future resolution; no alias yet means no incumbent)
        except KeyError:
            cur = None
        if CANARY in st["done"] or cur == v:
            return
        self._attempt(
            st, CANARY,
            lambda: self.registry.set_alias(
                self.name, self.alias, v,
                canary=self.canary_frac,
                canary_window=self.canary_window,
                canary_timeout_s=self.canary_timeout_s,
                canary_thresholds=self.canary_thresholds,
                raise_on_reject=True),
            no_retry=(CanaryRejectedError,))
        self._journal_done(st, CANARY, promoted_from=cur)

    def _fleet_on(self, tag: str) -> bool:
        """True iff EVERY up fleet host serves ``tag`` (per-host tags,
        not ``current_tag`` — a canary host that self-swapped ahead of
        the roll must not make the whole fleet look promoted)."""
        if hasattr(self.fleet, "tags"):
            tags = self.fleet.tags()
            return bool(tags) and all(t == tag for t in tags.values())
        return self.fleet.current_tag == tag

    def _do_roll(self, st: dict) -> None:
        if ROLL in st["done"] or self.fleet is None:
            if ROLL not in st["done"]:
                self._journal_done(st, ROLL, skipped="no fleet")
            return
        v = st["version"]
        tag = f"{self.name}:v{v}"
        if self._fleet_on(tag):
            # resume idempotency: every up host already serves the
            # candidate (the roll completed but its journal line was
            # lost to the crash)
            self._journal_done(st, ROLL, already_current=True)
            return
        parent = st["parent_version"]
        rollback_model = rollback_tag = None
        if parent is not None and parent in self.registry.versions(self.name):
            rollback_model = self.registry.resolve(self.name, parent)[1]
            rollback_tag = f"{self.name}:v{parent}"
        bundle = st["bundle_path"] if (st["bundle_path"]
                                       and os.path.exists(st["bundle_path"])
                                       ) else None
        report = self._attempt(
            st, ROLL,
            lambda: self.fleet.rolling_swap(
                self._model_for(st), tag,
                rollback_model=rollback_model, rollback_tag=rollback_tag,
                drain_timeout_s=self.drain_timeout_s, warm_bundle=bundle))
        if not report.get("ok"):
            # a mid-roll host death is a verdict, not a transient: the
            # fleet already rolled its survivors back — abort the
            # generation (retrying onto a degraded fleet is a policy
            # decision the operator makes, not this controller)
            raise PipelineStageError(
                ROLL, st["gen"],
                f"rolling swap failed on host {report.get('failed_host')}: "
                f"{report.get('error')}")
        self._journal_done(st, ROLL, swapped=report.get("swapped"))

    # -- terminals ---------------------------------------------------------

    def _finish_promoted(self, st: dict) -> dict:
        rec = {"gen": st["gen"], "stage": PROMOTED, "outcome": PROMOTED,
               "version": st["version"], "run_id": st["run_id"],
               "eval_score": st["eval_score"],
               "parent_version": st["parent_version"]}
        self.journal.append(rec)
        self._completed[st["gen"]] = rec
        self._partial = None
        self._current = None
        self._m_generations.inc()
        self._m_promoted.inc()
        obs_trace.instant("pipeline/promoted", cat="pipeline",
                          generation=st["gen"], version=st["version"],
                          eval_score=st["eval_score"])
        self._history.append(rec)
        return dict(rec)

    def _finish_rolled_back(self, st: dict, reason: str,
                            canary_record: Optional[dict] = None) -> dict:
        target = self._rollback(st)
        rec = {"gen": st["gen"], "stage": ROLLED_BACK,
               "outcome": ROLLED_BACK, "reason": reason,
               "version": st["version"], "run_id": st["run_id"],
               "eval_score": st["eval_score"], "rolled_back_to": target}
        if canary_record is not None:
            rec["canary"] = {"promoted": canary_record.get("promoted"),
                             "from": canary_record.get("from"),
                             "to": canary_record.get("to")}
        self.journal.append(rec)
        self._completed[st["gen"]] = rec
        self._partial = None
        self._current = None
        self._m_generations.inc()
        self._m_rolled_back.inc()
        obs_trace.instant("pipeline/rolled_back", cat="pipeline",
                          generation=st["gen"], version=st["version"],
                          target=target, reason=reason)
        self._history.append(rec)
        return dict(rec)

    def _rollback(self, st: dict) -> Optional[int]:
        """Re-alias to the lineage-selected target and re-roll the fleet
        onto it if it is serving anything else.  Returns the target
        version (None = nothing promoted yet, nothing to restore)."""
        name, alias = self.name, self.alias
        try:
            cur = self.registry.resolve(name, alias)[0]
        # graftcheck: disable=GC403 (registry.resolve is a model-version lookup, not a future resolution; no alias yet means nothing to restore)
        except KeyError:
            cur = None
        if st["version"] is not None \
                and st["version"] in self.registry.versions(name):
            target = self.registry.rollback_target(name,
                                                   version=st["version"])
        else:
            target = cur
        if target is None:
            return None
        if cur != target:
            # the candidate's canary flip (or a partial promote) moved
            # the alias — put it back on the lineage target; subscribed
            # engines follow the plain set_alias swap
            self.registry.set_alias(name, alias, target)
        if self.fleet is not None:
            ttag = f"{name}:v{target}"
            if not self._fleet_on(ttag):
                bundle = None
                ckpt = self.registry.checkpoint_path(name, target)
                if ckpt:
                    from . import warmcache
                    bp = warmcache.bundle_path_for(ckpt)
                    bundle = bp if os.path.exists(bp) else None
                model = self.registry.resolve(name, target)[1]
                try:
                    self.fleet.rolling_swap(model, ttag,
                                            drain_timeout_s=
                                            self.drain_timeout_s,
                                            warm_bundle=bundle)
                except Exception as exc:
                    # rollback must land the terminal state even when the
                    # fleet is too degraded to re-roll — the alias (the
                    # source of truth) is already on the target
                    logger.error("rollback re-roll to %s failed: %s",
                                 ttag, exc)
        return target

    # -- driving the flywheel ----------------------------------------------

    def run_generation(self) -> dict:
        """Run ONE generation to a terminal state (resuming a partial
        generation from the journal first) and return its report."""
        self._ensure_resumed()
        if self._partial is not None:
            st = self._partial
            st.setdefault("model", None)
            st.setdefault("ckpt_manager", None)
        else:
            st = self._fresh_state(self._next_generation_number())
            self._partial = st
        with obs_trace.span("pipeline/generation", cat="pipeline",
                            generation=st["gen"]):
            try:
                self._do_train(st)
                self._do_eval(st)
                self._do_register(st)
                if not st["eval_passed"]:
                    return self._finish_rolled_back(
                        st, f"eval gate failed: {st['eval_reason']}")
                self._do_canary(st)
                self._do_roll(st)
                return self._finish_promoted(st)
            except CanaryRejectedError as exc:
                self._m_canary_rej.inc()
                return self._finish_rolled_back(
                    st, f"canary rejected: {'; '.join(exc.reasons)}",
                    canary_record=exc.record)
            except PipelineStageError as exc:
                return self._finish_rolled_back(st, str(exc))

    def run(self, generations: int) -> List[dict]:
        """Drive the flywheel until ``generations`` generations have
        reached a terminal state (journaled generations count), and
        return every generation's terminal record, oldest first."""
        self._ensure_resumed()
        while len(self._completed) < generations:
            self.run_generation()
        return [dict(self._completed[g]) for g in sorted(self._completed)]
