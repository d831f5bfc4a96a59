"""graftcheck runner: parse -> call graph -> rules -> suppressions (a
copy of ``deeplearning4j_tpu/analysis/runner.py`` over the port's
package, with a baseline of its own).

Suppression surfaces, both requiring a justification:

- inline pragma on the flagged line (or the comment line directly
  above): ``# graftcheck: disable=GC201 (wall-anchor: dashboard ts)``
- a reviewed entry in ``analysis/baseline.json`` matching the finding's
  (rule, path, symbol) key — line-number independent, so baselines
  survive unrelated edits.

Suppression hygiene is itself analyzed: unknown rule ids (GC001),
missing justifications (GC002), and pragmas/baseline entries that no
longer match anything (GC003) are findings too.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import contracts, determinism, purity, threads
from .callgraph import CallGraph, load_package
from .findings import Finding, RULES

_PRAGMA = re.compile(
    r"#\s*graftcheck:\s*disable=([A-Za-z0-9,\s]+?)"
    r"(?:\s*\((?P<reason>.*)\))?\s*$")

_PKG_DIR = "deeplearning4j_tpu_torch"


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def default_taxonomy_path() -> str:
    return os.path.join(repo_root(), "docs", "OBSERVABILITY.md")


@dataclass
class Pragma:
    path: str
    line: int           # line the pragma is written on (1-based)
    applies_to: int     # line findings must be on to match
    rules: Tuple[str, ...]
    reason: str
    used: bool = False


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)   # unsuppressed
    suppressed: List[Tuple[Finding, str]] = field(default_factory=list)
    graph: Optional[CallGraph] = None
    n_files: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "files": self.n_files,
            "rules": sorted(RULES),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [dict(f.to_dict(), suppressed_by=how)
                           for f, how in self.suppressed],
            "summary": {
                "unsuppressed": len(self.findings),
                "suppressed": len(self.suppressed),
            },
        }


def _scan_pragmas(mod) -> List[Pragma]:
    out: List[Pragma] = []
    for i, raw in enumerate(mod.lines, start=1):
        m = _PRAGMA.search(raw)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = (m.group("reason") or "").strip()
        stripped = raw.strip()
        applies = i
        if stripped.startswith("#"):
            # comment-only line: applies to the next non-comment line
            j = i
            while j < len(mod.lines):
                nxt = mod.lines[j].strip()
                if nxt and not nxt.startswith("#"):
                    applies = j + 1
                    break
                j += 1
        out.append(Pragma(mod.relpath, i, applies, rules, reason))
    return out


def _load_baseline(path: Optional[str]) -> Tuple[List[dict], List[Finding]]:
    if path is None or not os.path.exists(path):
        return [], []
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("entries", [])
    problems: List[Finding] = []
    rel = os.path.relpath(path, repo_root()).replace(os.sep, "/")
    for i, e in enumerate(entries):
        if not str(e.get("justification", "")).strip():
            problems.append(Finding(
                "GC002", rel, 0, 0, e.get("rule", "?"),
                f"baseline entry #{i} ({e.get('rule')} {e.get('path')}"
                f"::{e.get('symbol')}) has no justification"))
        if e.get("rule") not in RULES:
            problems.append(Finding(
                "GC001", rel, 0, 0, e.get("rule", "?"),
                f"baseline entry #{i} names unknown rule "
                f"'{e.get('rule')}'"))
    return entries, problems


def run_analysis(root: Optional[str] = None,
                 paths: Optional[Sequence[str]] = None,
                 baseline_path: Optional[str] = "<default>",
                 taxonomy_path: Optional[str] = "<default>",
                 ) -> AnalysisResult:
    """Analyze the package (or explicit ``paths`` for fixture runs).

    ``baseline_path`` / ``taxonomy_path``: ``"<default>"`` resolves to
    the repo files; ``None`` disables the baseline / the GC401 taxonomy
    check respectively.
    """
    root = root or repo_root()
    if baseline_path == "<default>":
        baseline_path = default_baseline_path()
    if taxonomy_path == "<default>":
        taxonomy_path = default_taxonomy_path()

    if paths:
        files = []
        for p in paths:
            full = p if os.path.isabs(p) else os.path.join(root, p)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            modkey = os.path.splitext(os.path.basename(full))[0]
            with open(full, "r", encoding="utf-8") as f:
                files.append((rel, modkey, f.read()))
    else:
        files = load_package(root, _PKG_DIR)

    graph = CallGraph.build(files)

    taxonomy = None
    if taxonomy_path and os.path.exists(taxonomy_path):
        with open(taxonomy_path, "r", encoding="utf-8") as f:
            taxonomy = contracts.parse_taxonomy(f.read())

    raw: List[Finding] = []
    raw.extend(purity.check_purity(graph))
    raw.extend(determinism.check_determinism(graph))
    raw.extend(threads.check_threads(graph))
    raw.extend(contracts.run_contracts(graph, taxonomy))

    # -- suppression ---------------------------------------------------
    pragmas: Dict[str, List[Pragma]] = {}
    meta: List[Finding] = []
    for mod in graph.modules.values():
        ps = _scan_pragmas(mod)
        pragmas[mod.relpath] = ps
        for p in ps:
            for r in p.rules:
                if r not in RULES:
                    meta.append(Finding(
                        "GC001", p.path, p.line, 0, "",
                        f"pragma names unknown rule '{r}'"))
            if not p.reason:
                meta.append(Finding(
                    "GC002", p.path, p.line, 0, "",
                    "suppression pragma has no (justification)"))

    entries, baseline_problems = _load_baseline(baseline_path)
    meta.extend(baseline_problems)
    used_entries: Set[int] = set()

    result = AnalysisResult(graph=graph, n_files=len(files))
    for f in raw:
        suppressed_by = None
        for p in pragmas.get(f.path, ()):
            if f.rule in p.rules and p.reason and \
                    f.line in (p.line, p.applies_to):
                p.used = True
                suppressed_by = f"pragma@{p.path}:{p.line} ({p.reason})"
                break
        if suppressed_by is None:
            for i, e in enumerate(entries):
                if (e.get("rule"), e.get("path"), e.get("symbol")) == \
                        f.key() and str(e.get("justification", "")).strip():
                    used_entries.add(i)
                    suppressed_by = f"baseline#{i} ({e['justification']})"
                    break
        if suppressed_by is not None:
            result.suppressed.append((f, suppressed_by))
        else:
            result.findings.append(f)

    # suppression hygiene
    for ps in pragmas.values():
        for p in ps:
            if not p.used and p.reason and \
                    all(r in RULES for r in p.rules):
                meta.append(Finding(
                    "GC003", p.path, p.line, 0, "",
                    f"pragma disable={','.join(p.rules)} matched no "
                    "finding — remove it or the rule regressed"))
    if entries:
        rel = os.path.relpath(baseline_path,
                              repo_root()).replace(os.sep, "/")
        for i, e in enumerate(entries):
            if i not in used_entries and e.get("rule") in RULES and \
                    str(e.get("justification", "")).strip():
                meta.append(Finding(
                    "GC003", rel, 0, 0, e.get("symbol") or "",
                    f"baseline entry #{i} ({e.get('rule')} "
                    f"{e.get('path')}::{e.get('symbol')}) matched no "
                    "finding — remove it"))
    result.findings.extend(meta)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return result


def update_baseline(result: AnalysisResult, baseline_path: str,
                    justification: str) -> int:
    """Append every currently-unsuppressed finding to the baseline with
    ``justification``.  Refuses (ValueError) without one."""
    if not justification or not justification.strip():
        raise ValueError(
            "--baseline-update requires --justification: every accepted "
            "finding must say WHY it is accepted")
    if os.path.exists(baseline_path):
        with open(baseline_path, "r", encoding="utf-8") as f:
            data = json.load(f)
    else:
        data = {"version": 1, "entries": []}
    keys = {(e.get("rule"), e.get("path"), e.get("symbol"))
            for e in data["entries"]}
    added = 0
    for f in result.findings:
        if f.rule in ("GC001", "GC002", "GC003"):
            continue   # fix suppression hygiene, never baseline it
        if f.key() in keys:
            continue
        keys.add(f.key())
        data["entries"].append({
            "rule": f.rule, "path": f.path, "symbol": f.symbol,
            "message": f.message, "justification": justification.strip(),
        })
        added += 1
    data["entries"].sort(key=lambda e: (e["path"], e["rule"], e["symbol"]))
    with open(baseline_path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    return added
