"""GC4xx — repo contract rules (a copy of
``deeplearning4j_tpu/analysis/contracts.py``; GC401 reads the same
docs/OBSERVABILITY.md taxonomy).

These encode cross-artifact invariants the soaks only catch indirectly:

- GC401: every ``span()``/``instant()``/``complete_at()`` name must
  appear in the docs/OBSERVABILITY.md taxonomy table (wildcard rows
  like ``launcher/*`` cover f-string names).  The golden test in
  tests/test_static_analysis.py checks the reverse direction too, so
  the docs cannot rot.
- GC402: metric names are snake_case; counters created on the GLOBAL
  registry (``get_registry()``) end in ``_total``; histograms carry a
  unit suffix.  (Per-engine serving counters keep the PR-4 legacy
  snapshot keys — those registries are private, so the ``_total`` rule
  does not apply to them.)
- GC403: in a function that resolves futures, an exception path that
  neither resolves nor re-raises cannot uphold the serving "nothing
  stranded" invariant.  The race-guard idiom (``try: fut.set_result``
  / ``except InvalidStateError: pass``) is recognized and exempt.
- GC404: silent exception swallows (``except Exception: pass`` or
  broader) must narrow the type, record telemetry, or carry a
  justified pragma.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from typing import List, Optional, Sequence, Set

from .callgraph import CallGraph, FunctionInfo, dotted
from .findings import Finding

_SNAKE = re.compile(r"^[a-z][a-z0-9_]*$")
_HIST_SUFFIXES = ("_ms", "_seconds", "_s", "_bytes", "_rows", "_ratio")
_RESOLUTION_LEAVES = {"set_result", "set_exception", "cancel"}
_RESOLUTION_HELPERS = re.compile(r"fail|resolve|_set_safe")


# -- taxonomy ----------------------------------------------------------

def parse_taxonomy(markdown: str) -> Set[str]:
    """Span/instant names from the `## Taxonomy table` section of
    docs/OBSERVABILITY.md: first column of each table row."""
    names: Set[str] = set()
    in_section = False
    for line in markdown.splitlines():
        if line.startswith("## "):
            in_section = line.strip().lower() == "## taxonomy table"
            continue
        if not in_section or not line.lstrip().startswith("|"):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if not cells or not cells[0] or set(cells[0]) <= {"-", ":", " "}:
            continue
        name = cells[0].strip("`")
        if name.lower() in ("name", "span / instant"):
            continue
        names.add(name)
    return names


def _span_name_matches(name: str, taxonomy: Set[str]) -> bool:
    if name in taxonomy:
        return True
    probe = name.replace("*", "x")  # f-string holes become a literal
    return any("*" in t and fnmatch.fnmatch(probe, t) for t in taxonomy)


def _literal_span_names(arg: ast.AST) -> Optional[List[str]]:
    """All statically-known names an emission site can produce: handles
    str literals, f-strings (holes become '*'), and conditional
    expressions whose branches are themselves literal."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return [arg.value]
    if isinstance(arg, ast.JoinedStr):
        parts = []
        for v in arg.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        return ["".join(parts)]
    if isinstance(arg, ast.IfExp):
        a = _literal_span_names(arg.body)
        b = _literal_span_names(arg.orelse)
        if a is not None and b is not None:
            return a + b
    return None


def collect_span_emissions(graph: CallGraph):
    """(module, call, name_pattern, literal?) for every obs-trace
    span/instant/complete_at emission in the package."""
    out = []
    for mod in graph.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if fname is None:
                continue
            leaf = fname.split(".")[-1]
            if leaf not in ("span", "instant", "complete_at"):
                continue
            norm = mod.normalize(fname)
            if "obs" not in norm and "trace" not in norm.split(".")[0]:
                continue
            if not node.args:
                continue
            names = _literal_span_names(node.args[0])
            out.append((mod, node, names))
    return out


def check_span_taxonomy(graph: CallGraph,
                        taxonomy: Optional[Set[str]]) -> List[Finding]:
    if taxonomy is None:
        return []
    out: List[Finding] = []
    for mod, node, names in collect_span_emissions(graph):
        symbol = _enclosing_symbol(graph, mod, node)
        if names is None:
            out.append(Finding(
                "GC401", mod.relpath, node.lineno, node.col_offset,
                symbol,
                "span/instant name is not a (f-)string literal — the "
                "taxonomy cannot be checked; use a literal or an "
                "f-string matching a wildcard taxonomy row"))
            continue
        for name in names:
            if not _span_name_matches(name, taxonomy):
                out.append(Finding(
                    "GC401", mod.relpath, node.lineno, node.col_offset,
                    symbol,
                    f"span/instant name '{name}' is not in the "
                    "docs/OBSERVABILITY.md taxonomy table — add a row "
                    "(or a wildcard row) so pod timelines stay "
                    "documented"))
    return out


def _enclosing_symbol(graph: CallGraph, mod, node: ast.AST) -> str:
    best = ""
    best_span = None
    for fi in mod.functions.values():
        n = fi.node
        end = getattr(n, "end_lineno", n.lineno)
        if n.lineno <= node.lineno <= end:
            span = end - n.lineno
            if best_span is None or span < best_span:
                best, best_span = fi.qual, span
    return best


# -- metric naming -----------------------------------------------------

def check_metric_names(graph: CallGraph) -> List[Finding]:
    out: List[Finding] = []
    for mod in graph.modules.values():
        # names assigned from get_registry() per function scope
        for fi in list(mod.functions.values()) + [None]:
            tree = fi.node if fi is not None else mod.tree
            symbol = fi.qual if fi is not None else ""
            global_regs = {"get_registry"}
            aliases: Set[str] = set()
            for n in ast.walk(tree):
                if fi is None and isinstance(
                        n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(n, ast.Assign) and \
                        isinstance(n.value, ast.Call):
                    vn = dotted(n.value.func)
                    if vn and vn.split(".")[-1] == "get_registry":
                        for t in n.targets:
                            if isinstance(t, ast.Name):
                                aliases.add(t.id)
            for n in ast.walk(tree):
                if not isinstance(n, ast.Call) or \
                        not isinstance(n.func, ast.Attribute):
                    continue
                kind = n.func.attr
                if kind not in ("counter", "gauge", "histogram"):
                    continue
                recv = n.func.value
                recv_name = dotted(recv)
                is_registry = False
                is_global = False
                if isinstance(recv, ast.Call):
                    rn = dotted(recv.func)
                    if rn and rn.split(".")[-1] == "get_registry":
                        is_registry = is_global = True
                elif recv_name is not None:
                    leaf = recv_name.split(".")[-1]
                    if "registry" in leaf or leaf == "reg":
                        is_registry = True
                    if recv_name in aliases:
                        is_registry = is_global = True
                if not is_registry:
                    continue
                if not n.args or not isinstance(n.args[0], ast.Constant) \
                        or not isinstance(n.args[0].value, str):
                    continue   # dynamic names are adopted elsewhere
                name = n.args[0].value
                if not _SNAKE.match(name):
                    out.append(Finding(
                        "GC402", mod.relpath, n.lineno, n.col_offset,
                        symbol,
                        f"metric name '{name}' is not snake_case"))
                elif kind == "counter" and is_global and \
                        not name.endswith("_total"):
                    out.append(Finding(
                        "GC402", mod.relpath, n.lineno, n.col_offset,
                        symbol,
                        f"global-registry counter '{name}' must end in "
                        "'_total' (docs/OBSERVABILITY.md schema)"))
                elif kind == "histogram" and \
                        not name.endswith(_HIST_SUFFIXES):
                    out.append(Finding(
                        "GC402", mod.relpath, n.lineno, n.col_offset,
                        symbol,
                        f"histogram '{name}' has no unit suffix "
                        f"({'/'.join(_HIST_SUFFIXES)})"))
    return out


# -- futures -----------------------------------------------------------

def _is_resolution_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func)
    if name is None:
        return False
    leaf = name.split(".")[-1]
    return leaf in _RESOLUTION_LEAVES or \
        bool(_RESOLUTION_HELPERS.search(leaf))


def _contains_resolution(node: ast.AST) -> bool:
    return any(_is_resolution_call(n) for n in ast.walk(node))


def _contains_raise(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(node))


def _own_nodes(fi: FunctionInfo) -> List[ast.AST]:
    """fi's body without nested defs (they are their own FunctionInfos)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(fi.node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def check_future_paths(graph: CallGraph) -> List[Finding]:
    out: List[Finding] = []
    for fi in graph.functions.values():
        body_nodes = _own_nodes(fi)
        if not any(_is_resolution_call(n) for n in body_nodes):
            continue
        for n in body_nodes:
            if not isinstance(n, ast.Try):
                continue
            finally_resolves = any(_contains_resolution(s)
                                   for s in n.finalbody)
            # race-guard idiom: the try body IS the resolution
            body_is_resolution = all(
                (isinstance(s, ast.Expr) and _is_resolution_call(s.value))
                or isinstance(s, (ast.Return, ast.Pass))
                or (isinstance(s, ast.Assign)
                    and _is_resolution_call(s.value))
                for s in n.body) and any(
                _contains_resolution(s) for s in n.body)
            if finally_resolves or body_is_resolution:
                continue
            if not any(_contains_resolution(s) for s in n.body):
                continue   # this try doesn't dispatch on futures
            for h in n.handlers:
                if _contains_resolution(h) or _contains_raise(h):
                    continue
                out.append(Finding(
                    "GC403", fi.module.relpath, h.lineno, h.col_offset,
                    fi.qual,
                    "this except path neither resolves the in-flight "
                    "futures nor re-raises — an exception here can "
                    "strand them (serving 'nothing stranded' "
                    "invariant)"))
    return out


# -- silent swallow ----------------------------------------------------

_BROAD = {"Exception", "BaseException"}


def _handler_types(h: ast.ExceptHandler) -> List[str]:
    if h.type is None:
        return ["<bare>"]
    nodes = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    out = []
    for n in nodes:
        name = dotted(n)
        out.append(name.split(".")[-1] if name else "?")
    return out


def check_silent_swallow(graph: CallGraph) -> List[Finding]:
    out: List[Finding] = []
    for mod in graph.modules.values():
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.ExceptHandler):
                continue
            types = _handler_types(n)
            if not (set(types) & _BROAD) and types != ["<bare>"]:
                continue
            body_silent = all(
                isinstance(s, (ast.Pass, ast.Continue, ast.Break))
                or (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant))
                for s in n.body)
            if not body_silent:
                continue
            shown = "bare except" if types == ["<bare>"] \
                else f"except {'/'.join(types)}"
            out.append(Finding(
                "GC404", mod.relpath, n.lineno, n.col_offset,
                _enclosing_symbol(graph, mod, n),
                f"{shown}: pass — the failure is dropped on the "
                "floor; narrow the exception type, record an obs "
                "instant()/counter, or pragma with a justification"))
    return out


def run_contracts(graph: CallGraph,
                  taxonomy: Optional[Set[str]]) -> List[Finding]:
    out = []
    out.extend(check_span_taxonomy(graph, taxonomy))
    out.extend(check_metric_names(graph))
    out.extend(check_future_paths(graph))
    out.extend(check_silent_swallow(graph))
    return out
