"""GC3xx — thread-safety rules (a copy of
``deeplearning4j_tpu/analysis/threads.py``).

PRs 6-9 grew the repo to 20+ ``threading.Thread`` spawn sites (serving
replicas/supervisor, prefetch producers, watchdogs, heartbeats, HTTP
servers, pub/sub pumps).  These rules encode the discipline those PRs
established by hand:

- GC301: an attribute mutated read-modify-write style from a thread
  target while also accessed from other methods must hold a common lock
  (`x += 1` is a LOAD/ADD/STORE interleaving hazard even under the GIL).
- GC302: a non-daemon thread must have a ``join()`` on some teardown
  path, or the process never exits.
- GC303: nested ``with lockA: with lockB`` orders must be globally
  consistent — an opposite nesting anywhere is a latent deadlock.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import CallGraph, FunctionInfo, ModuleInfo, dotted
from .findings import Finding

_LOCKISH_TYPES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}
_LOCKISH_NAME = re.compile(r"lock|cond|mutex|mu$", re.IGNORECASE)


def _is_thread_ctor(node: ast.Call) -> bool:
    name = dotted(node.func)
    return name in ("threading.Thread", "Thread")


def _kwarg(node: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


class _ThreadSite:
    __slots__ = ("call", "fn", "target_expr", "daemon", "assigned_to")

    def __init__(self, call: ast.Call, fn: Optional[FunctionInfo]):
        self.call = call
        self.fn = fn
        self.target_expr = _kwarg(call, "target")
        d = _kwarg(call, "daemon")
        self.daemon = (isinstance(d, ast.Constant) and d.value is True)
        self.assigned_to: Optional[Tuple[str, ...]] = None  # ("self","_t") | ("t",)


def check_threads(graph: CallGraph) -> List[Finding]:
    out: List[Finding] = []
    for mod in graph.modules.values():
        sites = _collect_sites(graph, mod)
        out.extend(_check_joins(mod, sites))
        out.extend(_check_shared_mutation(graph, mod, sites))
        out.extend(_check_lock_order(graph, mod))
    return out


# -- site collection ---------------------------------------------------

def _collect_sites(graph: CallGraph, mod: ModuleInfo) -> List[_ThreadSite]:
    node_to_fn: Dict[int, FunctionInfo] = {
        id(fi.node): fi for fi in mod.functions.values()}
    sites: List[_ThreadSite] = []

    def walk(node: ast.AST, fn: Optional[FunctionInfo]) -> None:
        for child in ast.iter_child_nodes(node):
            child_fn = node_to_fn.get(id(child), fn)
            if isinstance(child, ast.Assign) and \
                    isinstance(child.value, ast.Call) and \
                    _is_thread_ctor(child.value):
                site = _ThreadSite(child.value, fn)
                t = child.targets[0]
                if isinstance(t, ast.Name):
                    site.assigned_to = (t.id,)
                elif isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name):
                    site.assigned_to = (t.value.id, t.attr)
                sites.append(site)
            elif isinstance(child, ast.Call) and _is_thread_ctor(child):
                sites.append(_ThreadSite(child, fn))
            walk(child, child_fn)

    walk(mod.tree, None)
    # de-dup: the Assign case visits the Call child again
    seen: Set[int] = set()
    uniq = []
    for s in sites:
        if id(s.call) in seen:
            continue
        seen.add(id(s.call))
        uniq.append(s)
    # prefer the assigned variant when both were recorded
    by_call: Dict[int, _ThreadSite] = {}
    for s in uniq:
        prev = by_call.get(id(s.call))
        if prev is None or (prev.assigned_to is None and s.assigned_to):
            by_call[id(s.call)] = s
    return list(by_call.values())


# -- GC302: non-daemon thread without join -----------------------------

def _check_joins(mod: ModuleInfo, sites: List[_ThreadSite]) -> List[Finding]:
    out: List[Finding] = []
    for s in sites:
        if s.daemon:
            continue
        call, fn = s.call, s.fn
        # `t.daemon = True` before start() in the same function?
        if s.assigned_to and fn is not None and \
                _sets_daemon(fn.node, s.assigned_to):
            continue
        if _has_join(mod, fn, s):
            continue
        out.append(Finding(
            "GC302", mod.relpath, call.lineno, call.col_offset,
            fn.qual if fn else "",
            "non-daemon Thread with no join() on any teardown path — "
            "the process cannot exit while it runs (pass daemon=True "
            "or join it in close()/stop()/shutdown())"))
    return out


def _sets_daemon(scope: ast.AST, target: Tuple[str, ...]) -> bool:
    for n in ast.walk(scope):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Attribute) and t.attr == "daemon" \
                        and _attr_path(t.value) == target:
                    return isinstance(n.value, ast.Constant) and \
                        n.value.value is True
    return False


def _attr_path(node: ast.AST) -> Optional[Tuple[str, ...]]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _has_join(mod: ModuleInfo, fn: Optional[FunctionInfo],
              s: _ThreadSite) -> bool:
    tgt = s.assigned_to
    if tgt is None:
        # anonymous `Thread(...).start()` — no handle, nothing can join
        return False
    if tgt[0] == "self" and len(tgt) == 2:
        # teardown usually lives in another method: search the module
        # for `<anything>.<attr>.join(`
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "join":
                path = _attr_path(n.func.value)
                if path and path[-1] == tgt[1]:
                    return True
        return False
    # local handle: join must happen in the same function, unless the
    # handle escapes (appended/stored/returned) — then any join() on an
    # iteration over a container is accepted module-wide
    name = tgt[0]
    scope = fn.node if fn else mod.tree
    escapes = False
    for n in ast.walk(scope):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr == "join":
                path = _attr_path(n.func.value)
                if path and path[0] == name:
                    return True
            if n.func.attr in ("append", "add", "put") and any(
                    isinstance(a, ast.Name) and a.id == name
                    for a in n.args):
                escapes = True
        elif isinstance(n, (ast.Return, ast.Yield)) and \
                isinstance(getattr(n, "value", None), ast.Name) and \
                n.value.id == name:
            escapes = True
        elif isinstance(n, ast.Assign) and \
                isinstance(n.value, ast.Name) and n.value.id == name:
            escapes = True
        elif isinstance(n, ast.Subscript) and \
                isinstance(n.ctx, ast.Store):
            escapes = True
    if escapes:
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "join":
                return True
    return False


# -- GC301: unlocked shared mutation -----------------------------------

def _lock_attrs(mod: ModuleInfo, class_name: str) -> Set[str]:
    attrs: Set[str] = set()
    for fi in mod.functions.values():
        if fi.class_name != class_name:
            continue
        for n in ast.walk(fi.node):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                tname = dotted(n.value.func) or ""
                if tname.split(".")[-1] in _LOCKISH_TYPES:
                    for t in n.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            attrs.add(t.attr)
    return attrs


def _lockish(expr: ast.AST, lock_attrs: Set[str]) -> Optional[str]:
    """Lock identity string for a with-item, or None."""
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        if expr.attr in lock_attrs or _LOCKISH_NAME.search(expr.attr):
            return f"self.{expr.attr}"
    elif isinstance(expr, ast.Name) and _LOCKISH_NAME.search(expr.id):
        return expr.id
    return None


class _AccessWalker:
    """Per-function walk recording self.<attr> accesses with whether a
    lock-ish `with` was held, plus RMW (read-modify-write) sites."""

    def __init__(self, fi: FunctionInfo, lock_attrs: Set[str]):
        self.fi = fi
        self.lock_attrs = lock_attrs
        self.reads: Set[str] = set()
        self.writes: Set[str] = set()
        self.unlocked_rmw: List[Tuple[str, ast.AST]] = []
        self._depth = 0
        self._walk(fi.node)

    def _walk(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and child is not self.fi.node:
                continue
            if isinstance(child, ast.With):
                held = [ _lockish(item.context_expr, self.lock_attrs)
                         for item in child.items ]
                n_held = sum(1 for h in held if h)
                self._depth += n_held
                self._walk(child)
                self._depth -= n_held
                continue
            self._record(child)
            self._walk(child)

    def _record(self, node: ast.AST) -> None:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            if isinstance(node.ctx, ast.Store):
                self.writes.add(node.attr)
            elif isinstance(node.ctx, ast.Load):
                self.reads.add(node.attr)
        if isinstance(node, ast.AugAssign) and \
                _self_attr(node.target) and self._depth == 0:
            self.unlocked_rmw.append((node.target.attr, node))
        elif isinstance(node, ast.Assign) and self._depth == 0:
            for t in node.targets:
                if _self_attr(t) and _mentions_self_attr(node.value, t.attr):
                    self.unlocked_rmw.append((t.attr, node))


def _self_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and \
        isinstance(node.value, ast.Name) and node.value.id == "self"


def _mentions_self_attr(expr: ast.AST, attr: str) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr == attr and \
                isinstance(n.value, ast.Name) and n.value.id == "self":
            return True
    return False


def _thread_context_fns(graph: CallGraph, mod: ModuleInfo,
                        class_name: str,
                        sites: List[_ThreadSite]) -> Set[str]:
    """gids of class-local functions that run on a spawned thread
    (targets + their class-local transitive callees)."""
    entries: Set[str] = set()
    for s in sites:
        if s.fn is None or s.fn.class_name != class_name:
            continue
        t = s.target_expr
        gid = None
        if isinstance(t, ast.Name):
            gid = graph._resolve(mod, s.fn, ("name", t.id))
        elif isinstance(t, ast.Attribute) and \
                isinstance(t.value, ast.Name) and t.value.id == "self":
            gid = graph._resolve(mod, s.fn, ("self", t.attr))
        if gid is not None:
            entries.add(gid)
    # transitive closure within the class
    work = list(entries)
    while work:
        gid = work.pop()
        fi = graph.functions.get(gid)
        if fi is None:
            continue
        for callee in graph.edges_of(fi):
            cf = graph.functions.get(callee)
            if cf is not None and cf.module is mod and \
                    cf.class_name == class_name and callee not in entries:
                entries.add(callee)
                work.append(callee)
    return entries


def _check_shared_mutation(graph: CallGraph, mod: ModuleInfo,
                           sites: List[_ThreadSite]) -> List[Finding]:
    out: List[Finding] = []
    for class_name in mod.classes:
        class_fns = [fi for fi in mod.functions.values()
                     if fi.class_name == class_name]
        if not class_fns:
            continue
        thread_ctx = _thread_context_fns(graph, mod, class_name, sites)
        spawns = any(s.fn is not None and s.fn.class_name == class_name
                     for s in sites)
        if not spawns:
            continue
        lock_attrs = _lock_attrs(mod, class_name)
        walkers = {fi.gid: _AccessWalker(fi, lock_attrs)
                   for fi in class_fns}
        # attr -> contexts that touch it (excluding __init__)
        touched: Dict[str, Set[bool]] = {}
        for fi in class_fns:
            if fi.qual.split(".")[-1] == "__init__":
                continue
            w = walkers[fi.gid]
            for attr in (w.reads | w.writes):
                touched.setdefault(attr, set()).add(fi.gid in thread_ctx)
        for fi in class_fns:
            if fi.qual.split(".")[-1] == "__init__":
                continue
            for attr, node in walkers[fi.gid].unlocked_rmw:
                ctxs = touched.get(attr, set())
                if len(ctxs) < 2:   # not shared across thread boundary
                    continue
                where = "a thread target" if fi.gid in thread_ctx \
                    else "outside the thread"
                out.append(Finding(
                    "GC301", mod.relpath, node.lineno, node.col_offset,
                    fi.qual,
                    f"read-modify-write of self.{attr} without a lock "
                    f"in {where}, but self.{attr} is shared across the "
                    f"thread boundary of {class_name} — wrap in the "
                    "class lock"))
    return out


# -- GC303: lock acquisition order -------------------------------------

def _check_lock_order(graph: CallGraph, mod: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    # per class AND module level: ordered acquisition edges
    scopes: Dict[str, List[FunctionInfo]] = {}
    for fi in mod.functions.values():
        scopes.setdefault(fi.class_name or "", []).append(fi)
    for class_name, fns in scopes.items():
        lock_attrs = _lock_attrs(mod, class_name) if class_name else set()
        edges: Dict[Tuple[str, str], ast.AST] = {}

        def collect(node: ast.AST, held: List[str], fi: FunctionInfo):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) and \
                        child is not fi.node:
                    continue
                if isinstance(child, ast.With):
                    got = [_lockish(i.context_expr, lock_attrs)
                           for i in child.items]
                    got = [g for g in got if g]
                    for g in got:
                        for h in held:
                            if h != g and (h, g) not in edges:
                                edges[(h, g)] = child
                    collect(child, held + got, fi)
                else:
                    collect(child, held, fi)

        for fi in fns:
            collect(fi.node, [], fi)
        # cycle detection over the little digraph
        adj: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)
        for (a, b), site in sorted(edges.items(),
                                   key=lambda kv: kv[1].lineno):
            # is there a path b -> a?
            seen, work = set(), [b]
            found = False
            while work:
                n = work.pop()
                if n == a:
                    found = True
                    break
                if n in seen:
                    continue
                seen.add(n)
                work.extend(adj.get(n, ()))
            if found:
                out.append(Finding(
                    "GC303", mod.relpath, site.lineno, site.col_offset,
                    class_name,
                    f"lock order {a} -> {b} here, but the opposite "
                    "order exists elsewhere in this scope — a latent "
                    "deadlock; pick one global order"))
    return out
