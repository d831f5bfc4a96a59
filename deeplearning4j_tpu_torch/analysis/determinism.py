"""GC2xx — determinism rules (a copy of
``deeplearning4j_tpu/analysis/determinism.py``).

Wall-clock reads and global-RNG draws are flagged EVERYWHERE in the
package (the repo's bit-identity gates — chaos-off identity, A/B loss
parity, replay equality — are only as strong as the set of
nondeterminism sources someone has consciously signed off on).  Each
site must either be migrated to an injectable clock / threaded seeded
generator, or carry a `# graftcheck: disable=GC201 (wall-anchor: ...)`
pragma saying why wall time is the *point* (dashboard timestamps, trace
time bases, heartbeat staleness).

The call graph sharpens the message: a site reachable from a step /
checkpoint-replay / trace-export root is labelled with that root, which
is the difference between "cosmetic" and "backs a bit-identity gate".
"""

from __future__ import annotations

import ast
from typing import Dict, List

from .callgraph import CallGraph, dotted
from .findings import Finding

# entry points whose behavior the bit-identity gates pin (ROADMAP
# tier-1 + bench hard gates).  Traced functions are implicit roots.
DETERMINISTIC_ROOTS = (
    "*.fit_batch", "*.fit_batches", "*._fit_batch_guarded",
    "ElasticTrainer.fit", "ElasticTrainer.resume",
    "CheckpointManager.save*", "CheckpointManager.restore*",
    # the port's save_model / load_model are module functions (their
    # gids end in ``::save_model``): the reference's ``*.save_model``
    # matches no function of either package
    "*::save_model", "*::load_model",
    "TraceRecorder.save", "TraceRecorder.export",
)

_WALL_CLOCK = {"time.time", "time.time_ns", "datetime.datetime.now",
               "datetime.datetime.utcnow", "datetime.date.today",
               "datetime.now", "datetime.utcnow", "date.today"}

# global-state RNG draws (instance methods on a threaded Generator /
# RandomState / jax.random key are the sanctioned pattern and do not
# match — those are `rng.normal(...)` on a Name, not `np.random.*`)
_RNG_PREFIXES = ("random.", "np.random.", "numpy.random.")
_RNG_EXEMPT_LEAVES = {"default_rng", "RandomState", "Generator",
                      "PCG64", "Philox", "SeedSequence", "Random"}


def check_determinism(graph: CallGraph) -> List[Finding]:
    roots = graph.match(DETERMINISTIC_ROOTS)
    reach: Dict[str, str] = graph.reachable_from(roots)
    out: List[Finding] = []
    for fi in graph.functions.values():
        ctx = ""
        if fi.gid in graph.traced:
            ctx = "on a TRACED path"
        elif fi.gid in reach:
            ctx = f"reachable from deterministic root {reach[fi.gid]}"
        out.extend(_check_fn(fi, ctx))
    out.extend(_module_level(graph, reach))
    return out


def _check_nodes(nodes, rel: str, symbol: str, ctx: str) -> List[Finding]:
    out: List[Finding] = []
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name is None:
            continue
        if name in _WALL_CLOCK:
            out.append(Finding(
                "GC201", rel, node.lineno, node.col_offset, symbol,
                f"{name}() is a wall-clock read — inject a clock "
                "(clock=time.time parameter) or pragma-tag the site as "
                "a wall-anchor", ctx))
        elif name.startswith(_RNG_PREFIXES) and \
                name.split(".")[-1] not in _RNG_EXEMPT_LEAVES:
            out.append(Finding(
                "GC202", rel, node.lineno, node.col_offset, symbol,
                f"{name}() draws from process-global RNG state — "
                "thread a seeded generator instead", ctx))
        elif name.split(".")[-1] == "default_rng" and not node.args:
            out.append(Finding(
                "GC202", rel, node.lineno, node.col_offset, symbol,
                "default_rng() without a seed is entropy-seeded — pass "
                "an explicit seed", ctx))
        elif name == "hash" and node.args and not _is_self_arg(node.args[0]):
            if symbol.split(".")[-1] in ("__hash__", "__eq__"):
                continue
            out.append(Finding(
                "GC203", rel, node.lineno, node.col_offset, symbol,
                "builtin hash() of str/bytes varies per process "
                "(PYTHONHASHSEED) — use hashlib or a stable key", ctx))
    return out


def _is_self_arg(arg: ast.AST) -> bool:
    return isinstance(arg, ast.Name) and arg.id == "self"


def _check_fn(fi, ctx: str) -> List[Finding]:
    nodes = []
    stack = list(ast.iter_child_nodes(fi.node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        nodes.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return _check_nodes(nodes, fi.module.relpath, fi.qual, ctx)


def _module_level(graph: CallGraph, reach) -> List[Finding]:
    """Statements outside any def (import-time clock/RNG reads)."""
    out: List[Finding] = []
    for mod in graph.modules.values():
        nodes = []
        stack = list(ast.iter_child_nodes(mod.tree))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                # class bodies: walk non-function statements only
                if isinstance(n, ast.ClassDef):
                    stack.extend(c for c in ast.iter_child_nodes(n)
                                 if not isinstance(
                                     c, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)))
                continue
            nodes.append(n)
            stack.extend(ast.iter_child_nodes(n))
        out.extend(_check_nodes(nodes, mod.relpath, "", "at import time"))
    return out
