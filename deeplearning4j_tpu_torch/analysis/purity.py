"""GC1xx — JIT purity rules over the traced-code set (a copy of
``deeplearning4j_tpu/analysis/purity.py`` that also knows torch).

Everything here runs only inside functions the trace-boundary pass marked
traced (callgraph.CallGraph.traced), the bodies of CUDA-graph capture
blocks and the lambdas a capture calls: host syncs, host side effects,
and host-state mutation are legal in eager code, so the traced set is
what keeps these rules quiet where they should be.

Under a capture the rules mean what they mean under ``jit``: a host sync
fails the capture (or stalls every step), and a Python side effect or a
host-state write runs once, at capture, never at a replay.  GC101 also
knows torch's host syncs: ``.cpu()`` / ``.numpy()`` / ``.item()`` /
``.tolist()``, ``torch.cuda.synchronize()`` and a stream's or event's
``.synchronize()``, ``.nonzero()`` / ``torch.nonzero``, and a tensor made
from host data on a device (``torch.tensor(..., device=)``,
``torch.as_tensor(..., device=)``, ``torch.from_numpy(...).to(...)``),
a copy a capture refuses.  GC103 also flags a write to an attribute of
an object the function does not bind itself (``kernel.launches += 1``):
module or closure state, as ``self`` is.

Taint (what ``float()``/``int()``/``bool()`` must not coerce) is the
reference's first-order taint, with two refinements a tensor program
needs: a parameter annotated as a Python scalar (``int``, ``float``,
``bool``, ``str``) is host data, and so is a tensor's metadata
(``.shape``, ``.dtype``, ``.device``, ``.ndim``, ``.size()``,
``.dim()``, ``.numel()``, ``len()``).
"""

from __future__ import annotations

import ast
from typing import List, Set

from .callgraph import CallGraph, FunctionInfo, dotted
from .findings import Finding

# calls that force a device->host sync (or outright fail) on traced values
_SYNC_METHODS = {"item", "tolist", "block_until_ready",
                 "cpu", "numpy", "synchronize", "nonzero"}
_SYNC_CALLS = {"torch.nonzero", "torch.cuda.synchronize"}
# torch constructors that copy host data; with a device, a host->device copy
_HOST_TENSOR_CTORS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
# a tensor's host-side metadata: reading it syncs nothing
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad"}
_META_CALLS = {"size", "dim", "numel", "len", "isinstance", "element_size"}
_SCALAR_TYPES = {"int", "float", "bool", "str"}
# builtins that coerce a traced value to a host scalar
_COERCERS = {"float", "int", "bool", "complex"}
# numpy entry points that materialize a traced value on host
_NP_MATERIALIZE = {"asarray", "array", "copy", "save", "savez"}

# dotted prefixes whose call is a host side effect frozen at trace time
_IMPURE_CALLS = {
    "print", "input", "open",
    "time.time", "time.time_ns", "time.monotonic", "time.perf_counter",
    "time.sleep", "time.process_time",
    "os.getenv", "os.urandom", "os.system",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}
_IMPURE_PREFIXES = ("random.", "np.random.", "numpy.random.", "logging.",
                    "logger.", "warnings.")
# jax.debug.* is the sanctioned way to print from traced code
_ALLOWED_PREFIXES = ("jax.debug.",)


def _body_nodes(fn: FunctionInfo):
    """Walk fn's body, NOT descending into nested function defs (they
    are separate FunctionInfos, checked iff themselves traced)."""
    stack = list(ast.iter_child_nodes(fn.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scalar_params(fn: FunctionInfo) -> Set[str]:
    """Parameters annotated as a Python scalar (``int``, ``float``,
    ``Optional[float]``, ...)."""
    out: Set[str] = set()
    a = fn.node.args
    for arg in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
        ann = arg.annotation
        if ann is None:
            continue
        names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
        names.discard("Optional")
        if names and names <= _SCALAR_TYPES:
            out.add(arg.arg)
    return out


def _value_names(expr: ast.AST) -> Set[str]:
    """Names ``expr`` reads as values: not through a tensor's metadata
    (``x.shape``, ``x.dtype``, ``x.size()``, ``len(x)``)."""
    out: Set[str] = set()
    stack = [expr]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Attribute) and n.attr in _META_ATTRS:
            continue
        if isinstance(n, ast.Call):
            name = dotted(n.func)
            if name is not None and name.split(".")[-1] in _META_CALLS:
                continue
        if isinstance(n, ast.Name):
            out.add(n.id)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _tainted_names(fn: FunctionInfo) -> Set[str]:
    """First-order taint: parameters + names assigned from expressions
    mentioning a tainted name.  Iterates to a fixed point (bodies are
    small)."""
    tainted = set(fn.params) - _scalar_params(fn)
    changed = True
    while changed:
        changed = False
        for node in _body_nodes(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = node.value
                if value is None:
                    continue
                rhs_names = _value_names(value)
                if not (rhs_names & tainted):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and n.id not in tainted:
                            tainted.add(n.id)
                            changed = True
            elif isinstance(node, ast.For):
                it_names = _value_names(node.iter)
                if it_names & tainted:
                    for n in ast.walk(node.target):
                        if isinstance(n, ast.Name) and n.id not in tainted:
                            tainted.add(n.id)
                            changed = True
    return tainted


def _is_tainted_expr(expr: ast.AST, tainted: Set[str]) -> bool:
    return bool(_value_names(expr) & tainted)


def _local_names(fi: FunctionInfo) -> Set[str]:
    """Parameters and names the function binds itself."""
    out = set(fi.params)
    for node in _body_nodes(fi):
        if isinstance(node, ast.Name) and \
                isinstance(node.ctx, (ast.Store, ast.Del)):
            out.add(node.id)
    return out


def _block_nodes(stmts):
    """Every node of ``stmts``, not descending into nested defs."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check_purity(graph: CallGraph) -> List[Finding]:
    out: List[Finding] = []
    for fi in graph.functions.values():
        if graph.is_traced(fi):
            out.extend(_check_traced_fn(graph, fi))
        out.extend(_check_jit_in_loop(fi))
    for block in graph.captures:
        fi = block.fn
        if fi is not None and not graph.is_traced(fi):
            out.extend(_check_nodes(fi, _block_nodes(block.node.body),
                                    block.reason))
    for fi, lam, reason in graph.captured_lambdas:
        if not graph.is_traced(fi):
            out.extend(_check_nodes(fi, _block_nodes([lam.body]), reason))
    return out


def _host_tensor_copy(node: ast.Call, mod) -> bool:
    """``torch.tensor(..., device=)`` / ``torch.as_tensor(..., device=)``,
    or ``.to(...)`` / ``.cuda()`` of a tensor made from host data."""
    name = dotted(node.func)
    if name is not None and mod.normalize(name) in _HOST_TENSOR_CTORS:
        return any(kw.arg == "device" for kw in node.keywords)
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in ("to", "cuda") and \
            isinstance(node.func.value, ast.Call):
        inner = dotted(node.func.value.func)
        return inner is not None and mod.normalize(inner) in _HOST_TENSOR_CTORS
    return False


def _check_traced_fn(graph: CallGraph, fi: FunctionInfo) -> List[Finding]:
    return _check_nodes(fi, _body_nodes(fi), graph.traced.get(fi.gid, ""))


def _check_nodes(fi: FunctionInfo, nodes, reason: str) -> List[Finding]:
    out: List[Finding] = []
    tainted = _tainted_names(fi)
    local = _local_names(fi)
    rel = fi.module.relpath
    for node in nodes:
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            # GC101: host syncs
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS:
                out.append(Finding(
                    "GC101", rel, node.lineno, node.col_offset, fi.qual,
                    f".{node.func.attr}() inside traced code forces a "
                    "host sync (or fails under jit)", reason))
            elif name is not None and \
                    fi.module.normalize(name) in _SYNC_CALLS:
                out.append(Finding(
                    "GC101", rel, node.lineno, node.col_offset, fi.qual,
                    f"{name}() inside traced code forces a host sync",
                    reason))
            elif _host_tensor_copy(node, fi.module):
                out.append(Finding(
                    "GC101", rel, node.lineno, node.col_offset, fi.qual,
                    f"{name or 'a tensor of host data'}() copies host data "
                    "to the device inside traced code — a capture refuses "
                    "it; make the tensor before the trace", reason))
            elif name in _COERCERS and node.args and \
                    _is_tainted_expr(node.args[0], tainted):
                out.append(Finding(
                    "GC101", rel, node.lineno, node.col_offset, fi.qual,
                    f"{name}() of a traced value inside traced code "
                    "forces a host sync", reason))
            elif name is not None and name.split(".")[0] in ("np", "numpy") \
                    and name.split(".")[-1] in _NP_MATERIALIZE \
                    and node.args and _is_tainted_expr(node.args[0], tainted):
                out.append(Finding(
                    "GC101", rel, node.lineno, node.col_offset, fi.qual,
                    f"{name}() materializes a traced value on host",
                    reason))
            # GC102: host side effects
            elif name is not None and \
                    not name.startswith(_ALLOWED_PREFIXES) and \
                    (name in _IMPURE_CALLS
                     or name.startswith(_IMPURE_PREFIXES)):
                out.append(Finding(
                    "GC102", rel, node.lineno, node.col_offset, fi.qual,
                    f"{name}() inside traced code runs at trace time "
                    "only — its effect/value is frozen into the "
                    "compiled program", reason))
        # GC103: host-state mutation
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    out.append(Finding(
                        "GC103", rel, t.lineno, t.col_offset, fi.qual,
                        f"assignment to self.{t.attr} inside traced "
                        "code mutates host state at trace time — it "
                        "will not re-run per step", reason))
                elif isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id not in local:
                    out.append(Finding(
                        "GC103", rel, t.lineno, t.col_offset, fi.qual,
                        f"assignment to {t.value.id}.{t.attr} inside "
                        "traced code mutates module (or closure) state at "
                        "trace time — it will not re-run per step", reason))
        elif isinstance(node, ast.Global):
            out.append(Finding(
                "GC103", rel, node.lineno, node.col_offset, fi.qual,
                "`global` declaration inside traced code — host-state "
                "mutation at trace time", reason))
    return out


def _check_jit_in_loop(fi: FunctionInfo) -> List[Finding]:
    """GC104: jax.jit(...) constructed lexically inside a loop body."""
    out: List[Finding] = []
    rel = fi.module.relpath

    def scan(node: ast.AST, in_loop: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # a def in a loop builds once per call, not here
            child_in_loop = in_loop
            if isinstance(child, (ast.For, ast.While, ast.AsyncFor)):
                child_in_loop = True
            if in_loop and isinstance(child, ast.Call):
                name = dotted(child.func)
                norm = fi.module.normalize(name) if name else None
                leaf = norm.split(".")[-1] if norm else ""
                if leaf == "jit" and (("jax" in norm) or name == "jit"):
                    out.append(Finding(
                        "GC104", rel, child.lineno, child.col_offset,
                        fi.qual,
                        "jax.jit(...) constructed inside a loop body — "
                        "a fresh callable (and jit cache) per "
                        "iteration; hoist it out of the loop"))
            scan(child, child_in_loop)

    scan(fi.node, False)
    return out
