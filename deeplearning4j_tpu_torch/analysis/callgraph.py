"""Module-level call graph + trace-boundary inference (stdlib ``ast`` only;
a copy of ``deeplearning4j_tpu/analysis/callgraph.py`` with the port's
purity boundary added).

The traced-code set is the load-bearing input to every GC1xx purity rule
and the severity escalation of the GC2xx determinism rules, so it is
computed once here and shared:

1. **Seeds** — code that enters a trace or a capture directly:

   - the reference's: ``jax.jit(f)`` / ``@jax.jit`` /
     ``@partial(jax.jit, ...)``, ``shard_map(f, ...)``,
     ``pl.pallas_call(kernel, ...)``, ``@jax.custom_vjp`` /
     ``@custom_jvp`` and ``f.defvjp(fwd, bwd)``, ``jax.grad`` /
     ``value_and_grad`` / ``vmap`` / ``pmap`` / ``checkpoint`` /
     ``remat``, and ``jax.lax.{scan,while_loop,fori_loop,cond,map}``
     bodies.  They stay, so this analyzer and the reference's agree on
     the reference's fixtures.
   - the port's: **a CUDA-graph capture block**.  Every call made
     lexically inside the body of ``with torch.cuda.graph(...)`` seeds
     its resolved callee, and the block's own statements are checked as
     traced code (``CallGraph.captures``).  The function that holds the
     block is not traced: its warm-up and its synchronizations outside
     the block are legal.
   - **a callable passed in and called inside a capture block**: where a
     block calls a parameter of its function (``_Replays.__call__``'s
     ``fn``, ``ForwardGraph``'s ``fwd``), every call site of that
     function seeds the argument bound to the parameter: a function
     reference, or the calls in a lambda's body (which is checked as
     traced code too, ``CallGraph.captured_lambdas``).  A caller that
     forwards a parameter of its own there becomes such a function in
     turn.

2. **Closure** — traced-ness propagates through resolved call edges
   (calling ``g()`` from traced ``f`` runs ``g`` at trace time) and
   through function *references* (passing ``loss_fn`` to
   ``value_and_grad`` inside a traced step).  Resolution is lexical
   (nested defs, skipping class scopes), then ``self.method`` within
   the innermost class, then module functions, then cross-module
   through ``from ..x import y`` / ``import x as m`` of analyzed
   modules.  The port adds four edges:

   - ``X.apply(...)`` of a ``torch.autograd.Function`` subclass calls
     ``X.forward`` and ``X.backward`` (a captured backward replays
     them).  Autograd Functions are not seeds of their own.
   - Calling a name (or ``self`` attribute) assigned ``C(...)`` of a
     class of the package calls ``C.__call__``.  (``C(...)`` itself is
     followed only to map a call site's arguments to ``C.__init__``'s
     parameters, item 1: a constructor's ``self.x = ...`` writes a new
     object, not state that outlives the step.)
   - ``obj.m(...)`` on a name that is neither ``self`` nor an import
     (a parameter, a local) resolves to ``C.m`` when ``obj`` is a
     parameter annotated with a class ``C`` of the package (or one of
     its bases there).  Otherwise it resolves by the method's name, when
     ``m`` is private (one leading underscore): to every method named
     ``m`` in the package, a protocol the package's own classes
     implement (``_loss_and_grads``, ``_apply_updates``, ``_batch_at``).
     A public ``m`` resolves only to a function handed to a class of the
     package as the keyword ``m=f``: a record of callables, as
     ``DecodeProgram(step_multi=step_multi)``.  Any other public name
     (``forward``, ``apply``, ``gather``: a tensor's or a container's
     method as likely as the package's) stays unresolved.
   - A function that calls ``torch.distributed`` itself is a collective
     boundary: the closure does not enter it.  Its host staging (gloo's
     ``.cpu()`` copies) runs only across ranks, where nothing is
     captured; on one rank every caller returns before reaching it.

The same graph answers determinism-reachability queries: given root
patterns (the step / checkpoint-replay / trace-export entry points),
``reachable_from`` returns every function on such a path plus which
root reaches it — that is what turns a GC201 wall-clock *warning* into
"this one backs a bit-identity gate".
"""

from __future__ import annotations

import ast
import fnmatch
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

# leaf callable names that trace their function-valued arguments.
# Bare-name matches are restricted to the unambiguous ones; generic leaves
# (scan, cond, ...) additionally need a jax-ish prefix to match.
_TRACER_LEAVES = {
    "jit", "pmap", "vmap", "grad", "value_and_grad", "shard_map",
    "pallas_call", "custom_vjp", "custom_jvp", "checkpoint", "remat",
    "scan", "while_loop", "fori_loop", "cond", "map", "associative_scan",
    "switch",
}
_BARE_OK = {"jit", "shard_map", "pallas_call", "custom_vjp", "custom_jvp",
            "value_and_grad"}

# context managers whose body is recorded into a CUDA graph
_CAPTURE_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
_AUTOGRAD_FUNCTION = "torch.autograd.Function"
_DISTRIBUTED = "torch.distributed"


def dotted(node: ast.AST) -> Optional[str]:
    """'jax.lax.scan' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_private(name: str) -> bool:
    return name.startswith("_") and not name.startswith("__")


class FunctionInfo:
    __slots__ = ("qual", "node", "module", "class_name", "scope",
                 "calls", "refs", "traced_reason", "params", "positional",
                 "collective", "annotations")

    def __init__(self, qual: str, node: ast.AST, module: "ModuleInfo",
                 class_name: Optional[str], scope: Tuple[Tuple[str, str], ...]):
        self.qual = qual
        self.node = node
        self.module = module
        self.class_name = class_name
        self.scope = scope          # ((kind, name), ...) enclosing chain
        # ("name", n) | ("self", m) | ("attr", base, leaf[, "chain"])
        # | ("apply", dotted)
        self.calls: Set[Tuple] = set()
        self.refs: Set[str] = set()      # bare Name loads (potential fn refs)
        self.traced_reason: Optional[str] = None
        self.params: Set[str] = set()
        self.positional: List[str] = []  # positional parameters, in order
        self.collective = False          # calls torch.distributed itself
        self.annotations: Dict[str, str] = {}  # parameter -> dotted class

    @property
    def gid(self) -> str:
        return f"{self.module.relpath}::{self.qual}"

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 0)

    @property
    def is_method(self) -> bool:
        """A method that takes its receiver first (not a staticmethod)."""
        if not (self.scope and self.scope[-1][0] == "class"):
            return False
        return not any(dotted(d) == "staticmethod"
                       for d in self.node.decorator_list)


class ModuleInfo:
    __slots__ = ("relpath", "modkey", "tree", "source", "lines",
                 "functions", "classes", "imports", "class_bases",
                 "instances")

    def __init__(self, relpath: str, modkey: str, tree: ast.Module,
                 source: str):
        self.relpath = relpath      # repo-relative posix path
        self.modkey = modkey        # package-relative dotted, e.g. "nn.multilayer"
        self.tree = tree
        self.source = source
        self.lines = source.splitlines()
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, Set[str]] = {}       # class -> method names
        self.imports: Dict[str, Tuple] = {}  # alias -> ("module", key) | ("symbol", modkey, name)
        self.class_bases: Dict[str, List[str]] = {}  # class -> dotted bases
        # instance bindings: ("name", n) | ("self", class, attr) -> class names
        self.instances: Dict[Tuple, Set[str]] = {}

    def normalize(self, dotted_name: str) -> str:
        """Rewrite a leading import alias to its target dotted path."""
        head, _, rest = dotted_name.partition(".")
        imp = self.imports.get(head)
        if imp is None:
            return dotted_name
        if imp[0] == "module":
            base = imp[1]
        else:
            base = f"{imp[1]}.{imp[2]}"
        return f"{base}.{rest}" if rest else base


class CaptureBlock:
    """The body of one ``with torch.cuda.graph(...)`` block."""

    __slots__ = ("module", "fn", "node", "reason")

    def __init__(self, module: ModuleInfo, fn: Optional[FunctionInfo],
                 node: ast.With, reason: str):
        self.module = module
        self.fn = fn
        self.node = node
        self.reason = reason


def _resolve_relative(modkey: str, module: Optional[str], level: int) -> str:
    """'from ..ops import x' inside 'parallel.trainer' -> 'ops[.x]'."""
    if level == 0:
        return module or ""
    parts = modkey.split(".") if modkey else []
    # level 1 = current package (drop the module segment), each extra
    # level drops one more package
    base = parts[:-level] if level <= len(parts) else []
    if module:
        base = base + module.split(".")
    return ".".join(base)


def _annotated_class(ann: Optional[ast.AST]) -> Optional[str]:
    """The dotted class an annotation names: ``C``, ``m.C``, ``"C"`` or
    ``Optional[C]``; else None."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.Subscript) and dotted(ann.value) in (
            "Optional", "typing.Optional"):
        ann = ann.slice
    return dotted(ann) if ann is not None else None


def _call_targets(func: ast.AST) -> List[Tuple]:
    """The callee tuples of a call's ``func``, as ``FunctionInfo.calls``
    holds them: the reference's one, and ``("apply", base)`` besides for
    ``base.apply(...)``."""
    fname = dotted(func)
    if not fname:
        return []
    parts = fname.split(".")
    if len(parts) == 1:
        return [("name", parts[0])]
    if parts[0] == "self" and len(parts) == 2:
        out = [("self", parts[1])]
    elif len(parts) == 2:
        out = [("attr", parts[0], parts[1])]
    else:   # a.b.m(...): the reference's tuple, marked as a chain
        out = [("attr", parts[0], parts[-1], "chain")]
    if parts[-1] == "apply":
        out.append(("apply", ".".join(parts[:-1])))
    return out


class _Collector(ast.NodeVisitor):
    """One pass per module: functions, classes, imports, per-function
    call/ref edges, trace seeds and capture blocks."""

    def __init__(self, mod: ModuleInfo, graph: "CallGraph"):
        self.mod = mod
        self.graph = graph
        self.stack: List[Tuple[str, str]] = []   # (kind, name)
        self.fn_stack: List[FunctionInfo] = []
        self.capture: Optional[CaptureBlock] = None

    # -- imports -------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            alias = a.asname or a.name.split(".")[0]
            target = a.name if a.asname else a.name.split(".")[0]
            self.mod.imports[alias] = ("module", target)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = _resolve_relative(self.mod.modkey, node.module, node.level)
        for a in node.names:
            alias = a.asname or a.name
            self.mod.imports[alias] = ("symbol", base, a.name)

    # -- scopes --------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.mod.classes.setdefault(node.name, set())
        self.mod.class_bases[node.name] = [d for d in map(dotted, node.bases)
                                           if d]
        self.stack.append(("class", node.name))
        self.generic_visit(node)
        self.stack.pop()

    def _qual(self, name: str) -> str:
        return ".".join([n for _, n in self.stack] + [name])

    def _class_name(self) -> Optional[str]:
        for kind, name in reversed(self.stack):
            if kind == "class":
                return name
        return None

    def _enter_function(self, node) -> None:
        qual = self._qual(node.name)
        fi = FunctionInfo(qual, node, self.mod, self._class_name(),
                          tuple(self.stack))
        a = node.args
        for arg in (list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else [])):
            fi.params.add(arg.arg)
        fi.positional = [arg.arg for arg in list(a.posonlyargs) + list(a.args)]
        for arg in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
            ann = _annotated_class(arg.annotation)
            if ann:
                fi.annotations[arg.arg] = ann
        self.mod.functions[qual] = fi
        if self.stack and self.stack[-1][0] == "class":
            self.mod.classes[self.stack[-1][1]].add(node.name)
        # decorators are evaluated in the ENCLOSING scope
        for dec in node.decorator_list:
            self._check_decorator(dec, fi)
            self.visit(dec)
        self.stack.append(("func", node.name))
        self.fn_stack.append(fi)
        # a def inside a capture block is not run by it
        outer, self.capture = self.capture, None
        for child in ast.iter_child_nodes(node):
            if child in node.decorator_list:
                continue
            self.visit(child)
        self.capture = outer
        self.fn_stack.pop()
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter_function(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._enter_function(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.generic_visit(node)

    # -- capture blocks ------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        block = None
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call):
                name = dotted(ctx.func)
                if name and self.mod.normalize(name) in _CAPTURE_CONTEXTS:
                    block = CaptureBlock(
                        self.mod, self.fn_stack[-1] if self.fn_stack else None,
                        node, f"captured by {name} at "
                              f"{self.mod.relpath}:{node.lineno}")
            self.visit(item)
        if block is None:
            for stmt in node.body:
                self.visit(stmt)
            return
        self.graph.captures.append(block)
        outer, self.capture = self.capture, block
        for stmt in node.body:
            self.visit(stmt)
        self.capture = outer

    # -- instance bindings ---------------------------------------------
    def _record_instance(self, target: ast.AST, value: ast.AST) -> None:
        calls = [value.body, value.orelse] if isinstance(value, ast.IfExp) \
            else [value]
        classes = {dotted(c.func) for c in calls if isinstance(c, ast.Call)}
        classes.discard(None)
        if not classes:
            return
        key = None
        if isinstance(target, ast.Name):
            key = ("name", target.id)
        elif isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self" and self._class_name():
            key = ("self", self._class_name(), target.attr)
        if key is not None:
            self.mod.instances.setdefault(key, set()).update(classes)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_instance(t, node.value)
        self.generic_visit(node)

    # -- trace seeds ---------------------------------------------------
    def _is_tracer(self, dotted_name: Optional[str]) -> bool:
        if not dotted_name:
            return False
        norm = self.mod.normalize(dotted_name)
        leaf = norm.split(".")[-1]
        if leaf not in _TRACER_LEAVES:
            return False
        prefix = norm.rsplit(".", 1)[0] if "." in norm else ""
        if prefix:
            return "jax" in prefix or "jax_compat" in prefix \
                or "pallas" in prefix
        return leaf in _BARE_OK

    def _seed_arg(self, arg: ast.AST, reason: str) -> None:
        tgt = None
        if isinstance(arg, ast.Name):
            tgt = ("name", arg.id)
        elif isinstance(arg, ast.Attribute) and \
                isinstance(arg.value, ast.Name) and arg.value.id == "self":
            tgt = ("self", arg.attr)
        if tgt is None:
            return
        fn = self.fn_stack[-1] if self.fn_stack else None
        # defer: the target may live later in this module or in a module
        # not collected yet
        self.graph._pending_arg_seeds.append((self.mod, fn, tgt, reason))

    def _check_decorator(self, dec: ast.AST, fi: FunctionInfo) -> None:
        name = dotted(dec)
        if name is None and isinstance(dec, ast.Call):
            fname = dotted(dec.func)
            if fname and fname.split(".")[-1] == "partial" and dec.args:
                name = dotted(dec.args[0])
            else:
                name = fname
        if name and self._is_tracer(name):
            self.graph._seed(fi.gid,
                             f"@{name} at {self.mod.relpath}:{fi.line}")

    def visit_Call(self, node: ast.Call) -> None:
        fname = dotted(node.func)
        fn = self.fn_stack[-1] if self.fn_stack else None
        targets = _call_targets(node.func)
        # record the call edges
        if fn is not None:
            fn.calls.update(targets)
            if fname and "." in fname and \
                    self.mod.normalize(fname).startswith(_DISTRIBUTED + "."):
                fn.collective = True
            if node.args or node.keywords:
                for t in targets:
                    self.graph._call_sites.append((self.mod, fn, t, node))
            for kw in node.keywords:
                if fname and kw.arg and isinstance(kw.value, ast.Name):
                    self.graph._fields.append((self.mod, fn, fname, kw.arg,
                                               kw.value.id))
        # capture seeds: every call in the block's body
        if self.capture is not None:
            for t in targets:
                self.graph._pending_arg_seeds.append(
                    (self.mod, fn, t, self.capture.reason))
                if fn is not None and t[0] == "name" and t[1] in fn.params:
                    self.graph._capturing[(fn.gid, t[1])] = \
                        self.capture.reason
        # trace seeds: f.defvjp(fwd, bwd)
        if fname and fname.split(".")[-1] == "defvjp":
            for a in node.args:
                self._seed_arg(a, f"defvjp at {self.mod.relpath}:"
                                  f"{node.lineno}")
        # trace seeds: jit(f) / shard_map(f) / pallas_call(k) / grad(f)...
        seed_name = fname
        if fname and fname.split(".")[-1] == "partial" and node.args:
            seed_name = dotted(node.args[0])
            if seed_name and self._is_tracer(seed_name) and len(node.args) > 1:
                self._seed_arg(node.args[1],
                               f"partial({seed_name}) at "
                               f"{self.mod.relpath}:{node.lineno}")
        elif fname and self._is_tracer(fname) and node.args:
            self._seed_arg(node.args[0],
                           f"{fname} at {self.mod.relpath}:{node.lineno}")
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) and self.fn_stack:
            self.fn_stack[-1].refs.add(node.id)


class CallGraph:
    """All analyzed modules + the traced set + reachability queries."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}     # modkey -> info
        self.functions: Dict[str, FunctionInfo] = {}  # gid -> info
        self._pending_seeds: List[Tuple[str, str]] = []
        self._pending_arg_seeds: List[Tuple] = []
        self.traced: Dict[str, str] = {}             # gid -> reason
        self._edges: Dict[str, Set[str]] = {}
        #: capture blocks, checked as traced code
        self.captures: List[CaptureBlock] = []
        #: lambdas passed to a capturing parameter, checked as traced code
        self.captured_lambdas: List[Tuple[FunctionInfo, ast.Lambda, str]] = []
        # (gid, parameter) called inside a capture block -> reason
        self._capturing: Dict[Tuple[str, str], str] = {}
        self._call_sites: List[Tuple] = []
        self._by_leaf: Dict[str, List[FunctionInfo]] = {}
        # keyword -> (module, function, class called, value name)
        self._fields: List[Tuple] = []
        self._field_fns: Dict[str, Set[str]] = {}

    # -- construction --------------------------------------------------
    @classmethod
    def build(cls, files: Sequence[Tuple[str, str, str]]) -> "CallGraph":
        """files: (relpath, modkey, source) triples."""
        g = cls()
        collectors = []
        for relpath, modkey, source in files:
            tree = ast.parse(source, filename=relpath)
            mod = ModuleInfo(relpath, modkey, tree, source)
            g.modules[modkey] = mod
            collectors.append(mod)
        # two passes: register all functions first so seeds recorded while
        # visiting module A can resolve into module B
        for mod in collectors:
            _Collector(mod, g).visit(mod.tree)
        for mod in collectors:
            for fi in mod.functions.values():
                g.functions[fi.gid] = fi
                if fi.scope and fi.scope[-1][0] == "class" and \
                        _is_private(fi.qual.split(".")[-1]):
                    g._by_leaf.setdefault(fi.qual.split(".")[-1],
                                          []).append(fi)
        # seeds recorded during collection are replayed now that every
        # function is registered (decorator seeds carry gids; argument
        # seeds carry unresolved callee tuples)
        for mod, fn, cls_name, field, value in g._fields:
            if g._resolve_class(mod, cls_name) is None:
                continue
            gid = g._resolve(mod, fn, ("name", value))
            if gid is not None:
                g._field_fns.setdefault(field, set()).add(gid)
        for gid, reason in g._pending_seeds:
            if gid in g.functions and gid not in g.traced:
                g.traced[gid] = reason
        for mod, fn, tgt, reason in g._pending_arg_seeds:
            for gid in g._resolve_all(mod, fn, tgt):
                if gid not in g.traced:
                    g.traced[gid] = reason
        g._seed_passed_callables()
        g._close_traced()
        return g

    def _seed(self, gid: str, reason: str) -> None:
        self._pending_seeds.append((gid, reason))

    # -- resolution ----------------------------------------------------
    def _lexical_prefixes(self, fn: Optional[FunctionInfo]):
        """Quals to prepend when looking up a bare name from inside fn:
        own body, then enclosing FUNCTION scopes (class scopes are not
        visible from method bodies), then module level."""
        if fn is None:
            yield ""
            return
        chain = list(fn.scope) + [("func", fn.qual.split(".")[-1])]
        for i in range(len(chain), 0, -1):
            if chain[i - 1][0] != "func":
                continue
            yield ".".join(n for _, n in chain[:i])
        yield ""

    def _resolve(self, mod: ModuleInfo, fn: Optional[FunctionInfo],
                 callee: Tuple) -> Optional[str]:
        """The reference's lexical resolution: one gid or None."""
        kind = callee[0]
        if kind == "name":
            name = callee[1]
            for prefix in self._lexical_prefixes(fn):
                qual = f"{prefix}.{name}" if prefix else name
                if qual in mod.functions:
                    return mod.functions[qual].gid
            imp = mod.imports.get(name)
            if imp and imp[0] == "symbol" and imp[1] in self.modules:
                target = self.modules[imp[1]]
                if imp[2] in target.functions:
                    return target.functions[imp[2]].gid
        elif kind == "self":
            name = callee[1]
            if fn is not None and fn.class_name:
                qual = f"{fn.class_name}.{name}"
                # the class may be nested; search any class-qualified match
                if qual in mod.functions:
                    return mod.functions[qual].gid
                for q, f2 in mod.functions.items():
                    if f2.class_name == fn.class_name and \
                            q.split(".")[-1] == name:
                        return f2.gid
        elif kind == "attr":
            base, leaf = callee[1], callee[2]
            imp = mod.imports.get(base)
            if imp and imp[0] == "module" and imp[1] in self.modules:
                target = self.modules[imp[1]]
                if leaf in target.functions:
                    return target.functions[leaf].gid
            if imp and imp[0] == "symbol":
                # from ..pkg import submodule  (symbol that IS a module)
                subkey = f"{imp[1]}.{imp[2]}" if imp[1] else imp[2]
                if subkey in self.modules:
                    target = self.modules[subkey]
                    if leaf in target.functions:
                        return target.functions[leaf].gid
        return None

    def _resolve_class(self, mod: ModuleInfo,
                       name: str) -> Optional[Tuple[ModuleInfo, str]]:
        """(module, class name) of a class of the analyzed files that
        ``name`` (bare, imported, or ``module.Class``) denotes."""
        head, _, rest = name.partition(".")
        if not rest:
            if head in mod.classes:
                return mod, head
            imp = mod.imports.get(head)
            if imp and imp[0] == "symbol" and imp[1] in self.modules and \
                    imp[2] in self.modules[imp[1]].classes:
                return self.modules[imp[1]], imp[2]
            return None
        if "." in rest:
            return None
        imp = mod.imports.get(head)
        if imp is None:
            return None
        key = imp[1] if imp[0] == "module" else \
            (f"{imp[1]}.{imp[2]}" if imp[1] else imp[2])
        target = self.modules.get(key)
        if target is not None and rest in target.classes:
            return target, rest
        return None

    def _method(self, owner: Tuple[ModuleInfo, str],
                name: str) -> Optional[str]:
        mod, cls = owner
        fi = mod.functions.get(f"{cls}.{name}")
        return fi.gid if fi is not None else None

    def _method_in_bases(self, owner: Tuple[ModuleInfo, str], name: str,
                         seen: Optional[Set] = None) -> Optional[str]:
        """``owner``'s method ``name``, or the first of its package bases'."""
        gid = self._method(owner, name)
        if gid is not None:
            return gid
        seen = set() if seen is None else seen
        mod, cls = owner
        for base in mod.class_bases.get(cls, ()):
            up = self._resolve_class(mod, base)
            if up is not None and up not in seen:
                seen.add(up)
                gid = self._method_in_bases(up, name, seen)
                if gid is not None:
                    return gid
        return None

    def _annotation_of(self, fn: Optional[FunctionInfo],
                       name: str) -> Optional[str]:
        """The annotation of parameter ``name`` in ``fn`` or in the
        function scopes around it."""
        while fn is not None:
            if name in fn.params:
                return fn.annotations.get(name)
            outer = ".".join(n for _, n in fn.scope)
            fn = fn.module.functions.get(outer) if fn.scope and \
                fn.scope[-1][0] == "func" else None
        return None

    def is_autograd_function(self, owner: Tuple[ModuleInfo, str]) -> bool:
        mod, cls = owner
        return any(mod.normalize(b) == _AUTOGRAD_FUNCTION
                   for b in mod.class_bases.get(cls, ()))

    def _instance_classes(self, mod: ModuleInfo, fn: Optional[FunctionInfo],
                          callee: Tuple) -> Set[str]:
        if callee[0] == "name":
            return mod.instances.get(("name", callee[1]), set())
        if callee[0] == "self" and fn is not None and fn.class_name:
            return mod.instances.get(("self", fn.class_name, callee[1]), set())
        return set()

    def _resolve_all(self, mod: ModuleInfo, fn: Optional[FunctionInfo],
                     callee: Tuple, constructors: bool = False) -> List[str]:
        """Every gid a call may run: the reference's lexical resolution,
        then the port's edges (module docstring, item 2); with
        ``constructors``, ``C(...)`` also resolves to ``C.__init__``."""
        kind = callee[0]
        if kind == "apply":
            owner = self._resolve_class(mod, callee[1])
            if owner is None or not self.is_autograd_function(owner):
                return []
            return [g for g in (self._method(owner, "forward"),
                                self._method(owner, "backward")) if g]
        gid = self._resolve(mod, fn, callee)
        if gid is not None:
            return [gid]
        out: List[str] = []
        if kind == "name" and constructors:
            owner = self._resolve_class(mod, callee[1])
            if owner is not None:
                init = self._method(owner, "__init__")
                return [init] if init else []
        if kind in ("name", "self"):
            for cls in self._instance_classes(mod, fn, callee):
                owner = self._resolve_class(mod, cls)
                call = self._method(owner, "__call__") if owner else None
                if call:
                    out.append(call)
            return out
        if kind == "attr":
            base, leaf = callee[1], callee[2]
            if base in mod.imports or leaf.startswith("__"):
                return []
            ann = self._annotation_of(fn, base) if len(callee) == 3 else None
            owner = self._resolve_class(mod, ann) if ann else None
            if owner is not None:
                gid = self._method_in_bases(owner, leaf)
                return [gid] if gid else []
            out = [d.gid for d in self._by_leaf.get(leaf, ())]
            out.extend(sorted(self._field_fns.get(leaf, ())))
        return out

    def edges_of(self, fi: FunctionInfo) -> Set[str]:
        cached = self._edges.get(fi.gid)
        if cached is not None:
            return cached
        out: Set[str] = set()
        for callee in fi.calls:
            out.update(self._resolve_all(fi.module, fi, callee))
        for name in fi.refs:
            gid = self._resolve(fi.module, fi, ("name", name))
            if gid is not None and gid != fi.gid:
                out.add(gid)
        self._edges[fi.gid] = out
        return out

    # -- passed callables ----------------------------------------------
    def _bound_arg(self, callee: FunctionInfo, call: ast.Call,
                   param: str) -> Optional[ast.AST]:
        """The argument expression ``call`` binds to ``callee``'s
        ``param``, or None."""
        for kw in call.keywords:
            if kw.arg == param:
                return kw.value
        pos = list(callee.positional)
        if callee.is_method:
            pos = pos[1:]
        if param not in pos:
            return None
        i = pos.index(param)
        for j, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                return None
            if j == i:
                return a
        return None

    def _seed_passed_callables(self) -> None:
        """Seed every function (or lambda body) passed to a parameter
        that a capture block calls, to a fixed point (module docstring,
        item 1)."""
        done: Set[Tuple[str, int]] = set()
        changed = True
        while changed:
            changed = False
            for mod, fn, target, call in self._call_sites:
                for gid in self._resolve_all(mod, fn, target,
                                             constructors=True):
                    callee = self.functions[gid]
                    for param in sorted(callee.params):
                        reason = self._capturing.get((gid, param))
                        if reason is None or (gid + param, id(call)) in done:
                            continue
                        done.add((gid + param, id(call)))
                        arg = self._bound_arg(callee, call, param)
                        if arg is None:
                            continue
                        changed |= self._seed_passed(mod, fn, arg, reason)

    def _seed_passed(self, mod: ModuleInfo, fn: FunctionInfo, arg: ast.AST,
                     reason: str) -> bool:
        if isinstance(arg, ast.Lambda):
            changed = False
            if all(lam is not arg for _, lam, _ in self.captured_lambdas):
                self.captured_lambdas.append((fn, arg, reason))
            for node in ast.walk(arg.body):
                if not isinstance(node, ast.Call):
                    continue
                for target in _call_targets(node.func):
                    if target[0] == "name" and target[1] in fn.params:
                        changed |= self._seed_passed(
                            mod, fn, ast.Name(target[1], ast.Load()), reason)
                    for gid in self._resolve_all(mod, fn, target):
                        self.traced.setdefault(gid, reason)
            return changed
        if isinstance(arg, ast.Name) and arg.id in fn.params:
            if (fn.gid, arg.id) not in self._capturing:
                self._capturing[(fn.gid, arg.id)] = reason
                return True
            return False
        target = None
        if isinstance(arg, ast.Name):
            target = ("name", arg.id)
        elif isinstance(arg, ast.Attribute) and \
                isinstance(arg.value, ast.Name) and arg.value.id == "self":
            target = ("self", arg.attr)
        if target is not None:
            gid = self._resolve(mod, fn, target)
            if gid is not None:
                self.traced.setdefault(gid, reason)
        return False

    # -- traced closure ------------------------------------------------
    def _close_traced(self) -> None:
        work = list(self.traced)
        while work:
            gid = work.pop()
            fi = self.functions.get(gid)
            if fi is None:
                continue
            reason = f"called from traced {fi.qual}"
            for callee in self.edges_of(fi):
                if callee not in self.traced and \
                        not self.functions[callee].collective:
                    self.traced[callee] = reason
                    work.append(callee)

    def is_traced(self, fi: FunctionInfo) -> bool:
        return fi.gid in self.traced

    # -- reachability --------------------------------------------------
    def match(self, patterns: Sequence[str]) -> List[FunctionInfo]:
        """Match 'Class.method' / '*.fit_batch' / 'mod.py::qual' globs
        against every function's gid and qual."""
        out = []
        for fi in self.functions.values():
            for pat in patterns:
                if fnmatch.fnmatch(fi.qual, pat) or \
                        fnmatch.fnmatch(fi.gid, pat):
                    out.append(fi)
                    break
        return out

    def reachable_from(self, roots: Sequence[FunctionInfo]) -> Dict[str, str]:
        """gid -> root qual for everything transitively reachable."""
        seen: Dict[str, str] = {}
        work: List[Tuple[str, str]] = [(r.gid, r.qual) for r in roots]
        while work:
            gid, root = work.pop()
            if gid in seen:
                continue
            seen[gid] = root
            fi = self.functions.get(gid)
            if fi is None:
                continue
            for callee in self.edges_of(fi):
                if callee not in seen:
                    work.append((callee, root))
        return seen


def load_package(root: str, package_dir: str,
                 exclude: Sequence[str] = ()) -> List[Tuple[str, str, str]]:
    """Collect (relpath, modkey, source) for every .py under package_dir."""
    out = []
    base = os.path.join(root, package_dir)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__" and d not in exclude)
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            if any(fnmatch.fnmatch(rel, e) for e in exclude):
                continue
            inner = os.path.relpath(full, base).replace(os.sep, "/")
            modkey = inner[:-3].replace("/", ".")
            if modkey.endswith("__init__"):
                modkey = modkey[: -len("__init__")].rstrip(".")
            with open(full, "r", encoding="utf-8") as f:
                out.append((rel, modkey, f.read()))
    return out
