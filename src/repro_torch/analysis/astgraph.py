"""Module parsing and the capture-reachability call graph.

The analysis is purely syntactic (``ast``): no file under analysis is
ever imported, so linting needs no CUDA device and runs no benchmark
code.  The graph answers one question the rules all share: *which
functions run inside a captured program?*  In the port a program is a
CUDA graph: a function is **in-trace** (capture-reachable) when it is

* called inside a capture region: the body of ``with
  torch.cuda.graph(...)``, or the statements between
  ``g.capture_begin()`` and ``g.capture_end()``;
* handed to a function that captures one of its parameters, which is
  derived, not listed: ``fed/graphs.RoundProgram.__init__`` calls its
  ``fn`` (through ``self.fn``) inside ``torch.cuda.graph``, so
  ``RoundProgram(body, …)`` captures ``body``, and
  ``BatchedEngine._program(key, fn, …)``, which passes its ``fn`` on to
  ``RoundProgram``, captures its second argument too;
* passed to ``torch.cuda.make_graphed_callables``, or
* (transitively) called from an in-trace function, resolved through
  same-module names, ``self.`` methods, and ``from repro_torch.x import
  y`` style imports.

What counts as a trace is a :class:`Dialect`; ``TORCH`` is the port's.
The engines are those of ``repro.analysis.astgraph``: given a dialect
with the reference's JAX wrapper names, they mark what the reference
marks (``tests/test_torch_tracelint.py`` holds them to it).

Resolution is best-effort: attribute calls on unknown objects
(``eng.scbf_round(...)``) produce no edge.  That under-approximation is
deliberate — rules that key on in-trace membership stay low
false-positive, and the committed baseline absorbs what slips through.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

_PARTIAL_NAMES = frozenset({"functools.partial", "partial"})

_CACHE_DECORATORS = frozenset({"functools.lru_cache", "lru_cache",
                               "functools.cache", "cache"})


@dataclass(frozen=True)
class Dialect:
    """What runs inside a traced program, and what builds one.

    Names are matched exactly after import-alias resolution, as the
    reference matches its own.
    """

    # callables whose FIRST argument runs inside the program
    tracing_wrappers: FrozenSet[str]
    # calls that build a program (the TL001 class: rebuilt per call, it
    # recompiles or re-captures every call); their first argument, if
    # any, runs inside the program too
    program_makers: FrozenSet[str]
    partial_names: FrozenSet[str] = _PARTIAL_NAMES
    cache_decorators: FrozenSet[str] = _CACHE_DECORATORS
    # ``with`` managers whose body is captured
    capture_contexts: FrozenSet[str] = frozenset()
    # (begin, end) methods bracketing captured statements
    capture_methods: Tuple[str, ...] = ()
    # the top-level package whose import marks a module as device code
    backend: str = "torch"


TORCH = Dialect(
    tracing_wrappers=frozenset({"torch.cuda.make_graphed_callables",
                                "make_graphed_callables"}),
    program_makers=frozenset({"torch.cuda.CUDAGraph", "CUDAGraph",
                              "torch.cuda.make_graphed_callables",
                              "make_graphed_callables"}),
    capture_contexts=frozenset({"torch.cuda.graph",
                                "torch.cuda.graphs.graph"}),
    capture_methods=("capture_begin", "capture_end"),
)

SCALAR_ANNOTATIONS = {"int", "bool", "str", "float", "Optional[int]",
                      "Optional[str]", "Optional[bool]", "Optional[float]"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


@dataclass
class FunctionInfo:
    """One function (or method, or nested def) in one module."""

    qualname: str                    # e.g. "Engine.scbf_round" / "f.<g>"
    module: str                      # dotted module name
    node: ast.AST                    # FunctionDef | AsyncFunctionDef | Lambda
    lineno: int
    params: Tuple[str, ...] = ()     # positional + keyword parameter names
    posonly_params: Tuple[str, ...] = ()   # positional(-or-keyword) subset
    kwonly_params: Tuple[str, ...] = ()
    annotations: Dict[str, str] = field(default_factory=dict)
    parent: Optional[str] = None     # enclosing function qualname
    decorators: Tuple[str, ...] = ()
    static_params: Set[str] = field(default_factory=set)
    in_trace: bool = False
    calls: Set[str] = field(default_factory=set)       # resolved qualnames
    raw_calls: Set[str] = field(default_factory=set)   # unresolved names

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qualname}"

    @property
    def cached_factory(self) -> bool:
        return any(d.split("(")[0] in _CACHE_DECORATORS
                   for d in self.decorators)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


@dataclass
class ModuleInfo:
    path: str                        # path as given on the command line
    modname: str                     # dotted name ("repro.fed.engine")
    tree: ast.Module
    source_lines: List[str]
    imports: Dict[str, str] = field(default_factory=dict)  # alias -> full
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, Set[str]] = field(default_factory=dict)
    # module-level names bound to program-building calls
    program_symbols: Set[str] = field(default_factory=set)
    imports_backend: bool = False
    dialect: Dialect = TORCH

    def resolve(self, name: str) -> str:
        """Expand the leading alias of a dotted name via the imports."""
        head, _, rest = name.partition(".")
        full = self.imports.get(head)
        if full is None:
            return name
        return f"{full}.{rest}" if rest else full


def module_name_for(path: str, roots: Sequence[str] = ("src",)) -> str:
    """Dotted module name for a file path (src-rooted when possible)."""
    norm = path.replace(os.sep, "/")
    for root in roots:
        marker = f"{root}/"
        if norm.startswith(marker):
            norm = norm[len(marker):]
            break
        idx = norm.find(f"/{root}/")
        if idx >= 0:
            norm = norm[idx + len(root) + 2:]
            break
    if norm.endswith(".py"):
        norm = norm[:-3]
    if norm.endswith("/__init__"):
        norm = norm[: -len("/__init__")]
    return norm.replace("/", ".")


def _collect_imports(tree: ast.Module, backend: str
                     ) -> Tuple[Dict[str, str], bool]:
    imports: Dict[str, str] = {}
    has_backend = False
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                imports[alias.asname or alias.name.split(".")[0]] = \
                    alias.name if alias.asname else alias.name.split(".")[0]
                if alias.name == backend or \
                        alias.name.startswith(backend + "."):
                    has_backend = True
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                imports[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
                if node.module == backend or \
                        node.module.startswith(backend + "."):
                    has_backend = True
    return imports, has_backend


def is_program_expr(node: ast.AST, mod: ModuleInfo) -> bool:
    """Is this expression a program construction (``torch.cuda.CUDAGraph()``
    and the dialect's other makers), or a ``partial`` of one (possibly
    applied: ``partial(maker, ...)(f)``)?"""
    if not isinstance(node, ast.Call):
        return False
    d = mod.dialect
    callee = dotted_name(node.func)
    if callee is not None:
        resolved = mod.resolve(callee)
        if resolved in d.program_makers:
            return True
        if resolved in d.partial_names and node.args:
            first = dotted_name(node.args[0])
            if first is not None and \
                    mod.resolve(first) in d.program_makers:
                return True
    # partial(maker, ...)(f): the applied form
    if isinstance(node.func, ast.Call):
        return is_program_expr(node.func, mod)
    return False


def _static_argnames_of(call: ast.Call) -> Set[str]:
    """Literal ``static_argnames`` of a program maker's call (a JAX
    dialect's ``jit``; a CUDA graph has none)."""
    out: Set[str] = set()
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            val = kw.value
            if isinstance(val, ast.Constant) and isinstance(val.value, str):
                out.add(val.value)
            elif isinstance(val, (ast.Tuple, ast.List)):
                for el in val.elts:
                    if isinstance(el, ast.Constant) and \
                            isinstance(el.value, str):
                        out.add(el.value)
    if isinstance(call.func, ast.Call):        # applied partial form
        out |= _static_argnames_of(call.func)
    return out


class _FunctionCollector(ast.NodeVisitor):
    """First pass: functions, classes, calls, module-level programs."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.scope: List[str] = []         # enclosing class/function names
        self.fn_stack: List[FunctionInfo] = []

    # -- helpers ----------------------------------------------------------

    def _qual(self, name: str) -> str:
        return ".".join(self.scope + [name]) if self.scope else name

    def _add_function(self, node, name: str) -> FunctionInfo:
        args = node.args
        pos = [a.arg for a in args.posonlyargs + args.args]
        kwonly = [a.arg for a in args.kwonlyargs]
        ann: Dict[str, str] = {}
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.annotation is not None:
                try:
                    ann[a.arg] = ast.unparse(a.annotation)
                except Exception:           # pragma: no cover - ast quirk
                    pass
        decos = []
        static: Set[str] = set()
        for d in getattr(node, "decorator_list", []):
            dname = dotted_name(d.func if isinstance(d, ast.Call) else d)
            if dname is not None:
                decos.append(self.mod.resolve(dname))
            if is_program_expr(d, self.mod) or (
                    dname is not None and self.mod.resolve(dname)
                    in self.mod.dialect.program_makers):
                static |= _static_argnames_of(d) \
                    if isinstance(d, ast.Call) else set()
        info = FunctionInfo(
            qualname=self._qual(name), module=self.mod.modname, node=node,
            lineno=node.lineno, params=tuple(pos + kwonly),
            posonly_params=tuple(pos), kwonly_params=tuple(kwonly),
            annotations=ann,
            parent=(self.fn_stack[-1].qualname if self.fn_stack else None),
            decorators=tuple(decos), static_params=static)
        self.mod.functions[info.qualname] = info
        return info

    # -- visitors ---------------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef):
        self.mod.classes.setdefault(node.name, set())
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_fn(self, node, name: str):
        info = self._add_function(node, name)
        if self.scope and self.scope[-1] in self.mod.classes and \
                not self.fn_stack:
            self.mod.classes[self.scope[-1]].add(name)
        self.scope.append(name)
        self.fn_stack.append(info)
        self.generic_visit(node)
        self.fn_stack.pop()
        self.scope.pop()

    def visit_FunctionDef(self, node):
        self._visit_fn(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._visit_fn(node, node.name)

    def visit_Lambda(self, node: ast.Lambda):
        # lambdas participate as anonymous nodes of their enclosing fn
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        callee = dotted_name(node.func)
        if self.fn_stack and callee is not None:
            self.fn_stack[-1].raw_calls.add(callee)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        # module-level `name = maker(f)` / `name = partial(b,...)(f)`
        if not self.fn_stack and is_program_expr(node.value, self.mod):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.mod.program_symbols.add(tgt.id)
        self.generic_visit(node)


def parse_module(path: str, roots: Sequence[str] = ("src",),
                 dialect: Dialect = TORCH) -> Optional[ModuleInfo]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None
    mod = ModuleInfo(path=path, modname=module_name_for(path, roots),
                     tree=tree, source_lines=source.splitlines(),
                     dialect=dialect)
    mod.imports, mod.imports_backend = _collect_imports(tree,
                                                        dialect.backend)
    _FunctionCollector(mod).visit(tree)
    # maker-decorated defs are program symbols of the module
    for info in mod.functions.values():
        node = info.node
        for d in getattr(node, "decorator_list", []):
            if is_program_expr(d, mod) or (
                    dotted_name(d) is not None and mod.resolve(
                        dotted_name(d)) in dialect.program_makers):
                if info.parent is None:
                    mod.program_symbols.add(info.qualname)
    return mod


@dataclass
class CallGraph:
    """All parsed modules plus the resolved in-trace marking."""

    modules: Dict[str, ModuleInfo] = field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    # fully-qualified "module.fn" -> FunctionInfo, for import resolution
    by_dotted: Dict[str, FunctionInfo] = field(default_factory=dict)
    # function key -> the parameters it runs inside a capture
    capturers: Dict[str, Set[str]] = field(default_factory=dict)

    def function_at(self, mod: ModuleInfo, node: ast.AST
                    ) -> Optional[FunctionInfo]:
        """Innermost FunctionInfo whose body contains ``node``."""
        best, best_span = None, None
        for info in mod.functions.values():
            n = info.node
            end = getattr(n, "end_lineno", n.lineno)
            if n.lineno <= node.lineno <= end:
                span = end - n.lineno
                if best_span is None or span <= best_span:
                    best, best_span = info, span
        return best


def _resolve_calls(graph: CallGraph) -> None:
    for mod in graph.modules.values():
        for info in mod.functions.values():
            for raw in info.raw_calls:
                # 1. same-module (respecting nesting / enclosing class)
                target = _resolve_local(mod, info, raw)
                if target is not None:
                    info.calls.add(target.key)
                    continue
                # 2. imported name -> another parsed module's function
                resolved = mod.resolve(raw)
                hit = graph.by_dotted.get(resolved)
                if hit is not None:
                    info.calls.add(hit.key)


def _resolve_local(mod: ModuleInfo, caller: FunctionInfo,
                   raw: str) -> Optional[FunctionInfo]:
    head, _, rest = raw.partition(".")
    if head == "self" and rest and "." not in rest:
        # method call within the caller's class
        cls = caller.qualname.split(".")[0]
        return mod.functions.get(f"{cls}.{rest}")
    if rest:
        return mod.functions.get(raw)       # explicit Class.method
    # nested def of the caller, then siblings up the chain, then module
    prefix = caller.qualname
    while True:
        hit = mod.functions.get(f"{prefix}.{head}" if prefix else head)
        if hit is not None:
            return hit
        if not prefix:
            return None
        prefix = prefix.rpartition(".")[0]


class _TraceRootMarker(ast.NodeVisitor):
    """Mark functions handed to tracing wrappers as in-trace roots."""

    def __init__(self, mod: ModuleInfo, roots: List[FunctionInfo]):
        self.mod = mod
        self.roots = roots
        self._scope: List[str] = []

    def _mark_name(self, name: Optional[str], caller_scope: List[str]):
        if name is None:
            return
        for depth in range(len(caller_scope), -1, -1):
            prefix = ".".join(caller_scope[:depth])
            qual = f"{prefix}.{name}" if prefix else name
            info = self.mod.functions.get(qual)
            if info is not None:
                self.roots.append(info)
                return

    def visit_FunctionDef(self, node):
        info = next((f for f in self.mod.functions.values()
                     if f.node is node), None)
        for d in node.decorator_list:
            dname = dotted_name(d.func if isinstance(d, ast.Call) else d)
            resolved = self.mod.resolve(dname) if dname else None
            if is_program_expr(d, self.mod) or \
                    resolved in self.mod.dialect.tracing_wrappers:
                if info is not None:
                    self.roots.append(info)
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def visit_Call(self, node: ast.Call):
        callee = dotted_name(node.func)
        resolved = self.mod.resolve(callee) if callee else None
        is_wrapper = resolved in self.mod.dialect.tracing_wrappers
        if is_program_expr(node, self.mod) or is_wrapper:
            # the first positional argument is the traced callable
            if node.args:
                first = node.args[0]
                if isinstance(first, ast.Lambda):
                    pass                      # handled by enclosing scope
                else:
                    self._mark_name(dotted_name(first), self._scope)
            # partial(maker, ...) has the callable as the 2nd arg
            if not is_wrapper and isinstance(node.func, ast.Name) is False \
                    and callee is not None and \
                    self.mod.resolve(callee) in \
                    self.mod.dialect.partial_names and \
                    len(node.args) >= 2:
                self._mark_name(dotted_name(node.args[1]), self._scope)
        self.generic_visit(node)


def _own_nodes(fn: FunctionInfo) -> List[ast.AST]:
    """``fn``'s statements and expressions, not those of nested defs
    (each is its own FunctionInfo) or lambdas."""
    out: List[ast.AST] = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            out.append(child)
            walk(child)

    walk(fn.node)
    return out


def _capture_blocks(mod: ModuleInfo, fn: FunctionInfo
                    ) -> List[List[ast.stmt]]:
    """The statement lists ``fn`` runs under a capture: ``with`` bodies of
    the dialect's capture contexts, and the statements between a
    ``capture_begin()`` and the next ``capture_end()`` of one block."""
    d = mod.dialect
    blocks: List[List[ast.stmt]] = []

    def method(st: ast.stmt) -> Optional[str]:
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call) and \
                isinstance(st.value.func, ast.Attribute):
            return st.value.func.attr
        return None

    def scan(stmts: Sequence[ast.stmt]) -> None:
        begin = None
        for i, st in enumerate(stmts):
            if d.capture_methods and method(st) == d.capture_methods[0]:
                begin = i
            elif d.capture_methods and begin is not None and \
                    method(st) == d.capture_methods[-1]:
                blocks.append(list(stmts[begin + 1:i]))
                begin = None
            if isinstance(st, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call) and mod.resolve(
                        dotted_name(it.context_expr.func) or "")
                    in d.capture_contexts for it in st.items):
                blocks.append(st.body)
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            for field_name in ("body", "orelse", "finalbody"):
                inner = getattr(st, field_name, None)
                if isinstance(inner, list):
                    scan(inner)
            for h in getattr(st, "handlers", []):
                scan(h.body)

    scan(getattr(fn.node, "body", []))
    return blocks


def call_targets(graph: CallGraph, mod: ModuleInfo, fn: FunctionInfo,
                 call: ast.Call) -> Tuple[List[FunctionInfo], int]:
    """The functions a call may run (a class's ``__init__`` for a
    constructor) and how many leading parameters the call binds itself
    (1 for ``self`` of a bound method or a constructor)."""
    raw = dotted_name(call.func)
    if raw is None:
        return [], 0
    hit = _resolve_local(mod, fn, raw) or \
        graph.by_dotted.get(mod.resolve(raw))
    if hit is None:
        hit = mod.functions.get(f"{raw}.__init__") or \
            graph.by_dotted.get(f"{mod.resolve(raw)}.__init__")
    if hit is None:
        return [], 0
    bound = hit.params[:1] in (("self",), ("cls",)) and (
        "." in raw or hit.qualname.endswith(".__init__"))
    return [hit], int(bound)


def _argument(call: ast.Call, tgt: FunctionInfo, skip: int,
              pname: str) -> Optional[ast.expr]:
    """The expression a call passes for ``tgt``'s parameter ``pname``."""
    for kw in call.keywords:
        if kw.arg == pname:
            return kw.value
    params = list(tgt.posonly_params[skip:])
    if pname not in params:
        return None
    i = params.index(pname)
    for j, a in enumerate(call.args):
        if isinstance(a, ast.Starred):
            return None
        if j == i:
            return a
    return None


def _capture_roots(graph: CallGraph) -> List[FunctionInfo]:
    """Functions that run inside a capture: called in a capture region,
    or passed where a function captures its parameter (to a fixpoint:
    a function that passes its own parameter to a capturer captures it
    too).  Fills ``graph.capturers``."""
    roots: List[FunctionInfo] = []
    fns = [(graph.modules[f.module], f) for f in graph.functions.values()]
    for mod, fn in fns:
        # `self.attr = param` in this function: `self.attr(...)` calls it
        attrs: Dict[str, str] = {}
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in fn.params:
                for t in node.targets:
                    name = dotted_name(t)
                    if name and name.startswith("self."):
                        attrs[name] = node.value.id
        for block in _capture_blocks(mod, fn):
            for st in block:
                for node in ast.walk(st):
                    if not isinstance(node, ast.Call):
                        continue
                    raw = dotted_name(node.func)
                    if raw in fn.params or raw in attrs:
                        graph.capturers.setdefault(fn.key, set()).add(
                            attrs.get(raw, raw))
                    else:
                        roots += call_targets(graph, mod, fn, node)[0]
    changed = True
    while changed:
        changed = False
        for mod, fn in fns:
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                tgts, skip = call_targets(graph, mod, fn, node)
                for tgt in tgts:
                    for pname in graph.capturers.get(tgt.key, ()):
                        arg = _argument(node, tgt, skip, pname)
                        name = dotted_name(arg) if arg is not None else None
                        if name in fn.params and name not in \
                                graph.capturers.get(fn.key, set()):
                            graph.capturers.setdefault(fn.key, set()).add(
                                name)
                            changed = True
    for mod, fn in fns:
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            tgts, skip = call_targets(graph, mod, fn, node)
            for tgt in tgts:
                for pname in graph.capturers.get(tgt.key, ()):
                    arg = _argument(node, tgt, skip, pname)
                    name = dotted_name(arg) if arg is not None else None
                    if name is not None and name not in fn.params:
                        hit = _resolve_local(mod, fn, name) or \
                            graph.by_dotted.get(mod.resolve(name))
                        if hit is not None:
                            roots.append(hit)
    return roots


def build_graph(paths: Sequence[str],
                roots: Sequence[str] = ("src",),
                dialect: Dialect = TORCH) -> CallGraph:
    """Parse every .py file under ``paths`` and mark in-trace functions."""
    graph = CallGraph()
    for path in _iter_py_files(paths):
        mod = parse_module(path, roots, dialect)
        if mod is None:
            continue
        graph.modules[mod.modname] = mod
        for info in mod.functions.values():
            graph.functions[info.key] = info
            graph.by_dotted[f"{mod.modname}.{info.qualname}"] = info
    _resolve_calls(graph)

    trace_roots: List[FunctionInfo] = []
    for mod in graph.modules.values():
        _TraceRootMarker(mod, trace_roots).visit(mod.tree)
        # static_argnames attach to the function a maker wraps
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and is_program_expr(node, mod):
                static = _static_argnames_of(node)
                if not static:
                    continue
                target = None
                if node.args:
                    target = dotted_name(node.args[0])
                cname = dotted_name(node.func)
                if target is None and cname is not None and \
                        mod.resolve(cname) in dialect.partial_names and \
                        len(node.args) >= 2:
                    target = dotted_name(node.args[1])
                if target is not None and target in mod.functions:
                    mod.functions[target].static_params |= static

    if dialect.capture_contexts or dialect.capture_methods:
        trace_roots += _capture_roots(graph)

    # BFS the call graph from the trace roots
    queue = list(trace_roots)
    seen: Set[str] = set()
    while queue:
        fn = queue.pop()
        if fn.key in seen:
            continue
        seen.add(fn.key)
        fn.in_trace = True
        for callee_key in fn.calls:
            callee = graph.functions.get(callee_key)
            if callee is not None and callee.key not in seen:
                queue.append(callee)
        # nested defs of an in-trace function trace with it
        for other in graph.modules[fn.module].functions.values():
            if other.parent == fn.qualname and other.key not in seen:
                queue.append(other)
    return graph


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if not d.startswith(".")
                               and d != "__pycache__"]
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        out.append(os.path.join(dirpath, fname))
    return sorted(set(out))
