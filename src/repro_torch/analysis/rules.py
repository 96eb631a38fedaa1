"""The tracelint rules for the port, TL001..TL006.

Each rule is the torch counterpart of the reference's rule of the same
code (``repro.analysis.rules``) and, like it, errs toward *under*-
reporting: heuristics fire on the specific shapes that cost a captured
CUDA graph its point, and every rule honors per-line suppression
comments plus the committed baseline.  "In trace" is
capture-reachability (``astgraph``): code a ``torch.cuda.CUDAGraph``
records, where a host sync raises during capture and a Python branch
on a tensor is decided once, at capture time, for every replay.
Tensor-ness is approximated by the repo's own calling convention,
which the analyzer states explicitly:

* tensors arrive as **positional, unannotated** parameters;
* static configuration arrives **keyword-only** or annotated with a
  Python scalar type (``int``/``bool``/``str``/``float``).

TL001  a CUDA graph (``torch.cuda.CUDAGraph``, a capturing program such
       as ``fed/graphs.RoundProgram``, ``make_graphed_callables``) or a
       kernel library (``ctypes.CDLL``, ``kernels/build.build_all``)
       built in a function that runs every call, without a cache: every
       call re-captures or re-loads.
TL002  a host sync (``.item()``, ``.tolist()``, ``.cpu()``,
       ``.numpy()``, ``np.asarray``, ``float()``/``int()``/``bool()`` of
       a tensor, ``torch.cuda.synchronize``) in capture-reachable code;
       on the host, ``float()`` of a tensor parameter or of a program's
       output.
TL003  a Python ``if``/``while`` on a tensor in capture-reachable code.
TL004  a captured program fed, inside a host loop, slices whose extent
       varies with the loop: a graph replays fixed shapes, so each new
       extent is a new capture (or a refused replay).
TL005  a kernel launcher's ``argtypes`` in ``kernels/build.SIGNATURES``
       against the ``extern "C"`` prototype in ``kernels/csrc/<lib>.cu``,
       by count and by type: a mismatch passes garbage to the kernel on
       the card, which no CPU test sees.
TL006  device→host copies in a host loop: ``torch.cuda.synchronize()``,
       and ``.cpu()``/``.item()``/``.tolist()``/``.numpy()``/
       ``np.asarray`` of a program's output, once an iteration.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.astgraph import (CallGraph, FunctionInfo,
                                           ModuleInfo, SCALAR_ANNOTATIONS,
                                           call_targets, dotted_name,
                                           is_program_expr)
from repro_torch.analysis.report import Finding

_HOST_SYNC_CASTS = {"float", "int", "bool"}
# tensor methods that copy to the host (and wait for the device)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_MATERIALIZE = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_SYNC_CALLS = {"torch.cuda.synchronize"}
_STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "type", "range",
                 "max", "min", "abs", "dist.get_backend", "dist.get_rank",
                 "dist.get_world_size", "dist.is_initialized",
                 "torch.distributed.get_backend",
                 "torch.distributed.get_rank",
                 "torch.distributed.get_world_size"}
# tensor methods that READ values: `x.sum()` of a tensor is a tensor a
# Python branch would have to read, even though the attribute access
# `x.sum` alone is structural
_VALUE_METHODS = {"sum", "max", "min", "mean", "prod", "any", "all",
                  "item", "tolist", "amax", "amin", "norm", "count_nonzero",
                  "equal", "allclose"}
# calls that build (load) a kernel library
_LIBRARY_MAKERS = {"CDLL", "LoadLibrary", "build_all"}


def _enclosing(mod: ModuleInfo, graph: CallGraph,
               node: ast.AST) -> Optional[FunctionInfo]:
    return graph.function_at(mod, node)


def _finding(rule: str, mod: ModuleInfo, node: ast.AST, message: str,
             fn: Optional[FunctionInfo]) -> Finding:
    return Finding(rule=rule, path=mod.path, line=node.lineno,
                   col=getattr(node, "col_offset", 0), message=message,
                   symbol=fn.qualname if fn else "<module>")


def _tracer_params(fn: FunctionInfo) -> Set[str]:
    """Parameters this repo's convention marks as possibly tensors:
    positional, unannotated-or-tensor-annotated, non-static.  An
    annotation that names no tensor (``torch.device``, ``Sequence[int]``,
    a process group) marks a parameter that is not one."""
    out = set()
    for p in fn.posonly_params:
        if p in ("self", "cls") or p in fn.static_params:
            continue
        ann = fn.annotations.get(p)
        if ann in SCALAR_ANNOTATIONS or (ann is not None and
                                         "Tensor" not in ann):
            continue
        out.add(p)
    return out


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_static_expr(node: ast.AST, tracer_names: Set[str],
                    static_calls: Set[str] = frozenset()) -> bool:
    """Conservatively: does this expression avoid touching a tensor
    except through static accessors?

    Static accessors — uses that read *structure*, never array values:
    ``.shape``/``.ndim``/``.dtype``-style attributes, ``len()`` and
    friends, ``is None`` tests, ``"key" in pytree`` membership on a
    string constant, any other attribute access (pytrees and config
    objects travel as positional args, and branching on a *field* of
    one is structural), and calls to same-module shape-pure functions
    (``static_calls``).
    """
    tracer_names, iterated = _iterated(node, tracer_names)
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in tracer_names and \
                isinstance(sub.ctx, ast.Load) and id(sub) not in iterated:
            if not _under_static_accessor(node, sub, static_calls):
                return False
    return True


def _iterated(node: ast.AST, tracer_names: Set[str]
              ) -> Tuple[Set[str], Set[int]]:
    """Comprehensions in ``node`` that iterate tensor names (``for g in
    gs``, ``for o, l in zip(out, leaves)``): iterating a list of tensors
    is structural, so those reads are exempt and the loop targets join
    the tensor names checked.  Returns (names, exempt Name node ids)."""
    names, exempt = set(tracer_names), set()
    for comp in ast.walk(node):
        if not isinstance(comp, (ast.ListComp, ast.SetComp, ast.DictComp,
                                 ast.GeneratorExp)):
            continue
        for gen in comp.generators:
            it = gen.iter
            srcs = [it] if isinstance(it, ast.Name) else list(it.args) \
                if isinstance(it, ast.Call) and dotted_name(it.func) in (
                    "zip", "enumerate", "reversed", "sorted") else []
            hit = [a for a in srcs
                   if isinstance(a, ast.Name) and a.id in names]
            if not hit:
                continue
            exempt |= {id(a) for a in hit}
            how = dotted_name(it.func) if isinstance(it, ast.Call) else None
            target = gen.target
            if how == "enumerate" and isinstance(target, ast.Tuple) and \
                    target.elts:
                target = ast.Tuple(elts=target.elts[1:], ctx=ast.Store())
            if how != "sorted":        # sorted(d): a dict's keys
                names |= _names_in(target)
    return names, exempt


def _under_static_accessor(root: ast.AST, target: ast.Name,
                           static_calls: Set[str] = frozenset()) -> bool:
    """Is ``target`` only reached via a static accessor inside root?"""
    class _V(ast.NodeVisitor):
        def __init__(self):
            self.ok = True

        def visit_Attribute(self, node):
            # any attribute read is structural: .shape/.dtype on arrays,
            # config fields on dataclasses, dict methods on pytrees.
            # (Reading array *values* needs a call or a subscript, both
            # of which stay flagged.)
            return

        def visit_Call(self, node):
            cname = dotted_name(node.func)
            if cname in _STATIC_CALLS or cname in static_calls:
                return
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _VALUE_METHODS:
                # `x.max()` reads values — look through the attribute
                # at its base (and the args) instead of exempting it
                self.visit(node.func.value)
                for a in node.args:
                    self.visit(a)
                return
            self.generic_visit(node)

        def visit_Compare(self, node):
            # `x is None` / `x is not None` is a static (python-level)
            # test even on a tensor-typed name
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops) and any(
                    isinstance(c, ast.Constant) and c.value is None
                    for c in node.comparators):
                return
            # `"key" in p`: membership of a string constant is a
            # structural test on a dict pytree, not a value read
            if all(isinstance(op, (ast.In, ast.NotIn))
                   for op in node.ops) and \
                    isinstance(node.left, ast.Constant) and \
                    isinstance(node.left.value, str):
                return
            self.generic_visit(node)

        def visit_Name(self, node):
            if node is target:
                self.ok = False

    v = _V()
    v.visit(root)
    return v.ok


def _shape_only_functions(mod: ModuleInfo) -> Set[str]:
    """Same-module functions that read their arguments only through
    static accessors (shapes, lens, structure) — calling one on a
    tensor is a static computation, e.g. ``num_channels(scores)``."""
    out: Set[str] = set()
    for fn in mod.functions.values():
        params = {p for p in fn.posonly_params if p not in ("self", "cls")}
        if not params:
            continue
        derived = set(params)
        iter_names: Set[int] = set()
        for node in ast.walk(fn.node):
            if isinstance(node, ast.For) and \
                    isinstance(node.iter, ast.Name) and \
                    node.iter.id in derived:
                derived |= _names_in(node.target)
                # iterating a pytree/array unrolls over structure —
                # shape-static, so the iter read itself is fine
                iter_names.add(id(node.iter))
        derived, exempt = _iterated(fn.node, derived)
        iter_names |= exempt
        ok = True
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Name) and id(node) not in iter_names \
                    and node.id in derived and \
                    isinstance(node.ctx, ast.Load):
                if not _under_static_accessor(fn.node, node):
                    ok = False
                    break
        if ok:
            out.add(fn.qualname)
    return out


# ---------------------------------------------------------------------------
# TL001 — a CUDA graph or kernel library rebuilt per call
# ---------------------------------------------------------------------------

def _builds(mod: ModuleInfo, graph: CallGraph, fn: Optional[FunctionInfo],
            call: ast.Call) -> Optional[str]:
    """What ``call`` builds — a program (the dialect's makers, or a
    constructor that captures its argument) or a kernel library — as a
    name for the message, else None."""
    callee = dotted_name(call.func)
    if is_program_expr(call, mod):
        return callee or "a program maker"
    if callee is None:
        return None
    if callee.rsplit(".", 1)[-1] in _LIBRARY_MAKERS:
        return callee
    if fn is not None:
        for tgt in call_targets(graph, mod, fn, call)[0]:
            if tgt.qualname.endswith(".__init__") and \
                    tgt.key in graph.capturers:
                return callee
    return None


def check_tl001(mod: ModuleInfo, graph: CallGraph) -> Iterable[Finding]:
    """TL001: a CUDA graph or a kernel library built per call.

    The counterpart of the reference's per-call ``jax.jit``: a graph
    captured (or a library loaded) inside a function that runs every
    round re-captures (re-loads) every round, and a capture holds its
    memory pool.  Module-level builds, ``__init__`` (the object is the
    cache), ``lru_cache``-decorated factories, and cache-guarded
    attribute or dict-slot assignments are exempt.
    """
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = _enclosing(mod, graph, node)
        if fn is None:
            continue                          # module level: the fix
        what = _builds(mod, graph, fn, node)
        if what is None:
            continue
        if fn.name == "__init__" or fn.cached_factory:
            continue
        if any(graph.functions[f"{mod.modname}:{q}"].cached_factory
               for q in _ancestor_qualnames(fn)
               if f"{mod.modname}:{q}" in graph.functions):
            continue
        if _assignment_is_cached(mod, node):
            continue
        yield _finding(
            "TL001", mod, node,
            f"{what}(...) built inside '{fn.qualname}': a CUDA graph or "
            "kernel library rebuilt on every call re-captures (re-loads) "
            "on every call — build it once: at module level, in an "
            "@functools.lru_cache factory, or in a cache-guarded "
            "attribute or dict slot", fn)


def _assignment_is_cached(mod: ModuleInfo, call: ast.Call) -> bool:
    """Cached-attribute building: ``self._programs[key] =
    RoundProgram(...)`` (or an attribute) guarded by an ``if ... is
    None`` / ``not in`` / ``hasattr`` style cache check is the accepted
    lazy-build idiom."""
    parents = _parent_chain(mod.tree, call)
    assigned_cache_slot = False
    for node in parents:
        if isinstance(node, ast.Assign):
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in node.targets):
                assigned_cache_slot = True
        if isinstance(node, ast.If) and assigned_cache_slot:
            test_src = ast.dump(node.test)
            if ("Is()" in test_src or "IsNot()" in test_src
                    or "NotIn()" in test_src or "In()" in test_src
                    or "hasattr" in test_src):
                return True
    return False


def _parent_chain(tree: ast.Module, target: ast.AST) -> List[ast.AST]:
    """Ancestors of ``target``, innermost first."""
    chain: List[ast.AST] = []

    def walk(node, ancestors):
        if node is target:
            chain.extend(reversed(ancestors))
            return True
        for child in ast.iter_child_nodes(node):
            if walk(child, ancestors + [node]):
                return True
        return False

    walk(tree, [])
    return chain


def _ancestor_qualnames(fn: FunctionInfo) -> List[str]:
    out = []
    qual = fn.parent
    while qual:
        out.append(qual)
        qual = qual.rpartition(".")[0] or None
    return out


# ---------------------------------------------------------------------------
# TL002 — host syncs in capture-reachable code
# ---------------------------------------------------------------------------

def check_tl002(mod: ModuleInfo, graph: CallGraph) -> Iterable[Finding]:
    """TL002: a device→host sync in capture-reachable code.

    Under ``torch.cuda.graph`` a sync raises (the capture is
    invalidated); in the eager body the same code blocks dispatch on
    the device every round.  On the host tier, ``float()`` of an
    unannotated positional parameter (or of a program's output) in a
    torch module is the same sync wearing a loop.
    """
    static_calls = _shape_only_functions(mod)
    for mod_fn in mod.functions.values():
        if not mod_fn.in_trace:
            continue
        tracers = _tracer_params(mod_fn)
        for node in _own_body_walk(mod, mod_fn):
            if not isinstance(node, ast.Call):
                continue
            cname = dotted_name(node.func)
            resolved = mod.resolve(cname) if cname else None
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS and not node.args and \
                    not node.keywords:
                yield _finding(
                    "TL002", mod, node,
                    f".{node.func.attr}() inside capture-reachable code "
                    "copies to the host and waits for the device (and "
                    "fails under capture) — keep the value on the device "
                    "or move the read to a chunk boundary", mod_fn)
            elif resolved in _NP_MATERIALIZE or resolved in _SYNC_CALLS:
                yield _finding(
                    "TL002", mod, node,
                    f"{cname}(...) inside capture-reachable code syncs "
                    "with the device — use torch on the device, or hoist "
                    "the transfer out of the captured region", mod_fn)
            elif cname in _HOST_SYNC_CASTS and len(node.args) == 1 and \
                    not _is_static_expr(node.args[0], tracers,
                                        static_calls):
                yield _finding(
                    "TL002", mod, node,
                    f"{cname}() on a tensor inside '{mod_fn.qualname}' "
                    "syncs device→host (the lr-on-the-device bug) — keep "
                    "it a 0-d tensor, or pass a Python scalar", mod_fn)

    # host tier: float(<unannotated positional param>) or
    # float(<program call>) in a torch-importing module
    if not mod.imports_backend:
        return
    for mod_fn in mod.functions.values():
        if mod_fn.in_trace:
            continue
        tracers = _tracer_params(mod_fn)
        for node in _own_body_walk(mod, mod_fn):
            if not (isinstance(node, ast.Call)
                    and dotted_name(node.func) in _HOST_SYNC_CASTS
                    and len(node.args) == 1):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Name) and arg.id in tracers:
                yield _finding(
                    "TL002", mod, node,
                    f"{dotted_name(node.func)}() on parameter "
                    f"'{arg.id}' may hide a device→host sync if a "
                    "caller passes a CUDA tensor — annotate the "
                    "parameter as a Python scalar or sync explicitly "
                    "at the call site", mod_fn)
            elif isinstance(arg, ast.Call):
                callee = dotted_name(arg.func)
                if callee is not None and \
                        _is_program(mod, graph, mod_fn, callee):
                    yield _finding(
                        "TL002", mod, node,
                        f"{dotted_name(node.func)}() directly on the "
                        f"program call '{callee}(...)' syncs device→host "
                        "per call — batch the reads or keep the value "
                        "on the device", mod_fn)


def _program_locals(mod: ModuleInfo, graph: CallGraph,
                    fn: FunctionInfo) -> Set[str]:
    """Names ``fn`` binds to a program: assigned from an expression that
    builds one or calls a function that captures its argument
    (``prog = body if … else self._program(…)``)."""
    out: Set[str] = set()
    for node in ast.walk(fn.node):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Call) and (
                    is_program_expr(sub, mod) or any(
                        t.key in graph.capturers for t in
                        call_targets(graph, mod, fn, sub)[0])):
                out.add(node.targets[0].id)
                break
    return out


def _is_program(mod: ModuleInfo, graph: CallGraph,
                fn: Optional[FunctionInfo], name: str) -> bool:
    """Does ``name`` refer to a program?  Exact names only — a module's
    program symbols (imported ones through the defining module), or
    ``fn``'s program locals."""
    if name in mod.program_symbols:
        return True
    if fn is not None and name in _program_locals(mod, graph, fn):
        return True
    if name in mod.functions:
        return False
    resolved = mod.resolve(name)
    owner_name, _, sym = resolved.rpartition(".")
    owner = graph.modules.get(owner_name)
    return owner is not None and sym in owner.program_symbols


def _own_body_walk(mod: ModuleInfo, fn: FunctionInfo) -> Iterable[ast.AST]:
    """Walk fn's body but NOT the bodies of nested function defs (each
    nested def is its own FunctionInfo and is visited separately)."""
    own_nested = [f.node for f in mod.functions.values()
                  if f.parent == fn.qualname]

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if child in own_nested:
                continue
            yield child
            yield from walk(child)

    yield from walk(fn.node)


# ---------------------------------------------------------------------------
# TL003 — Python branching on tensors in capture-reachable code
# ---------------------------------------------------------------------------

def check_tl003(mod: ModuleInfo, graph: CallGraph) -> Iterable[Finding]:
    """TL003: ``if``/``while`` on a tensor in capture-reachable code.

    A Python branch on a tensor reads it on the host: under capture the
    read raises, and where it does not (a value known at capture time)
    the branch taken is baked into every replay.  Use ``torch.where``,
    or pass the decision as a Python scalar.
    """
    static_calls = _shape_only_functions(mod)
    for mod_fn in mod.functions.values():
        if not mod_fn.in_trace:
            continue
        tracers = _tracer_params(mod_fn)
        if not tracers:
            continue
        for node in _own_body_walk(mod, mod_fn):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            if _is_static_expr(node.test, tracers, static_calls):
                continue
            kind = "if" if isinstance(node, ast.If) else "while"
            offenders = sorted(_names_in(node.test) & tracers)
            yield _finding(
                "TL003", mod, node,
                f"Python '{kind}' on tensor value(s) "
                f"{', '.join(offenders)} inside '{mod_fn.qualname}' — "
                "this reads the tensor on the host (fails under capture, "
                "or bakes one branch into every replay); use torch.where, "
                "or pass the decision as a keyword-only Python scalar",
                mod_fn)


# ---------------------------------------------------------------------------
# TL004 — loop-varying shapes fed to a captured program
# ---------------------------------------------------------------------------

def check_tl004(mod: ModuleInfo, graph: CallGraph) -> Iterable[Finding]:
    """TL004: program call sites fed per-iteration shapes.

    A captured graph replays the shapes it was captured with
    (``RoundProgram`` refuses any other): a program fed, inside a host
    loop, a slice whose extent varies per iteration needs a capture per
    extent.  Pad to a static bucket (``fed.cohort.bucket_size``) or
    hoist the slice.
    """
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        fn = _enclosing(mod, graph, node)
        if fn is not None and fn.in_trace:
            continue                        # captured loops unroll
        loop_vars = _loop_varying_names(node)
        shapey_locals = _loop_varying_sliced_locals(node, loop_vars)
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            callee = dotted_name(call.func)
            if callee is None or not _is_program(mod, graph, fn, callee):
                continue
            bad = _varying_shape_args(call, loop_vars, shapey_locals)
            if bad:
                yield _finding(
                    "TL004", mod, call,
                    f"captured program '{callee}' called with argument "
                    f"shape(s) that vary per iteration "
                    f"({', '.join(sorted(bad))}) — a graph replays the "
                    "shapes it captured, so each distinct extent needs a "
                    "new capture; pad to a static bucket "
                    "(fed.cohort.bucket_size) or hoist the slice", fn)


def _loop_varying_names(loop: ast.AST) -> Set[str]:
    """Loop targets plus names assigned inside the loop body."""
    out: Set[str] = set()
    if isinstance(loop, ast.For):
        out |= _names_in(loop.target)
    for node in ast.walk(loop):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                out |= _names_in(t)
        elif isinstance(node, ast.AugAssign):
            out |= _names_in(node.target)
    return out


def _slice_varies(sub: ast.Subscript, loop_vars: Set[str]) -> bool:
    sl = sub.slice
    if not isinstance(sl, ast.Slice):
        return False
    # canonical fixed-stride stream `x[i:i + B]` with loop-invariant B:
    # the OFFSET varies but the extent does not, so the program sees the
    # same shape every iteration (plus at most one clamped tail) — not
    # the re-capture shape, where the extent itself varies
    if isinstance(sl.lower, ast.Name) and sl.lower.id in loop_vars and \
            isinstance(sl.upper, ast.BinOp) and \
            isinstance(sl.upper.op, ast.Add) and \
            isinstance(sl.upper.left, ast.Name) and \
            sl.upper.left.id == sl.lower.id and \
            not (_names_in(sl.upper.right) & loop_vars) and \
            (sl.step is None or not (_names_in(sl.step) & loop_vars)):
        return False
    for bound in (sl.lower, sl.upper, sl.step):
        if bound is not None and (_names_in(bound) & loop_vars):
            return True
    return False


def _loop_varying_sliced_locals(loop: ast.AST,
                                loop_vars: Set[str]) -> Set[str]:
    """Locals assigned (in the loop body) from a loop-varying slice."""
    out: Set[str] = set()
    for node in ast.walk(loop):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Subscript) and \
                        _slice_varies(sub, loop_vars):
                    out.add(node.targets[0].id)
    return out


def _varying_shape_args(call: ast.Call, loop_vars: Set[str],
                        shapey_locals: Set[str]) -> Set[str]:
    bad: Set[str] = set()
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Subscript) and \
                    _slice_varies(sub, loop_vars):
                base = dotted_name(sub.value) or "<expr>"
                bad.add(f"{base}[...]")
            if isinstance(sub, ast.Name) and sub.id in shapey_locals:
                bad.add(sub.id)
    return bad


# ---------------------------------------------------------------------------
# TL005 — the ctypes launchers' signatures against the CUDA prototypes
# ---------------------------------------------------------------------------

_PROTO_RE = re.compile(
    r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)', re.S)

# a ctypes type → the C parameter kind it passes
_CTYPES = {"c_void_p": "pointer", "c_char_p": "pointer",
           "c_int": "int", "c_int32": "int", "c_uint": "int",
           "c_longlong": "long long", "c_int64": "long long",
           "c_ulonglong": "long long", "c_size_t": "long long",
           "c_float": "float", "c_double": "double"}


def _c_kind(decl: str) -> str:
    """The kind a C parameter declaration passes (``const long long*
    rows`` → pointer, ``int L`` → int)."""
    decl = decl.strip()
    if "*" in decl:
        return "pointer"
    words = [w for w in re.findall(r"\w+", decl)
             if w not in ("const", "unsigned", "signed", "volatile")]
    base = " ".join(words[:-1]) if len(words) > 1 else " ".join(words)
    return {"long long": "long long", "long": "long long",
            "size_t": "long long", "int64_t": "long long",
            "int": "int", "int32_t": "int", "float": "float",
            "double": "double", "void": "void"}.get(base, base)


def _prototypes(path: str) -> Dict[str, List[str]]:
    """``extern "C"`` functions of a CUDA source: name → parameter kinds."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    text = re.sub(r"//[^\n]*", "", text)
    out: Dict[str, List[str]] = {}
    for _ret, name, params in _PROTO_RE.findall(text):
        decls = [p for p in params.split(",") if p.strip()]
        if len(decls) == 1 and decls[0].strip() == "void":
            decls = []
        out[name] = [_c_kind(d) for d in decls]
    return out


def _ctypes_kind(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    name = dotted_name(node)
    if name is None:
        return None
    name = aliases.get(name, name)
    return _CTYPES.get(name.rsplit(".", 1)[-1])


def check_tl005(mod: ModuleInfo, graph: CallGraph) -> Iterable[Finding]:
    """TL005: a launcher's ``argtypes`` against its CUDA prototype.

    A module-level ``SIGNATURES = {lib: {launcher: ([argtypes], restype)}}``
    declares how ``ctypes`` calls each ``extern "C"`` launcher of
    ``csrc/<lib>.cu`` beside the module.  ctypes converts the Python
    arguments by ``argtypes`` alone: one argument short, or an int where
    the prototype takes a pointer, and the kernel reads garbage on the
    card, which no CPU test runs.  Checked by count and by kind
    (pointer, int, long long, float) against the source.
    """
    aliases: Dict[str, str] = {}
    table: Optional[ast.Dict] = None
    for st in mod.tree.body:
        if isinstance(st, ast.Assign) and len(st.targets) == 1 and \
                isinstance(st.targets[0], ast.Name):
            name = dotted_name(st.value)
            if name is not None:
                aliases[st.targets[0].id] = name
            if st.targets[0].id == "SIGNATURES" and \
                    isinstance(st.value, ast.Dict):
                table = st.value
    if table is None:
        return
    csrc = os.path.join(os.path.dirname(mod.path), "csrc")
    for lib_key, fns in zip(table.keys, table.values):
        if not (isinstance(lib_key, ast.Constant) and
                isinstance(fns, ast.Dict)):
            continue
        source = os.path.join(csrc, f"{lib_key.value}.cu")
        if not os.path.exists(source):
            yield _finding(
                "TL005", mod, lib_key,
                f"SIGNATURES names library '{lib_key.value}' but "
                f"csrc/{lib_key.value}.cu does not exist", None)
            continue
        protos = _prototypes(source)
        for fn_key, sig in zip(fns.keys, fns.values):
            if not (isinstance(fn_key, ast.Constant) and
                    isinstance(sig, ast.Tuple) and sig.elts and
                    isinstance(sig.elts[0], (ast.List, ast.Tuple))):
                continue
            name = fn_key.value
            if name not in protos:
                yield _finding(
                    "TL005", mod, fn_key,
                    f"launcher '{name}' has no extern \"C\" prototype in "
                    f"csrc/{lib_key.value}.cu", None)
                continue
            want = protos[name]
            got = [_ctypes_kind(a, aliases) for a in sig.elts[0].elts]
            if len(got) != len(want):
                yield _finding(
                    "TL005", mod, fn_key,
                    f"launcher '{name}' takes {len(want)} argument(s) in "
                    f"csrc/{lib_key.value}.cu but its argtypes give "
                    f"{len(got)} — ctypes passes the wrong arguments and "
                    "the kernel reads garbage on the card", None)
                continue
            for i, (g, w) in enumerate(zip(got, want)):
                if g is not None and g != w:
                    yield _finding(
                        "TL005", mod, fn_key,
                        f"launcher '{name}' argument {i} is {w} in "
                        f"csrc/{lib_key.value}.cu but {g} in its argtypes "
                        "— the kernel reads garbage on the card", None)
                    break


# ---------------------------------------------------------------------------
# TL006 — device transfers inside host loops
# ---------------------------------------------------------------------------

def check_tl006(mod: ModuleInfo, graph: CallGraph) -> Iterable[Finding]:
    """TL006: per-iteration device→host transfers in host loops.

    The fused round loop exists because per-round host crossings
    (``torch.cuda.synchronize``, ``.cpu()``/``.item()`` of a program's
    output) serialize dispatch against device completion.  Inside
    ``for``/``while`` bodies of host functions, each such call is one
    sync per iteration — batch them at chunk boundaries (the
    ``emit_fused_payloads`` pattern).  Comprehensions are exempt: a
    single post-loop gather is the recommended fix, not a finding.
    """
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        fn = _enclosing(mod, graph, node)
        if fn is not None and fn.in_trace:
            continue
        for call in _loop_body_calls(node):
            cname = dotted_name(call.func)
            resolved = mod.resolve(cname) if cname else None
            if resolved == "torch.cuda.synchronize":
                yield _finding(
                    "TL006", mod, call,
                    "torch.cuda.synchronize() inside a host loop "
                    "serializes dispatch per iteration — synchronize once "
                    "after the loop (or only around timed sections)", fn)
            elif resolved in _NP_MATERIALIZE and call.args and \
                    _program_call(mod, graph, fn, call.args[0]):
                yield _finding(
                    "TL006", mod, call,
                    f"{cname}() of the program call "
                    f"'{_program_call(mod, graph, fn, call.args[0])}(...)' "
                    "inside a host loop transfers per iteration — keep "
                    "results on the device and gather once after the "
                    "loop", fn)
            elif isinstance(call.func, ast.Attribute) and \
                    call.func.attr in _SYNC_METHODS and \
                    _program_call(mod, graph, fn, call.func.value):
                yield _finding(
                    "TL006", mod, call,
                    f".{call.func.attr}() of the program call "
                    f"'{_program_call(mod, graph, fn, call.func.value)}"
                    "(...)' inside a host loop copies to the host per "
                    "iteration — keep results on the device and gather "
                    "once after the loop", fn)


def _program_call(mod: ModuleInfo, graph: CallGraph,
                  fn: Optional[FunctionInfo], node: ast.AST
                  ) -> Optional[str]:
    """The program's name if ``node`` calls one, else None."""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name is not None and _is_program(mod, graph, fn, name):
            return name
    return None


def _loop_body_calls(loop: ast.AST) -> Iterable[ast.Call]:
    """Calls in the loop body, skipping comprehensions and nested defs."""
    skip = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp,
            ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, skip):
                continue
            if isinstance(child, ast.Call):
                yield child
            yield from walk(child)

    yield from walk(loop)


ALL_RULES = {
    "TL001": check_tl001,
    "TL002": check_tl002,
    "TL003": check_tl003,
    "TL004": check_tl004,
    "TL005": check_tl005,
    "TL006": check_tl006,
}
