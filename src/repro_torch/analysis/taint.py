"""Interprocedural taint-flow analysis for the client→server boundary.

The paper's privacy contract is a *dataflow* property: a client's raw
inputs may leave the device only after channel selection (→ SELECTED
coordinates), Gaussian noising under the RDP accountant (→ DP-NOISED),
and wire encoding.  This module implements the abstract interpretation
that checks it, on top of ``astgraph``'s pure-``ast`` call graph —
nothing is imported or executed.  It is the engine of
``repro.analysis.taint``: given that module's policy and wrapper names,
it finds what the reference finds (``tests/test_torch_privlint.py``).

Abstract domain
---------------
Every value carries a :class:`Taint`:

* ``tier`` — sensitivity lattice ``RAW(3) > LOCAL(2) > SELECTED(1) >
  PUBLIC(0)``.  RAW is client examples/labels; LOCAL is anything
  derived from per-client training (params, grads, dense deltas,
  per-client losses); SELECTED is the channel-masked coordinate set the
  protocol is allowed to reveal; PUBLIC is config, shapes, and
  cohort-level aggregates.
* ``noised`` — the Gaussian mechanism has been applied (a *must* flag:
  joining a noised path with an un-noised one clears it).
* ``encoded`` / ``revealed`` — the value is (derived from) a wire
  payload / already-revealed coordinates (*may* flags).
* ``keyish`` — randomness that feeds the noise (feeds the key-hygiene
  rule): in the port a ``torch.Generator``, its seed and state, and
  whatever is drawn on one (a call given ``generator=`` a keyish value
  joins it into its result: the normals the noiser takes).

Function summaries are structural: a function returning
``(masked, masks, metrics)`` keeps three per-element taints, so a LOCAL
metrics leg does not poison the SELECTED payload legs travelling in the
same tuple.  Unequal-arity joins (``collect=True`` returning an extra
element) align prefixes.

Interprocedural propagation is a context-insensitive forward fixpoint:
call-site argument taints join into callee parameter taints, callee
summaries flow back to call sites.  Calls through wrappers
(:class:`Calls`: ``functools.partial``, ``torch.func.vmap``,
``torch.utils.checkpoint.checkpoint(f, *args)``, an
``autograd.Function``'s ``apply``) are unwrapped; attribute calls
(``eng.scbf_round(...)``) resolve through a repo-wide *method-name
index* when the receiver class is unknown.  Closures see their
enclosing function's environment.  Object attribute state (``self.x =
...``) is deliberately not tracked, and class constructors are opaque
(PUBLIC) — sources therefore have to be declared on the *functions*
that produce sensitive values, which is what :class:`Policy` does.

The rule checks themselves (PL001–PL006) run in a recording pass after
the fixpoint converges; ``repro_torch.analysis.privrules`` declares the
policy tables and rule catalogue.
"""
from __future__ import annotations

import ast
import functools
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.analysis import astgraph
from repro_torch.analysis.report import Finding

# --- sensitivity tiers -------------------------------------------------

PUBLIC, SELECTED, LOCAL, RAW = 0, 1, 2, 3
TIER_NAMES = {PUBLIC: "PUBLIC", SELECTED: "SELECTED",
              LOCAL: "LOCAL", RAW: "RAW"}

MAX_FIXPOINT_ITERS = 24
_MAX_METHOD_TARGETS = 8

# attribute reads that are structural (shape-like), never data
STRUCTURAL_ATTRS = {"shape", "ndim", "dtype", "size", "nbytes",
                    "itemsize", "sharding", "device", "devices", "name",
                    "is_cuda", "layout"}

# builtins that reveal structure/cardinality, not content — `len(gens)`
# must not make a slot count keyish
_STRUCTURAL_CALLS = {"len", "range", "isinstance", "issubclass",
                     "hasattr", "callable", "type", "id"}

# container mutators: obj.append(x) joins x into obj
_MUTATORS = {"append", "extend", "add", "insert", "update", "setdefault"}


@dataclass(frozen=True)
class Calls:
    """The call wrappers the engines see through."""

    # ``wrapper(f, ...)(args)`` calls f on args (vmap, partial)
    curried: Tuple[str, ...]
    # ``wrapper(f, *args)`` calls f on args (activation checkpointing)
    applying: Tuple[str, ...] = ()
    # ``scan(body, init, xs)``
    scans: Tuple[str, ...] = ()
    # ``Fn.apply(*args)`` calls ``Fn.forward(ctx, *args)``
    function_apply: bool = False


TORCH_CALLS = Calls(
    curried=("torch.func.vmap", "torch.vmap", "vmap", "functools.partial",
             "partial", "torch.func.grad", "torch.func.grad_and_value",
             "torch.cuda.make_graphed_callables"),
    applying=("torch.utils.checkpoint.checkpoint", "checkpoint"),
    function_apply=True)

# what the port's messages call the noise's randomness
TORCH_WORDS = {
    "key": "noise draw",
    "fresh": "draw each release from its own generator or stream",
    "derive": "seed distinct generators or draw per slot",
    "filler": "draw distinct normals for filler slots",
}


@dataclass(frozen=True)
class Taint:
    tier: int = PUBLIC
    noised: bool = False
    encoded: bool = False
    revealed: bool = False
    keyish: bool = False
    why: str = ""
    # function keys this value may reference — how calls through
    # variables (`step = partial(f, ...); step(x)`) and program tables
    # stay resolvable
    fnref: Tuple[str, ...] = ()


BOTTOM = Taint()

# an abstract value: a single Taint or a tuple of abstract values
Value = Union[Taint, tuple]


def _may(a: Taint, b: Taint, attr: str) -> bool:
    return bool(getattr(a, attr) or getattr(b, attr))


def _must(a: Taint, b: Taint, attr: str) -> bool:
    # PUBLIC operands are neutral: mixing a noised delta with a shape
    # scalar must not clear the noised flag.
    if a.tier == PUBLIC:
        return bool(getattr(b, attr))
    if b.tier == PUBLIC:
        return bool(getattr(a, attr))
    return bool(getattr(a, attr) and getattr(b, attr))


def _join_flat(a: Taint, b: Taint) -> Taint:
    hi = a if a.tier >= b.tier else b
    fnref = a.fnref if not b.fnref else (
        b.fnref if not a.fnref else
        tuple(sorted(set(a.fnref) | set(b.fnref))))
    return Taint(tier=max(a.tier, b.tier),
                 noised=_must(a, b, "noised"),
                 encoded=_may(a, b, "encoded"),
                 revealed=_may(a, b, "revealed"),
                 keyish=_may(a, b, "keyish"),
                 why=hi.why or a.why or b.why,
                 fnref=fnref)


def collapse(v: Value) -> Taint:
    """Fold a structured value to one flat Taint."""
    if isinstance(v, Taint):
        return v
    out = BOTTOM
    for el in v:
        out = _join_flat(out, collapse(el))
    return out


def join(a: Value, b: Value) -> Value:
    """Structural join; unequal-arity tuples align by prefix.

    Prefix alignment is what keeps the ``collect=True`` convention
    precise: a function returning ``(masked, masks)`` on one path and
    ``(masked, masks, metrics)`` on the other joins element-wise on the
    shared prefix and keeps the metrics leg separate, instead of
    flattening the whole summary to one (poisoned) taint.
    """
    if isinstance(a, tuple) and isinstance(b, tuple):
        n = min(len(a), len(b))
        head = tuple(join(x, y) for x, y in zip(a[:n], b[:n]))
        tail = a[n:] if len(a) > len(b) else b[n:]
        return head + tail
    if isinstance(a, tuple) or isinstance(b, tuple):
        if isinstance(b, tuple):
            a, b = b, a
        # tuple vs scalar: join the scalar into every element
        return tuple(join(x, b) for x in a)
    return _join_flat(a, b)


def values_equal(a: Value, b: Value) -> bool:
    if isinstance(a, Taint) and isinstance(b, Taint):
        return a == b
    if isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b):
        return all(values_equal(x, y) for x, y in zip(a, b))
    return False


def _map_taint(v: Value, fn) -> Value:
    if isinstance(v, Taint):
        return fn(v)
    return tuple(_map_taint(el, fn) for el in v)


# --- policy ------------------------------------------------------------

@dataclass
class Policy:
    """Declared sources, sanitizers, and sinks (dotted-suffix patterns).

    Every pattern matches a call's raw *or* import-resolved dotted name
    on whole-component suffixes, so ``"wire.encode"`` matches
    ``repro_torch.comm.wire.encode`` but not ``Transformer.encode``.
    """

    # sources
    raw_sources: Tuple[str, ...] = ()       # calls yielding raw examples
    raw_attrs: Tuple[str, ...] = ()         # attribute names (x_train, ...)
    local_sources: Tuple[str, ...] = ()     # per-client training/deltas

    # sanitizer chain
    selectors: Tuple[str, ...] = ()         # channel selection → SELECTED
    noisers: Tuple[str, ...] = ()           # gaussian mechanism → noised
    encoders: Tuple[str, ...] = ()          # wire encode (also the sink)
    decoders: Tuple[str, ...] = ()
    aggregators: Tuple[str, ...] = ()       # cohort-level reductions
    metric_fns: Tuple[str, ...] = ()        # scalar eval metrics → PUBLIC

    # accounting (PL004)
    accountant_calls: Tuple[str, ...] = ()
    ledger_name_fragment: str = "releases"

    # telemetry/checkpoint sinks (PL006)
    telemetry_sinks: Tuple[str, ...] = ()

    # key hygiene (PL003)
    key_makers: Tuple[str, ...] = ()        # Generator/manual_seed/state
    key_replicators: Tuple[str, ...] = ()   # expand/tile/repeat

    # post-noise mask widening (PL005)
    wideners: Tuple[str, ...] = ()

    clean_calls: Tuple[str, ...] = ()       # shape-only constructors

    # the noiser's randomness argument: this keyword, else the 2nd
    # positional
    noise_arg: str = "noise"
    # calls that re-seed a generator: a loop-invariant seed inside a loop
    # repeats the noise (PL003)
    reseeders: Tuple[str, ...] = ()
    # draws whose result is noise material (keyish): the normals the
    # noiser takes; a keyword in ``key_kwargs`` (``generator=``) hands
    # a generator to a call without making its other results keyish
    noise_draws: Tuple[str, ...] = ()
    key_kwargs: Tuple[str, ...] = ()
    # collectives whose result is their inputs from every rank (written
    # into buffers the engine does not track): the join of the inputs
    carriers: Tuple[str, ...] = ()
    calls: Calls = TORCH_CALLS
    words: Dict[str, str] = field(default_factory=lambda: dict(TORCH_WORDS))
    # call-site precision: a small helper's result is evaluated on the
    # call's own arguments (not on the join of every caller's), a
    # ``*t`` argument of a known tuple spreads over the parameters, and
    # ``t[:2]`` of a known tuple keeps its elements
    call_sites: bool = True


def forward_of(graph: astgraph.CallGraph, calls: Calls,
               mod: astgraph.ModuleInfo, fn: astgraph.FunctionInfo,
               raw: Optional[str]) -> List[astgraph.FunctionInfo]:
    """``Fn.forward`` for ``Fn.apply``, resolved locally or by import."""
    if not (calls.function_apply and raw and raw.endswith(".apply")):
        return []
    base = raw[:-len(".apply")] + ".forward"
    hit = astgraph._resolve_local(mod, fn, base) or \
        graph.by_dotted.get(mod.resolve(base))
    return [hit] if hit is not None else []


# call-site evaluation of small helpers (``Policy.call_sites``)
_MAX_INLINE_NODES = 160
_MAX_INLINE_DEPTH = 2


_SIZES: Dict[int, Tuple[ast.AST, int]] = {}


def _size(node: ast.AST) -> int:
    """The number of ast nodes under ``node`` (cached by identity)."""
    hit = _SIZES.get(id(node))
    if hit is None or hit[0] is not node:
        hit = _SIZES[id(node)] = (node, sum(1 for _ in ast.walk(node)))
    return hit[1]


def _const_slice(sl: ast.AST) -> Optional[slice]:
    """``slice(a, b)`` for a ``t[a:b]`` of int constants (or omitted)."""
    if not isinstance(sl, ast.Slice) or sl.step is not None:
        return None
    bounds = []
    for b in (sl.lower, sl.upper):
        if b is None:
            bounds.append(None)
        elif isinstance(b, ast.Constant) and isinstance(b.value, int):
            bounds.append(b.value)
        else:
            return None
    return slice(*bounds)


def _bind_args(tgt: astgraph.FunctionInfo, raw: Optional[str],
               pos: list, kwargs: dict, join_fn=None, collapse_fn=None,
               bottom=None) -> dict:
    """Parameter → value for one call (``_propagate_args``'s binding,
    into a fresh environment), in the lattice of ``join_fn`` (the taint
    one by default)."""
    join_fn, collapse_fn = join_fn or join, collapse_fn or collapse
    bottom = BOTTOM if bottom is None else bottom
    env: dict = {}

    def put(pname: str, val) -> None:
        env[pname] = join_fn(env[pname], val) if pname in env else val

    params = list(tgt.params)
    if params and params[0] in ("self", "cls") and raw and "." in raw:
        params = params[1:]
    for pname, val in zip(params, pos):
        put(pname, val)
    star = collapse_fn(tuple(pos)) if len(pos) > len(params) else None
    for k, val in kwargs.items():
        if k is None:
            for pname in params:
                put(pname, collapse_fn(val))
        elif k in params:
            put(k, val)
    if star is not None and star != bottom:
        for pname in params:
            put(pname, star)
    return env


@functools.lru_cache(maxsize=1 << 16)
def name_matches(patterns: Sequence[str], raw: Optional[str],
                 resolved: Optional[str]) -> bool:
    for cand in (resolved, raw):
        if not cand:
            continue
        for pat in patterns:
            if cand == pat or cand.endswith("." + pat):
                return True
    return False


# --- analysis ----------------------------------------------------------

@dataclass
class _FnFacts:
    """Syntactic per-function facts gathered before the fixpoint."""
    is_accountant: bool = False
    ledger_updates: List[ast.AugAssign] = field(default_factory=list)
    has_encode: bool = False


class TaintAnalysis:
    """Fixpoint + recording passes over one :class:`astgraph.CallGraph`."""

    def __init__(self, graph: astgraph.CallGraph, policy: Policy,
                 rules: Optional[Set[str]] = None):
        self.graph = graph
        self.policy = policy
        self.rules = rules          # None = all
        self.param_env: Dict[str, Dict[str, Value]] = {}
        self.summaries: Dict[str, Value] = {}
        self.fn_envs: Dict[str, Dict[str, Value]] = {}
        self.callers: Dict[str, Set[str]] = {}
        self.callees: Dict[str, Set[str]] = {}
        self.facts: Dict[str, _FnFacts] = {}
        self.findings: List[Finding] = []
        self._changed = False
        # (callee, depth, arguments) -> result, within one pass
        self.call_site_memo: Dict[tuple, Value] = {}
        self._method_index: Dict[str, List[astgraph.FunctionInfo]] = {}
        self._build_indexes()

    # -- setup ---------------------------------------------------------

    def _build_indexes(self) -> None:
        pol = self.policy
        for mod in self.graph.modules.values():
            for cls, methods in mod.classes.items():
                for m in methods:
                    info = mod.functions.get(f"{cls}.{m}")
                    if info is not None:
                        self._method_index.setdefault(m, []).append(info)
        for key, fn in self.graph.functions.items():
            facts = _FnFacts()
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call):
                    raw = astgraph.dotted_name(node.func)
                    mod = self.graph.modules.get(fn.module)
                    resolved = mod.resolve(raw) if (mod and raw) else None
                    if name_matches(pol.accountant_calls, raw, resolved):
                        facts.is_accountant = True
                    if name_matches(pol.encoders, raw, resolved):
                        facts.has_encode = True
                elif isinstance(node, ast.AugAssign):
                    tgt = node.target
                    base = tgt.value if isinstance(tgt, ast.Subscript) \
                        else tgt
                    name = astgraph.dotted_name(base)
                    if name and pol.ledger_name_fragment in \
                            name.rsplit(".", 1)[-1]:
                        facts.is_accountant = True
                        facts.ledger_updates.append(node)
            self.facts[key] = facts

    # -- fixpoint ------------------------------------------------------

    def run(self) -> List[Finding]:
        order = list(self.graph.functions.values())
        for _ in range(MAX_FIXPOINT_ITERS):
            self._changed = False
            self.call_site_memo = {}
            for fn in order:
                self._analyze(fn, record=False)
            if not self._changed:
                break
        self.call_site_memo = {}
        for fn in order:
            self._analyze(fn, record=True)
        self._check_double_counts(order)
        if self.rules is not None:
            self.findings = [f for f in self.findings
                             if f.rule in self.rules]
        return self.findings

    def _check_double_counts(self,
                             order: List[astgraph.FunctionInfo]) -> None:
        """PL004 (double-count): two ledger updates for the same counter
        inside one emission-path function spends the budget twice."""
        for fn in order:
            facts = self.facts.get(fn.key)
            if facts is None or len(facts.ledger_updates) < 2:
                continue
            if not self.reaches_encode(fn.key):
                continue
            by_name: Dict[str, List[ast.AugAssign]] = {}
            for node in facts.ledger_updates:
                tgt = node.target
                base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                name = astgraph.dotted_name(base) or "?"
                by_name.setdefault(name, []).append(node)
            mod = self.graph.modules[fn.module]
            for name, nodes in by_name.items():
                if len(nodes) >= 2:
                    self.emit("PL004", mod, nodes[1],
                              f"release ledger '{name}' is updated "
                              f"{len(nodes)} times on one emission path "
                              "— the (ε, δ) budget for this payload is "
                              "double-counted", fn)

    def _analyze(self, fn: astgraph.FunctionInfo, record: bool) -> None:
        mod = self.graph.modules[fn.module]
        ev = _Evaluator(self, mod, fn, record=record)
        summary = ev.run()
        old = self.summaries.get(fn.key, BOTTOM)
        new = join(old, summary)
        if not values_equal(old, new):
            self.summaries[fn.key] = new
            self._changed = True
        self.fn_envs[fn.key] = ev.env

    # -- interprocedural plumbing --------------------------------------

    def seed_param(self, fn_key: str, pname: str, val: Value) -> None:
        env = self.param_env.setdefault(fn_key, {})
        old = env.get(pname, BOTTOM)
        new = join(old, val)
        if not values_equal(old, new):
            env[pname] = new
            self._changed = True

    def add_edge(self, caller: str, callee: str) -> None:
        self.callers.setdefault(callee, set()).add(caller)
        self.callees.setdefault(caller, set()).add(callee)

    def resolve_call(self, mod: astgraph.ModuleInfo,
                     fn: astgraph.FunctionInfo, raw: Optional[str]
                     ) -> List[astgraph.FunctionInfo]:
        """All plausible targets of a call named ``raw`` inside ``fn``."""
        if not raw:
            return []
        local = astgraph._resolve_local(mod, fn, raw)
        if local is not None:
            return [local]
        resolved = mod.resolve(raw)
        hit = self.graph.by_dotted.get(resolved)
        if hit is not None:
            return [hit]
        # attribute call on an unknown receiver: match by method name
        if "." in raw:
            meth = raw.rsplit(".", 1)[-1]
            targets = self._method_index.get(meth, [])
            if 0 < len(targets) <= _MAX_METHOD_TARGETS:
                return list(targets)
        return []

    def accountant_dominates(self, fn_key: str) -> bool:
        """Is ``fn_key`` or any transitive caller an accountant?

        ANY-ancestor semantics — an under-approximation (a second,
        unaccounted caller chain would be missed), but line-precise
        dominator analysis over an ast-level graph is not worth the
        false positives.
        """
        seen: Set[str] = set()
        queue = [fn_key]
        while queue:
            k = queue.pop()
            if k in seen:
                continue
            seen.add(k)
            facts = self.facts.get(k)
            if facts is not None and facts.is_accountant:
                return True
            queue.extend(self.callers.get(k, ()))
        return False

    def reaches_encode(self, fn_key: str) -> bool:
        seen: Set[str] = set()
        queue = [fn_key]
        while queue:
            k = queue.pop()
            if k in seen:
                continue
            seen.add(k)
            facts = self.facts.get(k)
            if facts is not None and facts.has_encode:
                return True
            queue.extend(self.callees.get(k, ()))
        return False

    def emit(self, rule: str, mod: astgraph.ModuleInfo, node: ast.AST,
             message: str, fn: astgraph.FunctionInfo) -> None:
        self.findings.append(Finding(
            rule=rule, path=mod.path, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), message=message,
            symbol=fn.qualname))


class _Evaluator:
    """One statement-ordered abstract interpretation of one function.

    Flow handling is deliberately simple: branches execute sequentially
    (if-body then else-body over one environment), loops once — the
    surrounding fixpoint supplies the convergence.  Within a function
    the *order* of statements is preserved, which is what the
    flow-sensitive rules (noise-after-encode, widen-after-noise, key
    reuse) need.
    """

    def __init__(self, owner: TaintAnalysis, mod: astgraph.ModuleInfo,
                 fn: astgraph.FunctionInfo, record: bool,
                 seeded: Optional[Dict[str, Value]] = None,
                 depth: int = 0):
        self.a = owner
        self.seeded = seeded
        self.depth = depth
        self.pol = owner.policy
        self.w = owner.policy.words
        self.mod = mod
        self.fn = fn
        self.record = record
        self.env: Dict[str, Value] = {}
        self.returns: List[Value] = []
        # flow-sensitive state for the ordering rules
        self.noise_lines: List[int] = []        # gaussian calls seen
        self.mask_names: Set[str] = set()       # reveal/keep masks
        self.key_uses: Dict[str, int] = {}      # key name -> first line
        self.loop_stack: List[Set[str]] = []    # names assigned per loop

    # -- entry ---------------------------------------------------------

    def run(self) -> Value:
        # closures: nested defs see the enclosing function's environment
        if self.fn.parent is not None:
            parent = self.mod.functions.get(self.fn.parent)
            if parent is not None:
                self.env.update(self.a.fn_envs.get(parent.key, {}))
        seeded = self.seeded if self.seeded is not None else \
            self.a.param_env.get(self.fn.key, {})
        for pname in self.fn.params:        # includes keyword-only
            self.env[pname] = seeded.get(pname, BOTTOM)
        body = getattr(self.fn.node, "body", [])
        self.exec_block(body)
        if not self.returns:
            return BOTTOM
        out: Value = self.returns[0]
        for r in self.returns[1:]:
            out = join(out, r)
        return out

    # -- statements ----------------------------------------------------

    def exec_block(self, stmts: Sequence[ast.stmt]) -> None:
        for st in stmts:
            self.exec_stmt(st)

    def exec_stmt(self, st: ast.stmt) -> None:
        if isinstance(st, ast.Assign):
            v = self.eval(st.value)
            for t in st.targets:
                self.bind(t, v, st)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self.bind(st.target, self.eval(st.value), st)
        elif isinstance(st, ast.AugAssign):
            v = join(self.eval(st.target), self.eval(st.value))
            self.bind(st.target, v, st, augmented=True)
        elif isinstance(st, ast.Return):
            self.returns.append(self.eval(st.value)
                                if st.value is not None else BOTTOM)
        elif isinstance(st, ast.Expr):
            self.eval(st.value)
        elif isinstance(st, ast.If):
            self.eval(st.test)
            self.exec_block(st.body)
            self.exec_block(st.orelse)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            elem = self.eval(st.iter)
            self.bind(st.target, elem, st)
            self.loop_stack.append(self._assigned_names(st))
            self.exec_block(st.body)
            self.loop_stack.pop()
            self.exec_block(st.orelse)
        elif isinstance(st, ast.While):
            self.eval(st.test)
            self.loop_stack.append(self._assigned_names(st))
            self.exec_block(st.body)
            self.loop_stack.pop()
            self.exec_block(st.orelse)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                v = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, v, st)
            self.exec_block(st.body)
        elif isinstance(st, ast.Try):
            self.exec_block(st.body)
            for h in st.handlers:
                self.exec_block(h.body)
            self.exec_block(st.orelse)
            self.exec_block(st.finalbody)
        elif isinstance(st, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self.eval(child)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            pass        # analyzed as their own FunctionInfo
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
        # Import/Global/Pass/Break/Continue: nothing to do

    @staticmethod
    def _assigned_names(loop: ast.stmt) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(loop):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, (ast.Store,)):
                names.add(node.id)
        return names

    def bind(self, target: ast.expr, v: Value, st: ast.stmt,
             augmented: bool = False) -> None:
        if isinstance(target, ast.Name):
            if augmented:
                v = join(self.env.get(target.id, BOTTOM), v)
            else:
                self.key_uses.pop(target.id, None)  # fresh key binding
            self.env[target.id] = v
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            if isinstance(v, tuple):
                star = next((i for i, e in enumerate(elts)
                             if isinstance(e, ast.Starred)), None)
                if star is None and len(elts) <= len(v):
                    for e, el in zip(elts, v):
                        self.bind(e, el, st)
                    return
                for e in elts:
                    self.bind(e.value if isinstance(e, ast.Starred) else e,
                              collapse(v), st)
            else:
                for e in elts:
                    self.bind(e.value if isinstance(e, ast.Starred) else e,
                              v, st)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, v, st)
        elif isinstance(target, ast.Subscript):
            self._check_key_element_store(target, st)
            base = target.value
            if isinstance(base, ast.Name):
                self.env[base.id] = join(self.env.get(base.id, BOTTOM), v)
        elif isinstance(target, ast.Attribute):
            pass        # object state is not tracked

    def _check_key_element_store(self, target: ast.Subscript,
                                 st: ast.stmt) -> None:
        """PL003(c): ``out[r, p:] = k[0]`` — one key element fanned out
        over a slot range duplicates its noise stream across slots."""
        if not self.record or not isinstance(st, (ast.Assign,
                                                  ast.AnnAssign)):
            return
        has_slice = any(isinstance(n, ast.Slice)
                        for n in ast.walk(target.slice))
        if not has_slice:
            return
        value = st.value
        if isinstance(value, ast.Subscript) and not any(
                isinstance(n, ast.Slice) for n in ast.walk(value.slice)):
            if collapse(self.eval(value.value)).keyish:
                self._emit("PL003", st,
                           f"a single {self.w['key']} element is stored "
                           "across a slot range — every padded slot shares "
                           f"one noise stream ({self.w['filler']})")

    # -- expressions ---------------------------------------------------

    def eval(self, node: ast.expr) -> Value:
        if isinstance(node, ast.Constant):
            return BOTTOM
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            # a bare name that resolves to a known function is a
            # function reference (feeds call-through-variable support)
            tgts = self.a.resolve_call(self.mod, self.fn, node.id)
            if tgts:
                return Taint(PUBLIC,
                             fnref=tuple(sorted(t.key for t in tgts)))
            return BOTTOM
        if isinstance(node, ast.Tuple):
            return tuple(self.eval(e) for e in node.elts)
        if isinstance(node, ast.List):
            out = BOTTOM
            for e in node.elts:
                out = join(out, collapse(self.eval(e)))
            return out
        if isinstance(node, (ast.Set, ast.Dict)):
            out = BOTTOM
            vals = node.values if isinstance(node, ast.Dict) else node.elts
            for e in vals:
                if e is not None:
                    out = join(out, collapse(self.eval(e)))
            return out
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, ast.BinOp):
            v = join(collapse(self.eval(node.left)),
                     collapse(self.eval(node.right)))
            if isinstance(node.op, ast.BitOr):
                self._check_widening(node, [node.left, node.right])
            return v
        if isinstance(node, ast.BoolOp):
            out = BOTTOM
            for e in node.values:
                out = join(out, collapse(self.eval(e)))
            return out
        if isinstance(node, ast.Compare):
            out = collapse(self.eval(node.left))
            for e in node.comparators:
                out = join(out, collapse(self.eval(e)))
            return out
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            return join(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            self.eval(node.slice)
            if isinstance(base, tuple) and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, int) and \
                    -len(base) <= node.slice.value < len(base):
                return base[node.slice.value]
            part = _const_slice(node.slice) if self.pol.call_sites else None
            if isinstance(base, tuple) and part is not None:
                return base[part]
            return collapse(base)
        if isinstance(node, ast.Attribute):
            if node.attr in STRUCTURAL_ATTRS:
                return BOTTOM
            base = collapse(self.eval(node.value))
            if node.attr in self.pol.raw_attrs:
                return join(base, Taint(RAW,
                                        why=f"client data .{node.attr}"))
            return base
        if isinstance(node, ast.Call):
            return self.eval_call(node)
        if isinstance(node, (ast.ListComp, ast.SetComp,
                             ast.GeneratorExp, ast.DictComp)):
            for gen in node.generators:
                self.bind(gen.target, self.eval(gen.iter), ast.Pass())
                for cond in gen.ifs:
                    self.eval(cond)
            if isinstance(node, ast.DictComp):
                self.eval(node.key)
                return collapse(self.eval(node.value))
            return collapse(self.eval(node.elt))
        if isinstance(node, ast.Lambda):
            return BOTTOM
        if isinstance(node, ast.JoinedStr):
            out = BOTTOM
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    out = join(out, collapse(self.eval(v.value)))
            return out
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self.eval(node.value)
        if isinstance(node, ast.Yield):
            return self.eval(node.value) if node.value else BOTTOM
        if isinstance(node, ast.NamedExpr):
            v = self.eval(node.value)
            self.bind(node.target, v, ast.Pass())
            return v
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self.eval(part)
            return BOTTOM
        return BOTTOM

    # -- calls ---------------------------------------------------------

    def _unwrap_callee(self, node: ast.Call
                       ) -> Tuple[Optional[str], List[ast.expr]]:
        """Peel ``vmap(f, ...)(args)`` / ``partial(f, ...)(args)`` /
        ``checkpoint(f, *args)`` down to (dotted name of f, the argument
        list f receives)."""
        func = node.func
        args = list(node.args)
        wrappers = self.pol.calls.curried
        depth = 0
        while isinstance(func, ast.Call) and depth < 4:
            inner_name = astgraph.dotted_name(func.func)
            resolved = self.mod.resolve(inner_name) if inner_name else None
            if not name_matches(wrappers, inner_name, resolved):
                break
            cand = None
            for a in func.args:
                nm = astgraph.dotted_name(a)
                if nm and not name_matches(wrappers, nm,
                                           self.mod.resolve(nm)):
                    cand = nm
                    break
            if cand is None:
                break
            return cand, args
        name = astgraph.dotted_name(func)
        if name and args and name_matches(self.pol.calls.applying, name,
                                          self.mod.resolve(name)):
            inner = astgraph.dotted_name(args[0])
            if inner:
                return inner, args[1:]
        return name, args

    def eval_call(self, node: ast.Call) -> Value:
        pol = self.pol
        raw, pos_exprs = self._unwrap_callee(node)
        resolved = self.mod.resolve(raw) if raw else None

        pos: List[Value] = []
        for a in pos_exprs:
            v = self.eval(a)
            if self.pol.call_sites and isinstance(a, ast.Starred) and \
                    isinstance(v, tuple):
                pos.extend(v)           # f(*t): t's elements in order
            else:
                pos.append(v)
        kwargs: Dict[Optional[str], Value] = {
            kw.arg: self.eval(kw.value) for kw in node.keywords}

        def flat_join() -> Taint:
            out = BOTTOM
            for v in pos + [v for k, v in kwargs.items()
                            if k not in pol.key_kwargs]:
                out = join(out, collapse(v))
            return out

        # container mutators: obj.append(x) joins x into obj (only for
        # known locals — np.append etc. must fall through untouched)
        if raw and "." in raw:
            base, meth = raw.rsplit(".", 1)
            if meth in _MUTATORS and "." not in base and \
                    base in self.env:
                self.env[base] = join(self.env.get(base, BOTTOM),
                                      flat_join())
                return BOTTOM

        # wrapper *construction* (`partial(partial, ...)(f)`): the value
        # is a reference to f, not a call of it
        if raw is None and isinstance(node.func, ast.Call):
            inner = astgraph.dotted_name(node.func.func)
            inner_res = self.mod.resolve(inner) if inner else None
            if inner and name_matches(pol.calls.curried, inner, inner_res) \
                    and len(node.args) == 1:
                tname = astgraph.dotted_name(node.args[0])
                tgts = self.a.resolve_call(self.mod, self.fn, tname) \
                    if tname else []
                if tgts:
                    return Taint(PUBLIC, fnref=tuple(
                        sorted(t.key for t in tgts)))

        # ---- special forms ------------------------------------------
        if raw in _STRUCTURAL_CALLS:
            return BOTTOM
        if raw in ("enumerate",) and pos:
            return (BOTTOM, pos[0])
        if raw in ("zip",):
            return tuple(pos)
        if name_matches(pol.calls.scans, raw, resolved):
            return self._eval_scan(node, pos)

        # ---- policy: producers --------------------------------------
        if name_matches(pol.reseeders, raw, resolved):
            self._check_reseed(node)
        if name_matches(pol.key_makers, raw, resolved):
            return Taint(PUBLIC, keyish=True, why=self.w["key"])
        if name_matches(pol.noise_draws, raw, resolved):
            return Taint(PUBLIC, keyish=True,
                         why=f"normals drawn by {raw}()")
        if name_matches(pol.clean_calls, raw, resolved):
            return BOTTOM
        if name_matches(pol.raw_sources, raw, resolved):
            return Taint(RAW, why=f"raw client data from {raw}()")
        if name_matches(pol.local_sources, raw, resolved):
            return Taint(LOCAL,
                         why=f"per-client result of {raw}()")
        if name_matches(pol.metric_fns, raw, resolved):
            return Taint(PUBLIC, why="scalar eval metric")
        if name_matches(pol.aggregators, raw, resolved):
            return Taint(min(SELECTED, flat_join().tier),
                         why="cohort-level aggregate")
        if name_matches(pol.selectors, raw, resolved):
            return Taint(SELECTED,
                         why=f"channel-selected by {raw}()")
        if name_matches(pol.carriers, raw, resolved):
            return flat_join()

        # ---- policy: sanitizers with ordering checks ----------------
        if name_matches(pol.noisers, raw, resolved):
            return self._eval_noiser(node, pos, kwargs)
        if name_matches(pol.decoders, raw, resolved):
            return Taint(SELECTED, revealed=True, why="decoded payload")
        if name_matches(pol.encoders, raw, resolved):
            return self._eval_encoder(node, pos)
        if name_matches(pol.accountant_calls, raw, resolved):
            return Taint(PUBLIC, why="privacy accounting")

        # ---- sinks (orthogonal: check, then fall through) -----------
        if name_matches(pol.telemetry_sinks, raw, resolved):
            self._check_telemetry(node, raw, pos_exprs, pos, kwargs)

        # ---- mask widening / key replication ------------------------
        if name_matches(pol.wideners, raw, resolved):
            self._check_widening(node, pos_exprs)
        if name_matches(pol.key_replicators, raw, resolved) and (
                pos or self._receiver(raw) is not None):
            # a method's receiver counts when it is randomness alone
            # (PUBLIC): data that has met a generator is not the noise
            src = collapse(self._receiver(raw) or BOTTOM)
            if ((src.keyish and src.tier == PUBLIC) or
                    (pos and collapse(pos[0]).keyish)) and self.record:
                self._emit("PL003", node,
                           f"{raw}() replicates {self.w['key']} material "
                           "— replicated slots draw identical noise "
                           f"({self.w['derive']} instead)")

        # ---- interprocedural ----------------------------------------
        targets = forward_of(self.a.graph, pol.calls, self.mod, self.fn, raw)
        if targets:
            pos = [BOTTOM] + pos            # Fn.forward's ctx
        else:
            targets = self.a.resolve_call(self.mod, self.fn, raw)
        if not targets:
            # call through a variable holding a function reference
            fval: Optional[Value] = None
            if raw is not None and "." not in raw:
                fval = self.env.get(raw)
            elif raw is None:
                fval = self.eval(node.func)
            if fval is not None:
                targets = [self.a.graph.functions[k]
                           for k in collapse(fval).fnref
                           if k in self.a.graph.functions]
        if targets:
            out: Optional[Value] = None
            for tgt in targets:
                self._propagate_args(tgt, raw, pos, kwargs)
                self.a.add_edge(self.fn.key, tgt.key)
                s = self._at_call_site(tgt, raw, pos, kwargs)
                if s is None:
                    s = self.a.summaries.get(tgt.key, BOTTOM)
                out = s if out is None else join(out, s)
            return out if out is not None else BOTTOM

        # unknown constructor-like call: opaque object, not a join of
        # its arguments (object attribute state is untracked, so taint
        # through containers must come from declared sources instead)
        if raw and raw.rsplit(".", 1)[-1][:1].isupper():
            return BOTTOM

        # unresolved *method* calls keep their receiver's taint —
        # `delta.float()` / `losses.pop()` must not launder; module
        # receivers (`torch.sum`) evaluate to BOTTOM so they only join
        # their arguments
        recv: Value = BOTTOM
        if isinstance(node.func, ast.Attribute):
            if raw is None:
                recv = fval if fval is not None else BOTTOM
            else:
                base = raw.rsplit(".", 1)[0]
                if "." not in base and base in self.env:
                    recv = self.env[base]

        # default: taint-preserving combinator (torch.sum, float, ...)
        out = join(flat_join(), collapse(recv))
        return replace(out, fnref=()) if out.fnref else out

    def _at_call_site(self, tgt: astgraph.FunctionInfo, raw: Optional[str],
                      pos: List[Value], kwargs: Dict[Optional[str], Value]
                      ) -> Optional[Value]:
        """``tgt``'s result on this call's own arguments, when it is a
        small helper (``call_sites``): a helper shared by a FedAvg path
        (dense trained weights) and an SCBF one (selected deltas) must
        not hand the one's taint to the other.  None: use the summary."""
        if not self.pol.call_sites or self.depth >= _MAX_INLINE_DEPTH or \
                tgt.key == self.fn.key or \
                _size(tgt.node) > _MAX_INLINE_NODES:
            return None
        env = _bind_args(tgt, raw, pos, kwargs)
        key = (tgt.key, self.depth, tuple(sorted(env.items())))
        if key not in self.a.call_site_memo:
            mod = self.a.graph.modules[tgt.module]
            self.a.call_site_memo[key] = _Evaluator(
                self.a, mod, tgt, record=False, seeded=env,
                depth=self.depth + 1).run()
        return self.a.call_site_memo[key]

    def _eval_scan(self, node: ast.Call, pos: List[Value]) -> Value:
        body_name = astgraph.dotted_name(node.args[0]) if node.args \
            else None
        init = pos[1] if len(pos) > 1 else BOTTOM
        xs = pos[2] if len(pos) > 2 else BOTTOM
        targets = self.a.resolve_call(self.mod, self.fn, body_name)
        summary: Value = BOTTOM
        for tgt in targets:
            params = [p for p in tgt.params if p not in ("self",)]
            if params:
                self.a.seed_param(tgt.key, params[0], init)
            if len(params) > 1:
                self.a.seed_param(tgt.key, params[1], xs)
            self.a.add_edge(self.fn.key, tgt.key)
            summary = join(summary, self.a.summaries.get(tgt.key, BOTTOM))
        if isinstance(summary, tuple) and len(summary) == 2:
            return (join(summary[0], init), summary[1])
        return join(summary, init)

    def _propagate_args(self, tgt: astgraph.FunctionInfo,
                        raw: Optional[str], pos: List[Value],
                        kwargs: Dict[Optional[str], Value]) -> None:
        params = list(tgt.params)           # includes keyword-only
        if params and params[0] in ("self", "cls") and raw and \
                "." in raw:
            params = params[1:]             # bound-method call
        for pname, val in zip(params, pos):
            self.a.seed_param(tgt.key, pname, val)
        star = collapse(tuple(pos)) if len(pos) > len(params) else None
        for k, val in kwargs.items():
            if k is None:           # **kwargs splat
                for pname in params:
                    self.a.seed_param(tgt.key, pname, collapse(val))
            elif k in params:
                self.a.seed_param(tgt.key, k, val)
        if star is not None and star != BOTTOM:
            for pname in params:
                self.a.seed_param(tgt.key, pname, star)

    # -- rule bodies ---------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if self.record:
            self.a.emit(rule, self.mod, node, message, self.fn)

    def _receiver(self, raw: Optional[str]) -> Optional[Value]:
        """A method call's receiver, when it is a local (``z.expand``)."""
        if raw and "." in raw:
            base = raw.rsplit(".", 1)[0]
            if "." not in base:
                return self.env.get(base)
        return None

    def _check_reseed(self, node: ast.Call) -> None:
        """PL003 (torch): a generator re-seeded inside a loop with a seed
        the loop does not change restarts the same stream each time."""
        if not self.record or not self.loop_stack:
            return
        names = {n.id for a in list(node.args) +
                 [kw.value for kw in node.keywords]
                 for n in ast.walk(a) if isinstance(n, ast.Name)}
        if not (names & set().union(*self.loop_stack)):
            self._emit("PL003", node,
                       "generator re-seeded with a loop-invariant "
                       "seed — every iteration (client/round) draws the "
                       "SAME noise, which voids the accountant's "
                       "independence assumption")

    def _eval_noiser(self, node: ast.Call, pos: List[Value],
                     kwargs: Dict[Optional[str], Value]) -> Value:
        arg = collapse(pos[0]) if pos else BOTTOM
        if self.record and (arg.encoded or arg.revealed):
            self._emit("PL002", node,
                       "DP noise applied to already-encoded/revealed "
                       "coordinates — noise must come BEFORE "
                       "wire.encode, or the un-noised values have "
                       "already left the privacy boundary")
        # PL003 (a)/(b): key argument hygiene on the noise path
        key_expr = None
        for kw in node.keywords:
            if kw.arg == self.pol.noise_arg:
                key_expr = kw.value
        if key_expr is None and len(node.args) > 1:
            key_expr = node.args[1]
        if self.record and key_expr is not None:
            names = {n.id for n in ast.walk(key_expr)
                     if isinstance(n, ast.Name)}
            if self.loop_stack and names and not (
                    names & set().union(*self.loop_stack)):
                self._emit("PL003", node,
                           f"{self.w['key']} is loop-invariant at this "
                           "noise call — every iteration (client/round) "
                           "draws the SAME noise, which voids the "
                           "accountant's independence assumption")
            if isinstance(key_expr, ast.Name):
                prev = self.key_uses.get(key_expr.id)
                if prev is not None:
                    self._emit("PL003", node,
                               f"{self.w['key']} '{key_expr.id}' already "
                               f"consumed by a noise call on line "
                               f"{prev} — {self.w['fresh']}")
                else:
                    self.key_uses[key_expr.id] = node.lineno
        # PL005 setup: remember the reveal-mask names at this call
        masks_expr = next((kw.value for kw in node.keywords
                           if kw.arg == "masks"), None)
        if masks_expr is not None:
            self.mask_names |= {n.id for n in ast.walk(masks_expr)
                                if isinstance(n, ast.Name)}
        self.noise_lines.append(node.lineno)
        out = replace(arg, noised=True, keyish=False,
                      why=arg.why or "DP-noised")
        return out

    def _eval_encoder(self, node: ast.Call, pos: List[Value]) -> Value:
        arg = collapse(pos[0]) if pos else BOTTOM
        if self.record and arg.tier >= LOCAL and not arg.noised:
            what = arg.why or TIER_NAMES[arg.tier] + " value"
            self._emit("PL001", node,
                       f"{what} reaches the wire without the full "
                       "sanitizer chain (channel selection + "
                       "gaussian_mechanism) — the server would see "
                       "un-noised per-client data")
        if self.record and arg.noised and not \
                self.a.accountant_dominates(self.fn.key):
            self._emit("PL004", node,
                       "DP-noised payload is emitted but no caller "
                       "updates the privacy accountant (epsilon_for / "
                       "release ledger) — the spent ε/δ budget is "
                       "untracked for this release")
        # the argument's coordinates are now revealed: a later noise
        # call on the same variable is PL002
        for a in node.args:
            for n in ast.walk(a):
                if isinstance(n, ast.Name) and n.id in self.env:
                    self.env[n.id] = _map_taint(
                        self.env[n.id],
                        lambda t: replace(t, revealed=True))
        return Taint(PUBLIC, encoded=True, why="wire payload")

    def _check_widening(self, node: ast.AST,
                        arg_exprs: Sequence[ast.expr]) -> None:
        if not self.record or not self.noise_lines:
            return
        if getattr(node, "lineno", 0) <= self.noise_lines[0]:
            return
        names: Set[str] = set()
        for a in arg_exprs:
            for n in ast.walk(a):
                if isinstance(n, ast.Name):
                    names.add(n.id)
        hit = names & self.mask_names
        if hit:
            self._emit("PL005", node,
                       f"reveal/keep mask '{sorted(hit)[0]}' is widened "
                       "AFTER the DP noise was calibrated to it — the "
                       "extra coordinates ship with no noise budget "
                       "(post-DP coordinate leakage)")

    def _check_telemetry(self, node: ast.Call, raw: Optional[str],
                         pos_exprs: Sequence[ast.expr], pos: List[Value],
                         kwargs: Dict[Optional[str], Value]) -> None:
        if not self.record:
            return
        labelled = [(astgraph.dotted_name(e) or f"arg{i}", v)
                    for i, (e, v) in enumerate(zip(pos_exprs, pos))]
        labelled += [(k or "**kwargs", v) for k, v in kwargs.items()]
        for label, v in labelled:
            t = collapse(v)
            if t.tier >= LOCAL and not t.noised:
                self._emit("PL006", node,
                           f"telemetry/checkpoint sink {raw}() receives "
                           f"pre-DP per-client value '{label}' "
                           f"({t.why or TIER_NAMES[t.tier]}) — logs and "
                           "events.jsonl are outside the privacy "
                           "boundary")
                return
