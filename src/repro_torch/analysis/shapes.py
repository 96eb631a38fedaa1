"""Abstract shape/dtype/padding-provenance interpretation (shapelint).

The repo's most recurring bug class is *padding discipline*: bucketed-P
cohort padding, fused ``(S, B)`` horizon plans, keep-masks, fault-admit
masks and, in the port, the fixed 8-slot chunks (``slots.slot_chunked``,
``fed/engine._train_slots``) all create arrays whose trailing slots are
dead and must be validity-masked in every reduction, denominator, and
aggregation.  This module checks that statically, on top of
``astgraph``'s pure-``ast`` call graph — nothing is imported or
executed.  It is the engine of ``repro.analysis.shapes``; given that
module's policy and wrapper names it finds what the reference finds
(``tests/test_torch_shapelint.py``), and it also reads torch's idiom:
``dim=`` and a positional dim as a reduction's axis, ``.to(dtype)``,
``.float()``, ``.int()``, ``.long()``, ``.bool()``, ``.double()`` as
casts, ``clamp``/``clamp_min`` as guards, ``torch.zeros(b, k)`` shapes.

Abstract domain
---------------
Every value carries a :class:`Shape`:

* ``rank`` / ``dims`` — symbolic shape: known rank with (optionally)
  named dims (``("K", "B")``), or unknown (``rank=None``).
* ``dtype`` / ``weak`` — canonical short dtype ("f32", "f64", "bool",
  "i32", …) plus the weak-type flag for Python scalars; feeds the
  promotion-drift rule (SL003).
* ``prov`` — padding provenance lattice ``NONE(0) < ZEROED(1) <
  PADDED(2)``.  PADDED means the leading slot axis carries *garbage*
  filler values; ZEROED means the filler slots are exact zeros (sums
  are safe, means/extrema are not).  Seeded at the bucket-padding
  producers (``_pad_slots``/``pad_rows``/``horizon_slot_plan``…),
  cleared by ``torch.where(valid, ·, 0)`` (→ ZEROED), mask
  multiplication (→ ZEROED), or slicing back to ``[:p_count]``
  (→ NONE).
* ``is_mask`` — boolean validity mask over slots; ``pad_count`` — a
  scalar that counts *all* slots including dead ones (``bucket_size``
  result, ``len(padded)``, ``padded.shape[0]``); ``masked_sum`` — a
  sum taken over a ZEROED axis (a safe numerator, but dividing it by a
  ``pad_count`` is exactly the SL002 bug); ``maskable`` — a quantity
  that can be zero (``Σmask``); ``guarded`` — a dominating positive
  guard (``torch.clamp_min(·, 1)``) has been applied.

Function summaries are structural (tuples keep per-element shapes) and
interprocedural propagation is the same context-insensitive
caller-arg→callee-param forward fixpoint as ``taint.py``, including
``vmap``/``partial``/``checkpoint`` unwrapping, scan body seeding,
method-name-index fallback, and call-through-variable ``fnref``
support.  ``vmap`` maps over the slot axis, so seeding *strips*
padding provenance from the per-slot view and re-attaches it to the
mapped outputs; ``scan`` runs over rounds (``S``), so its per-step
``xs`` slices *keep* their slot-axis provenance.

The rule checks (SL001–SL006) are emitted during a recording pass
after the fixpoint converges; ``repro_torch.analysis.shaperules`` declares
the policy tables and rule catalogue.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.analysis import astgraph
from repro_torch.analysis.report import Finding
from repro_torch.analysis.taint import (TORCH_CALLS, Calls, _MUTATORS,
                                        _MAX_INLINE_DEPTH, _MAX_INLINE_NODES,
                                        _STRUCTURAL_CALLS, _const_slice,
                                        _size, forward_of, name_matches)

# --- padding provenance lattice ----------------------------------------

NONE, ZEROED, PADDED = 0, 1, 2
PROV_NAMES = {NONE: "clean", ZEROED: "zero-filled", PADDED: "padded"}

MAX_FIXPOINT_ITERS = 24
_MAX_METHOD_TARGETS = 8

# reduction vocabulary, dispatched on the trailing dotted component
_SUM_FAMILY = {"sum", "nansum", "segment_sum", "logsumexp"}
_MEAN_FAMILY = {"mean", "nanmean", "average", "median", "quantile",
                "percentile", "std", "var"}
_EXTREME_FAMILY = {"max", "min", "amax", "amin", "argmax", "argmin",
                   "nanmax", "nanmin"}
_REDUCTIONS = _SUM_FAMILY | _MEAN_FAMILY | _EXTREME_FAMILY

# ops that produce nonfinite values when fed a zero/negative operand
_NONFINITE_OPS = {"log", "log2", "log10", "reciprocal", "sqrt"}

# positive-floor guards: torch.maximum(x, 1), torch.clip(x, 1e-6, ...),
# max(), torch.clamp(x, min=1), torch.clamp_min(x, 1)
_GUARD_CALLS = {"maximum", "fmax", "clip", "max", "clamp", "clamp_min"}
# the same as tensor methods (``x.clamp_min(1)``): a positive floor
_METHOD_GUARDS = {"clip", "clamp", "clamp_min"}

# torch's tensor-method casts: ``x.float()`` and friends
_METHOD_CASTS = {"float": "f32", "double": "f64", "half": "f16",
                 "bfloat16": "bf16", "int": "i32", "long": "i64",
                 "short": "i16", "bool": "bool"}

# what the port's messages name as the remedy
TORCH_SHAPE_WORDS = {
    "reach": "capture-reachable",
    "f64": "a float64 tensor runs the card's fp64 path and doubles "
           "memory, and its result's dtype drifts from the fp32 the "
           "captured program was built for",
    "cast": ".to(...)",
    "cast_int": ".to(torch.int32)",
    "where": "torch.where(valid, x, 0)",
    "guard_eps": "torch.clamp_min(x, eps)",
    "guard_one": "torch.clamp_min(x, 1)",
}

_CREATION_CALLS = {"zeros", "ones", "full", "empty", "zeros_like",
                   "ones_like", "full_like", "array", "asarray",
                   "arange", "linspace", "eye"}

_DTYPE_SHORT = {
    "float64": "f64", "double": "f64", "float_": "f64",
    "float32": "f32", "single": "f32",
    "float16": "f16", "bfloat16": "bf16",
    "int64": "i64", "int32": "i32", "int16": "i16", "int8": "i8",
    "uint32": "u32", "uint8": "u8",
    "bool_": "bool", "bool": "bool",
}

_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
              ast.Mod, ast.Pow, ast.MatMult)


@dataclass(frozen=True)
class Shape:
    rank: Optional[int] = None
    dims: Tuple[str, ...] = ()
    dtype: str = ""
    weak: bool = False
    prov: int = NONE
    is_mask: bool = False
    pad_count: bool = False
    masked_sum: bool = False
    maskable: bool = False
    guarded: bool = False
    why: str = ""
    fnref: Tuple[str, ...] = ()


BOTTOM = Shape()

# an abstract value: a single Shape or a tuple of abstract values
Value = Union[Shape, tuple]


def _join_flat(a: Shape, b: Shape) -> Shape:
    # unknown rank/dims are "no information", not a conflict: joining
    # with BOTTOM (e.g. the initial summary) must not erase known facts
    if a.rank is None or b.rank is None:
        rank = a.rank if b.rank is None else b.rank
    else:
        rank = a.rank if a.rank == b.rank else None
    if not a.dims or not b.dims:
        dims = a.dims or b.dims
    else:
        dims = a.dims if a.dims == b.dims else ()
    if a.dtype == b.dtype:
        dtype = a.dtype
    elif not a.dtype or not b.dtype:
        dtype = a.dtype or b.dtype
    else:
        dtype = _promote(a.dtype, b.dtype)
    hi = a if a.prov >= b.prov else b
    fnref = a.fnref if not b.fnref else (
        b.fnref if not a.fnref else
        tuple(sorted(set(a.fnref) | set(b.fnref))))
    return Shape(rank=rank, dims=dims, dtype=dtype,
                 weak=a.weak or b.weak,
                 prov=max(a.prov, b.prov),
                 is_mask=a.is_mask or b.is_mask,
                 pad_count=a.pad_count or b.pad_count,
                 masked_sum=a.masked_sum or b.masked_sum,
                 maskable=a.maskable or b.maskable,
                 guarded=a.guarded or b.guarded,
                 why=hi.why or a.why or b.why,
                 fnref=fnref)


def _promote(a: str, b: str) -> str:
    """Binary promotion on the short-name lattice (coarse)."""
    order = ["bool", "i8", "u8", "i16", "i32", "u32", "i64",
             "bf16", "f16", "f32", "f64"]
    try:
        return a if order.index(a) >= order.index(b) else b
    except ValueError:
        return ""


def collapse(v: Value) -> Shape:
    """Fold a structured value to one flat Shape."""
    if isinstance(v, Shape):
        return v
    out = BOTTOM
    for el in v:
        out = _join_flat(out, collapse(el))
    return out


def join(a: Value, b: Value) -> Value:
    """Structural join; unequal-arity tuples align by prefix."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        n = min(len(a), len(b))
        head = tuple(join(x, y) for x, y in zip(a[:n], b[:n]))
        tail = a[n:] if len(a) > len(b) else b[n:]
        return head + tail
    if isinstance(a, tuple) or isinstance(b, tuple):
        if isinstance(b, tuple):
            a, b = b, a
        return tuple(join(x, b) for x in a)
    return _join_flat(a, b)


def values_equal(a: Value, b: Value) -> bool:
    if isinstance(a, Shape) and isinstance(b, Shape):
        return a == b
    if isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b):
        return all(values_equal(x, y) for x, y in zip(a, b))
    return False


def _map_shape(v: Value, fn) -> Value:
    if isinstance(v, Shape):
        return fn(v)
    return tuple(_map_shape(el, fn) for el in v)


def _strip_slots(v: Value) -> Value:
    """Erase every padding-related fact (sanctioned slot consumers)."""
    return _map_shape(v, lambda s: replace(
        s, prov=NONE, is_mask=False, pad_count=False, masked_sum=False,
        maskable=False, why=""))


def _per_slot(v: Value) -> Value:
    """A vmap-mapped view: the slot axis is gone inside the body."""
    return _map_shape(v, lambda s: replace(
        s, prov=NONE, is_mask=False, pad_count=False,
        rank=None if s.rank is None else max(s.rank - 1, 0), dims=()))


# --- policy ------------------------------------------------------------

@dataclass
class ShapePolicy:
    """Declared padding producers, sanctioned consumers, and guards.

    Patterns match a call's raw or import-resolved dotted name on whole
    component suffixes (same convention as the taint policy).
    """

    # calls whose result carries PADDED slots on the leading axis
    padded_producers: Tuple[str, ...] = ()
    # calls returning an opaque plan object whose *attributes* carry the
    # padding facts (see the *_attrs tables)
    plan_producers: Tuple[str, ...] = ()
    # calls whose scalar result counts all slots incl. dead ones
    pad_count_producers: Tuple[str, ...] = ()

    # attribute / string-key tables for opaque plan objects
    padded_attrs: Tuple[str, ...] = ()
    zeroed_attrs: Tuple[str, ...] = ()
    mask_attrs: Tuple[str, ...] = ()

    # parameter names seeded as validity masks when no caller is seen
    mask_params: Tuple[str, ...] = ()
    # variable names whose use as a slice bound clears provenance
    count_names: Tuple[str, ...] = ()

    # sanctioned slot-axis consumers: call results are provenance-free
    slot_reducers: Tuple[str, ...] = ()

    # denominators that can be zero by construction (SL006)
    zero_risk_denoms: Tuple[str, ...] = ()

    # keywords naming a reduction's axis; whether a reduction's second
    # positional argument (``torch.sum(x, 0)``, ``x.sum(0)``) is one
    axis_keywords: Tuple[str, ...] = ("dim", "axis", "dims")
    positional_axis: bool = True
    # ``torch.zeros(b, k)``: a creation call's positional sizes
    varargs_shapes: bool = True
    calls: Calls = TORCH_CALLS
    words: Dict[str, str] = field(
        default_factory=lambda: dict(TORCH_SHAPE_WORDS))
    # call-site precision, as the taint policy's ``call_sites``
    call_sites: bool = True


# --- analysis ----------------------------------------------------------

class ShapeAnalysis:
    """Fixpoint + recording passes over one :class:`astgraph.CallGraph`."""

    def __init__(self, graph: astgraph.CallGraph, policy: ShapePolicy,
                 rules: Optional[Set[str]] = None):
        self.graph = graph
        self.policy = policy
        self.rules = rules          # None = all
        self.param_env: Dict[str, Dict[str, Value]] = {}
        self.summaries: Dict[str, Value] = {}
        self.fn_envs: Dict[str, Dict[str, Value]] = {}
        self.findings: List[Finding] = []
        self._changed = False
        # (callee, depth, arguments) -> result, within one pass
        self.call_site_memo: Dict[tuple, Value] = {}
        self._method_index: Dict[str, List[astgraph.FunctionInfo]] = {}
        for mod in self.graph.modules.values():
            for cls, methods in mod.classes.items():
                for m in methods:
                    info = mod.functions.get(f"{cls}.{m}")
                    if info is not None:
                        self._method_index.setdefault(m, []).append(info)

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
        if self.rules is not None:
            self.findings = [f for f in self.findings
                             if f.rule in self.rules]
        return self.findings

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

    def resolve_call(self, mod: astgraph.ModuleInfo,
                     fn: astgraph.FunctionInfo, raw: Optional[str]
                     ) -> List[astgraph.FunctionInfo]:
        if not raw:
            return []
        local = astgraph._resolve_local(mod, fn, raw)
        if local is not None:
            return [local]
        resolved = mod.resolve(raw)
        hit = self.graph.by_dotted.get(resolved)
        if hit is not None:
            return [hit]
        if "." in raw:
            meth = raw.rsplit(".", 1)[-1]
            targets = self._method_index.get(meth, [])
            if 0 < len(targets) <= _MAX_METHOD_TARGETS:
                return list(targets)
        return []

    def emit(self, rule: str, mod: astgraph.ModuleInfo, node: ast.AST,
             message: str, fn: astgraph.FunctionInfo) -> None:
        self.findings.append(Finding(
            rule=rule, path=mod.path, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), message=message,
            symbol=fn.qualname))


class _Evaluator:
    """One statement-ordered abstract interpretation of one function.

    Same flow discipline as the taint evaluator: branches execute
    sequentially over one environment, loops once, and the surrounding
    fixpoint supplies convergence.
    """

    def __init__(self, owner: ShapeAnalysis, mod: astgraph.ModuleInfo,
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

    # -- entry ---------------------------------------------------------

    def run(self) -> Value:
        if self.fn.parent is not None:
            parent = self.mod.functions.get(self.fn.parent)
            if parent is not None:
                self.env.update(self.a.fn_envs.get(parent.key, {}))
        seeded = self.seeded if self.seeded is not None else \
            self.a.param_env.get(self.fn.key, {})
        for pname in self.fn.params:
            v = seeded.get(pname, BOTTOM)
            if values_equal(v, BOTTOM) and pname in self.pol.mask_params:
                v = Shape(dtype="bool", is_mask=True,
                          why=f"validity mask '{pname}'")
            self.env[pname] = v
        self.exec_block(getattr(self.fn.node, "body", []))
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
                self.bind(t, v)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self.bind(st.target, self.eval(st.value))
        elif isinstance(st, ast.AugAssign):
            v = join(self.eval(st.target), self.eval(st.value))
            self.bind(st.target, v, augmented=True)
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
            self.bind(st.target, self._iter_element(self.eval(st.iter)))
            self.exec_block(st.body)
            self.exec_block(st.orelse)
        elif isinstance(st, ast.While):
            self.eval(st.test)
            self.exec_block(st.body)
            self.exec_block(st.orelse)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                v = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, v)
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
            pass
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)

    @staticmethod
    def _iter_element(v: Value) -> Value:
        # iterating a padded container yields per-slot elements: the
        # slot axis is consumed by the loop itself
        return _map_shape(v, lambda s: replace(
            s, rank=None if s.rank is None else max(s.rank - 1, 0),
            dims=()))

    def bind(self, target: ast.expr, v: Value,
             augmented: bool = False) -> None:
        if isinstance(target, ast.Name):
            if augmented:
                v = join(self.env.get(target.id, BOTTOM), v)
            self.env[target.id] = v
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            if isinstance(v, tuple):
                star = next((i for i, e in enumerate(elts)
                             if isinstance(e, ast.Starred)), None)
                if star is None and len(elts) <= len(v):
                    for e, el in zip(elts, v):
                        self.bind(e, el)
                    return
                for e in elts:
                    self.bind(e.value if isinstance(e, ast.Starred)
                              else e, collapse(v))
            else:
                for e in elts:
                    self.bind(e.value if isinstance(e, ast.Starred)
                              else e, v)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, v)
        elif isinstance(target, ast.Subscript):
            base = target.value
            if isinstance(base, ast.Name):
                self.env[base.id] = join(self.env.get(base.id, BOTTOM), v)
        elif isinstance(target, ast.Attribute):
            pass        # object state is not tracked

    # -- expressions ---------------------------------------------------

    def eval(self, node: ast.expr) -> Value:
        if isinstance(node, ast.Constant):
            return self._eval_constant(node)
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            tgts = self.a.resolve_call(self.mod, self.fn, node.id)
            if tgts:
                return Shape(fnref=tuple(sorted(t.key for t in tgts)))
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
            return self._eval_binop(node)
        if isinstance(node, ast.BoolOp):
            out = BOTTOM
            for e in node.values:
                out = join(out, collapse(self.eval(e)))
            return out
        if isinstance(node, ast.Compare):
            return self._eval_compare(node)
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            return join(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, ast.Subscript):
            return self._eval_subscript(node)
        if isinstance(node, ast.Attribute):
            return self._eval_attribute(node)
        if isinstance(node, ast.Call):
            return self.eval_call(node)
        if isinstance(node, (ast.ListComp, ast.SetComp,
                             ast.GeneratorExp, ast.DictComp)):
            for gen in node.generators:
                self.bind(gen.target,
                          self._iter_element(self.eval(gen.iter)))
                for cond in gen.ifs:
                    self.eval(cond)
            if isinstance(node, ast.DictComp):
                self.eval(node.key)
                return collapse(self.eval(node.value))
            return collapse(self.eval(node.elt))
        if isinstance(node, ast.Lambda):
            return BOTTOM
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self.eval(v.value)
            return BOTTOM
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self.eval(node.value)
        if isinstance(node, ast.Yield):
            return self.eval(node.value) if node.value else BOTTOM
        if isinstance(node, ast.NamedExpr):
            v = self.eval(node.value)
            self.bind(node.target, v)
            return v
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self.eval(part)
            return BOTTOM
        return BOTTOM

    @staticmethod
    def _eval_constant(node: ast.Constant) -> Shape:
        v = node.value
        if isinstance(v, bool):
            return Shape(rank=0, dtype="bool", weak=True)
        if isinstance(v, int):
            return Shape(rank=0, dtype="i32", weak=True)
        if isinstance(v, float):
            return Shape(rank=0, dtype="f32", weak=True)
        return BOTTOM

    # -- operators -----------------------------------------------------

    def _eval_binop(self, node: ast.BinOp) -> Value:
        lv = collapse(self.eval(node.left))
        rv = collapse(self.eval(node.right))
        arith = isinstance(node.op, _ARITH_OPS)
        out = _join_flat(lv, rv)
        if out.fnref:
            out = replace(out, fnref=())

        if arith:
            self._check_bool_arith(node, lv, rv)
            self._check_promotion(node, lv, rv)
            self._check_padded_broadcast(node, lv, rv)

        # mask multiplication / multiplication by exact-zero filler
        # zeros out the dead slots: ZEROED absorbs PADDED
        if isinstance(node.op, ast.Mult) and (
                lv.is_mask or rv.is_mask or
                ZEROED in (lv.prov, rv.prov)):
            out = replace(out, prov=ZEROED if out.prov else NONE,
                          is_mask=False)

        if isinstance(node.op, ast.Div):
            self._check_division(node, lv, rv)

        # `x + 1e-6` style floors guard a maskable denominator
        if isinstance(node.op, ast.Add) and (
                self._positive_literal(node.left) or
                self._positive_literal(node.right)):
            out = replace(out, maskable=False, guarded=True)

        # broadcasting: the result rank is the larger known rank
        if lv.rank is not None and rv.rank is not None:
            out = replace(out, rank=max(lv.rank, rv.rank),
                          dims=lv.dims if len(lv.dims) >= len(rv.dims)
                          else rv.dims)
        if arith and not isinstance(node.op, ast.MatMult):
            # arithmetic results are not masks/counters themselves
            out = replace(out, is_mask=False, pad_count=False)
        return out

    def _eval_compare(self, node: ast.Compare) -> Value:
        parts = [collapse(self.eval(node.left))]
        parts += [collapse(self.eval(c)) for c in node.comparators]
        ranks = [p.rank for p in parts if p.rank is not None]
        slotty = any(p.prov > NONE or p.pad_count for p in parts)
        names = {n.id for e in [node.left] + list(node.comparators)
                 for n in ast.walk(e) if isinstance(n, ast.Name)}
        if names & set(self.pol.count_names):
            slotty = True
        return Shape(rank=max(ranks) if ranks else None, dtype="bool",
                     is_mask=slotty,
                     why="validity mask" if slotty else "")

    def _eval_subscript(self, node: ast.Subscript) -> Value:
        base = self.eval(node.value)
        self.eval(node.slice)
        sl = node.slice

        # tuple summaries index structurally
        if isinstance(base, tuple) and isinstance(sl, ast.Constant) and \
                isinstance(sl.value, int) and \
                -len(base) <= sl.value < len(base):
            return base[sl.value]
        part = _const_slice(sl) if self.pol.call_sites else None
        if isinstance(base, tuple) and part is not None:
            return base[part]
        flat = collapse(base)

        # dict-style access on a plan payload: string keys hit the same
        # attribute tables as the plan object's attributes
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            table = self._attr_shape(sl.value)
            if table is not None:
                return table
            return flat

        # slicing back to the live prefix clears padding provenance:
        # `losses[:p_count]`
        slices = [sl.elts[0] if isinstance(sl, ast.Tuple) and sl.elts
                  else sl]
        if isinstance(sl, ast.Tuple):
            slices = list(sl.elts)
        for s in slices:
            if isinstance(s, ast.Slice) and s.upper is not None:
                upper_names = {n.id for n in ast.walk(s.upper)
                               if isinstance(n, ast.Name)}
                if upper_names & set(self.pol.count_names):
                    return replace(flat, prov=NONE, pad_count=False,
                                   why="sliced to live prefix")

        # integer indexing consumes the leading axis
        if isinstance(sl, ast.Constant) and isinstance(sl.value, int):
            return replace(flat, prov=NONE,
                           rank=None if flat.rank is None
                           else max(flat.rank - 1, 0), dims=())

        # `x[:, None]` expands rank but keeps provenance (feeds SL005)
        if isinstance(sl, ast.Tuple) and any(
                isinstance(e, ast.Constant) and e.value is None
                for e in sl.elts):
            return replace(flat, rank=None if flat.rank is None
                           else flat.rank + 1, dims=())
        return flat

    def _attr_shape(self, attr: str) -> Optional[Shape]:
        if attr in self.pol.padded_attrs:
            return Shape(prov=PADDED, dtype="i32",
                         why=f"padded plan leg '{attr}'")
        if attr in self.pol.zeroed_attrs:
            return Shape(prov=ZEROED, dtype="f32",
                         why=f"zero-filled plan leg '{attr}'")
        if attr in self.pol.mask_attrs:
            return Shape(dtype="bool", is_mask=True,
                         why=f"validity mask '{attr}'")
        return None

    def _eval_attribute(self, node: ast.Attribute) -> Value:
        table = self._attr_shape(node.attr)
        if table is not None:
            self.eval(node.value)
            return table
        base = collapse(self.eval(node.value))
        if node.attr == "shape":
            if base.prov > NONE:
                return Shape(pad_count=True, dtype="i32",
                             why="shape of a padded array")
            return BOTTOM
        if node.attr in ("ndim", "size", "dtype", "nbytes", "itemsize",
                         "sharding", "device", "name", "T"):
            return BOTTOM
        return base

    # -- calls ---------------------------------------------------------

    def _unwrap_callee(self, node: ast.Call
                       ) -> Tuple[Optional[str], List[ast.expr],
                                  Optional[str]]:
        """Peel ``vmap(f, ...)(args)`` and ``checkpoint(f, *args)`` to
        (f, the args f receives, wrapper)."""
        func = node.func
        args = list(node.args)
        wrappers = self.pol.calls.curried
        if isinstance(func, ast.Call):
            inner_name = astgraph.dotted_name(func.func)
            resolved = self.mod.resolve(inner_name) if inner_name else None
            if name_matches(wrappers, inner_name, resolved):
                for a in func.args:
                    nm = astgraph.dotted_name(a)
                    if nm and not name_matches(
                            wrappers, nm, self.mod.resolve(nm)):
                        wrapper = (inner_name or "").rsplit(".", 1)[-1]
                        return nm, args, wrapper
        name = astgraph.dotted_name(func)
        if name and args and name_matches(self.pol.calls.applying, name,
                                          self.mod.resolve(name)):
            inner = astgraph.dotted_name(args[0])
            if inner:
                return inner, args[1:], None
        return name, args, None

    def eval_call(self, node: ast.Call) -> Value:
        pol = self.pol
        raw, pos_exprs, wrapper = self._unwrap_callee(node)
        resolved = self.mod.resolve(raw) if raw else None
        # method calls on expression receivers (`(x == 0).sum()`) have
        # no dotted name; the attribute still names the operation
        last = raw.rsplit(".", 1)[-1] if raw else (
            node.func.attr if isinstance(node.func, ast.Attribute)
            else "")

        pos: List[Value] = []
        for a in pos_exprs:
            v = self.eval(a)
            if pol.call_sites and isinstance(a, ast.Starred) and \
                    isinstance(v, tuple):
                pos.extend(v)           # f(*t): t's elements in order
            else:
                pos.append(v)
        kwargs: Dict[Optional[str], Value] = {
            kw.arg: self.eval(kw.value) for kw in node.keywords}

        def flat_join() -> Shape:
            out = BOTTOM
            for v in pos + list(kwargs.values()):
                out = _join_flat(out, collapse(v))
            return out

        # container mutators on known locals: obj.append(x)
        if raw and "." in raw:
            base, meth = raw.rsplit(".", 1)
            if meth in _MUTATORS and "." not in base and base in self.env:
                self.env[base] = join(self.env.get(base, BOTTOM),
                                      flat_join())
                return BOTTOM

        # wrapper *construction*: `partial(f)` is a reference to f
        if raw is None and isinstance(node.func, ast.Call):
            inner = astgraph.dotted_name(node.func.func)
            inner_res = self.mod.resolve(inner) if inner else None
            if inner and name_matches(pol.calls.curried, inner, inner_res) \
                    and len(node.args) == 1:
                tname = astgraph.dotted_name(node.args[0])
                tgts = self.a.resolve_call(self.mod, self.fn, tname) \
                    if tname else []
                if tgts:
                    return Shape(fnref=tuple(sorted(t.key for t in tgts)))

        # ---- structural / builtin special forms ---------------------
        if raw == "len" and pos:
            if collapse(pos[0]).prov > NONE:
                return Shape(rank=0, dtype="i32", pad_count=True,
                             why="len() of a padded array")
            return Shape(rank=0, dtype="i32")
        if raw in _STRUCTURAL_CALLS:
            return BOTTOM
        # Python scalar builtins produce weak host scalars
        if raw in ("int", "round") and pos:
            return Shape(rank=0, dtype="i32", weak=True)
        if raw == "float" and pos:
            return Shape(rank=0, dtype="f32", weak=True)
        if raw == "bool" and pos:
            return Shape(rank=0, dtype="bool", weak=True)
        if last == "count_nonzero" and pos:
            return Shape(rank=0, dtype="i32")
        if raw == "enumerate" and pos:
            return (BOTTOM, self._iter_element(pos[0]))
        if raw == "zip":
            return tuple(self._iter_element(p) for p in pos)
        if name_matches(pol.calls.scans, raw, resolved):
            return self._eval_scan(node, pos)
        if last in ("tree_map", "map") and raw and (
                "tree" in raw or "tree_util" in raw):
            return self._eval_tree_map(node, pos_exprs, pos)

        # ---- guards (before reduction/div checks use the result) ----
        recv = self._receiver(raw)
        if last in _METHOD_GUARDS and recv is not None and (
                any(self._positive_literal(e) for e in pos_exprs) or any(
                    self._positive_literal(kw.value)
                    for kw in node.keywords)):
            return replace(collapse(recv), maskable=False, guarded=True,
                           is_mask=False)
        if last in _GUARD_CALLS and pos:
            operand = collapse(pos[0])
            floor_pos = any(self._positive_literal(e)
                            for e in pos_exprs[1:]) or any(
                self._positive_literal(kw.value) for kw in node.keywords)
            if floor_pos:
                return replace(operand, maskable=False, guarded=True,
                               is_mask=False)
            return operand

        # ---- where / select: the sanctioned masking idiom ------------
        if last in ("where", "select") and len(pos) == 3:
            cond = collapse(pos[0])
            a_val = collapse(pos[1])
            b_zero = self._zero_expr(pos_exprs[2])
            if b_zero and (cond.is_mask or a_val.prov == PADDED):
                return replace(a_val, prov=ZEROED, is_mask=False,
                               why="validity-masked")
            return _join_flat(a_val, collapse(pos[2]))

        # ---- dtype casts --------------------------------------------
        cast = self._eval_cast(node, raw, last, pos, pos_exprs)
        if cast is not None:
            return cast

        # ---- reductions ---------------------------------------------
        if last in _REDUCTIONS:
            return self._eval_reduction(node, raw, last, pos, kwargs)
        if last in ("any", "all", "isfinite", "isnan", "isinf",
                    "logical_and", "logical_or", "logical_not") and pos:
            operand = collapse(pos[0])
            return Shape(dtype="bool", is_mask=operand.prov > NONE,
                         rank=None)

        # ---- nonfinite producers (SL006) ----------------------------
        if last in _NONFINITE_OPS and pos:
            operand = collapse(pos[0])
            if self.record and operand.maskable and not operand.guarded:
                self._emit("SL006", node,
                           f"{last}() of a maskable quantity "
                           f"({operand.why or 'can be zero'}) without a "
                           "dominating positive guard — produces "
                           "inf/nan when every slot is masked out "
                           f"(guard with {self.w['guard_eps']})")
            return replace(operand, is_mask=False)

        # ---- policy: padding producers ------------------------------
        if name_matches(pol.pad_count_producers, raw, resolved):
            return Shape(rank=0, dtype="i32", pad_count=True,
                         why=f"bucket capacity from {last}()")
        if name_matches(pol.plan_producers, raw, resolved):
            self._seed_targets(raw, pos, kwargs, wrapper)
            return Shape(why=f"fused plan from {last}()")
        if name_matches(pol.padded_producers, raw, resolved):
            self._seed_targets(raw, pos, kwargs, wrapper)
            return _map_shape(
                self._call_summary(raw) or BOTTOM,
                lambda s: replace(s, prov=PADDED,
                                  why=f"padded by {last}()"))

        # ---- policy: sanctioned slot reducers -----------------------
        if name_matches(pol.slot_reducers, raw, resolved):
            self._seed_targets(raw, pos, kwargs, wrapper)
            out = self._call_summary(raw)
            return _strip_slots(out) if out is not None else BOTTOM

        # ---- creation calls -----------------------------------------
        if last in _CREATION_CALLS:
            return self._eval_creation(node, last, pos, pos_exprs)

        # ---- SL006 zero-risk named denominators fall through to the
        # division check in _eval_binop; nothing to do here ------------

        # ---- interprocedural ----------------------------------------
        targets = forward_of(self.a.graph, pol.calls, self.mod, self.fn,
                             raw)
        if targets:
            pos = [BOTTOM] + pos            # Fn.forward's ctx
        else:
            targets = self.a.resolve_call(self.mod, self.fn, raw)
        fval: Optional[Value] = None
        if not targets:
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
                self._propagate_args(tgt, raw, pos, kwargs, wrapper)
                s = self._at_call_site(tgt, raw, pos, kwargs, wrapper)
                if s is None:
                    s = self.a.summaries.get(tgt.key, BOTTOM)
                out = s if out is None else join(out, s)
            if out is None:
                out = BOTTOM
            if wrapper in ("vmap", "pmap"):
                arg_prov = max([collapse(p).prov for p in pos] +
                               [collapse(v) .prov
                                for v in kwargs.values()] + [NONE])
                if arg_prov > NONE:
                    out = _map_shape(out, lambda s: replace(
                        s, prov=max(s.prov, arg_prov),
                        why=s.why or "vmapped over padded slots"))
            return out

        # unknown constructor-like call: opaque object
        if raw and raw.rsplit(".", 1)[-1][:1].isupper():
            return BOTTOM

        # unresolved method calls keep their receiver's facts
        recv: Value = BOTTOM
        if isinstance(node.func, ast.Attribute):
            if raw is None:
                recv = fval if fval is not None else BOTTOM
            else:
                base = raw.rsplit(".", 1)[0]
                if "." not in base and base in self.env:
                    recv = self.env[base]

        out = _join_flat(flat_join(), collapse(recv))
        return replace(out, fnref=()) if out.fnref else out

    # -- call helpers --------------------------------------------------

    def _call_summary(self, raw: Optional[str]) -> Optional[Value]:
        targets = self.a.resolve_call(self.mod, self.fn, raw)
        if not targets:
            return None
        out: Optional[Value] = None
        for tgt in targets:
            s = self.a.summaries.get(tgt.key, BOTTOM)
            out = s if out is None else join(out, s)
        return out

    def _at_call_site(self, tgt: astgraph.FunctionInfo, raw: Optional[str],
                      pos: List[Value], kwargs: Dict[Optional[str], Value],
                      wrapper: Optional[str]) -> Optional[Value]:
        """A small helper's result on this call's own arguments
        (``call_sites``); None: use the summary."""
        if not self.pol.call_sites or wrapper is not None or \
                self.depth >= _MAX_INLINE_DEPTH or \
                tgt.key == self.fn.key or \
                _size(tgt.node) > _MAX_INLINE_NODES:
            return None
        from repro_torch.analysis.taint import _bind_args
        env = _bind_args(tgt, raw, pos, kwargs, join, collapse, BOTTOM)
        key = (tgt.key, self.depth, tuple(sorted(env.items())))
        if key not in self.a.call_site_memo:
            mod = self.a.graph.modules[tgt.module]
            self.a.call_site_memo[key] = _Evaluator(
                self.a, mod, tgt, record=False, seeded=env,
                depth=self.depth + 1).run()
        return self.a.call_site_memo[key]

    def _seed_targets(self, raw: Optional[str], pos: List[Value],
                      kwargs: Dict[Optional[str], Value],
                      wrapper: Optional[str]) -> None:
        for tgt in self.a.resolve_call(self.mod, self.fn, raw):
            self._propagate_args(tgt, raw, pos, kwargs, wrapper)

    def _propagate_args(self, tgt: astgraph.FunctionInfo,
                        raw: Optional[str], pos: List[Value],
                        kwargs: Dict[Optional[str], Value],
                        wrapper: Optional[str] = None) -> None:
        if wrapper in ("vmap", "pmap"):
            # the body sees one slot at a time: strip the slot axis
            pos = [_per_slot(p) for p in pos]
            kwargs = {k: _per_slot(v) for k, v in kwargs.items()}
        params = list(tgt.params)
        if params and params[0] in ("self", "cls") and raw and \
                "." in raw:
            params = params[1:]
        for pname, val in zip(params, pos):
            self.a.seed_param(tgt.key, pname, val)
        star = collapse(tuple(pos)) if len(pos) > len(params) else None
        for k, val in kwargs.items():
            if k is None:
                for pname in params:
                    self.a.seed_param(tgt.key, pname, collapse(val))
            elif k in params:
                self.a.seed_param(tgt.key, k, val)
        if star is not None and star != BOTTOM:
            for pname in params:
                self.a.seed_param(tgt.key, pname, star)

    def _eval_scan(self, node: ast.Call, pos: List[Value]) -> Value:
        # scans here run over *rounds* (S); slot padding lives on the B
        # axis inside each per-step xs slice, so xs seeds keep their
        # provenance (unlike vmap, which maps over the slot axis)
        body_name = astgraph.dotted_name(node.args[0]) if node.args \
            else None
        init = pos[1] if len(pos) > 1 else BOTTOM
        xs = pos[2] if len(pos) > 2 else BOTTOM
        targets = self.a.resolve_call(self.mod, self.fn, body_name)
        if not targets and body_name and "." not in body_name:
            fval = self.env.get(body_name)
            if fval is not None:
                targets = [self.a.graph.functions[k]
                           for k in collapse(fval).fnref
                           if k in self.a.graph.functions]
        summary: Value = BOTTOM
        for tgt in targets:
            params = [p for p in tgt.params if p not in ("self",)]
            if params:
                self.a.seed_param(tgt.key, params[0], init)
            if len(params) > 1:
                self.a.seed_param(tgt.key, params[1], xs)
            summary = join(summary, self.a.summaries.get(tgt.key, BOTTOM))
        if isinstance(summary, tuple) and len(summary) == 2:
            return (join(summary[0], init), summary[1])
        return join(summary, init)

    def _eval_tree_map(self, node: ast.Call,
                       pos_exprs: List[ast.expr],
                       pos: List[Value]) -> Value:
        if not pos_exprs:
            return BOTTOM
        fn_expr, tree_vals = pos_exprs[0], pos[1:]
        arg = BOTTOM
        for v in tree_vals:
            arg = _join_flat(arg, collapse(v))
        # inline lambdas: evaluate the body with params bound to leaves
        if isinstance(fn_expr, ast.Lambda):
            saved = dict(self.env)
            for p in fn_expr.args.args:
                self.env[p.arg] = arg
            out = self.eval(fn_expr.body)
            self.env = saved
            return out
        fname = astgraph.dotted_name(fn_expr)
        targets = self.a.resolve_call(self.mod, self.fn, fname)
        if targets:
            out: Value = BOTTOM
            for tgt in targets:
                params = [p for p in tgt.params if p != "self"]
                for pname, v in zip(params, pos[1:]):
                    self.a.seed_param(tgt.key, pname, v)
                out = join(out, self.a.summaries.get(tgt.key, BOTTOM))
            return out
        return arg

    # -- dtype machinery -----------------------------------------------

    @staticmethod
    def _dtype_of_expr(node: ast.expr) -> str:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return _DTYPE_SHORT.get(node.value, "")
        name = astgraph.dotted_name(node)
        if not name:
            return ""
        last = name.rsplit(".", 1)[-1]
        if last == "float":
            return "f64"        # numpy: astype(float) is float64
        if last == "int":
            return "i64"
        return _DTYPE_SHORT.get(last, "")

    def _receiver(self, raw: Optional[str]) -> Optional[Value]:
        """A method call's receiver, when it is a local (``x.float()``)."""
        if raw and "." in raw:
            base = raw.rsplit(".", 1)[0]
            if "." not in base:
                return self.env.get(base)
        return None

    def _eval_cast(self, node: ast.Call, raw: Optional[str], last: str,
                   pos: List[Value], pos_exprs: List[ast.expr]
                   ) -> Optional[Value]:
        # torch's method casts: x.float(), x.to(torch.int32), x.to(y)
        if isinstance(node.func, ast.Attribute) and (
                (last in _METHOD_CASTS and not pos_exprs) or
                (last in ("to", "type") and (pos_exprs or any(
                    kw.arg == "dtype" for kw in node.keywords)))):
            recv = self._receiver(raw)
            if recv is None:
                recv = self.eval(node.func.value)
            if last in _METHOD_CASTS:
                dt = _METHOD_CASTS[last]
            else:
                exprs = [kw.value for kw in node.keywords
                         if kw.arg == "dtype"] + pos_exprs
                dt = next((d for d in map(self._dtype_of_expr, exprs)
                           if d), "")
            self._maybe_sl003(node, dt, f".{last}()")
            return _map_shape(recv, lambda s: replace(
                s, dtype=dt or s.dtype, weak=False))
        # x.astype(dt) / (expr).astype(dt) / np.astype(x, dt)
        if last == "astype":
            recv: Value = BOTTOM
            if isinstance(node.func, ast.Attribute):
                recv = self.eval(node.func.value)
            if values_equal(recv, BOTTOM) and pos:
                recv = pos[0]
            dt_expr = pos_exprs[-1] if pos_exprs else None
            dt = self._dtype_of_expr(dt_expr) if dt_expr is not None \
                else ""
            out = _map_shape(recv, lambda s: replace(
                s, dtype=dt or s.dtype, weak=False))
            self._maybe_sl003(node, dt, "astype")
            return out
        # dtype-constructor casts: np.float64(x), np.float32(x)
        dt = _DTYPE_SHORT.get(last, "")
        if dt and pos:
            self._maybe_sl003(node, dt, last)
            return _map_shape(pos[0], lambda s: replace(
                s, dtype=dt, weak=False))
        return None

    def _maybe_sl003(self, node: ast.AST, dt: str, what: str) -> None:
        if self.record and dt == "f64" and self.fn.in_trace:
            self._emit("SL003", node,
                       f"{what} creates a float64 value inside "
                       f"{self.w['reach']} code — {self.w['f64']}; pin "
                       "an explicit f32 dtype")

    def _check_promotion(self, node: ast.BinOp, lv: Shape,
                         rv: Shape) -> None:
        if not self.record or not self.fn.in_trace:
            return
        pair = {lv.dtype, rv.dtype}
        if pair == {"f32", "f64"} and not (lv.weak or rv.weak):
            self._emit("SL003", node,
                       f"f32 × f64 arithmetic inside {self.w['reach']} "
                       "code — silent promotion/truncation drift; cast "
                       "one operand explicitly")

    def _check_bool_arith(self, node: ast.BinOp, lv: Shape,
                          rv: Shape) -> None:
        if not self.record:
            return
        for side in (lv, rv):
            if side.dtype == "bool" and not side.weak:
                self._emit("SL004", node,
                           f"boolean {'mask ' if side.is_mask else ''}"
                           "value used arithmetically without an "
                           "explicit cast — integer promotion is "
                           "implicit and dtype-dependent; use "
                           f"{self.w['cast']} first")
                return

    def _check_padded_broadcast(self, node: ast.BinOp, lv: Shape,
                                rv: Shape) -> None:
        if not self.record:
            return
        for padded, other in ((lv, rv), (rv, lv)):
            if padded.prov == PADDED and other.prov == NONE and \
                    not other.is_mask and \
                    padded.rank is not None and other.rank is not None \
                    and other.rank not in (0, padded.rank):
                self._emit("SL005", node,
                           f"rank-{padded.rank} padded array "
                           f"({padded.why or 'dead slots'}) broadcasts "
                           f"against a rank-{other.rank} clean array — "
                           "padding provenance silently widens to the "
                           "broadcast result; mask before broadcasting")
                return

    def _check_division(self, node: ast.BinOp, num: Shape,
                        den: Shape) -> None:
        if not self.record:
            return
        if den.pad_count and (num.masked_sum or num.prov > NONE):
            self._emit("SL002", node,
                       "division by a slot count that includes padded "
                       f"slots ({den.why or 'bucket capacity'}) — the "
                       "denominator must be the number of *valid* "
                       "slots (Σmask), not the bucket size")
            return
        if den.maskable and not den.guarded:
            self._emit("SL006", node,
                       f"division by a maskable quantity "
                       f"({den.why or 'Σmask can be 0'}) without a "
                       "dominating positive guard — all-masked inputs "
                       f"produce inf/nan (guard with {self.w['guard_one']})")
            return
        if isinstance(node.right, ast.Name) and \
                node.right.id in self.pol.zero_risk_denoms and \
                not den.guarded:
            self._emit("SL006", node,
                       f"division by '{node.right.id}' which can be "
                       "zero by construction — guard with "
                       "max(·, 1) before dividing")

    # -- reductions ----------------------------------------------------

    def _eval_reduction(self, node: ast.Call, raw: Optional[str],
                        last: str, pos: List[Value],
                        kwargs: Dict[Optional[str], Value]) -> Value:
        operand = BOTTOM
        if raw and "." in raw:
            base = raw.rsplit(".", 1)[0]
            if "." not in base and base in self.env:
                operand = collapse(self.env[base])   # x.sum()
        elif raw is None and isinstance(node.func, ast.Attribute):
            operand = collapse(self.eval(node.func.value))
        if values_equal(operand, BOTTOM) and pos:
            operand = collapse(pos[0])
        has_axis = any(kw.arg in self.pol.axis_keywords and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None)
            for kw in node.keywords)
        if self.pol.positional_axis and not has_axis:
            # `torch.sum(x, 0)` (a module's function) or `x.sum(0)`
            head = (raw or "").split(".", 1)[0]
            i = 1 if raw and "." in raw and head in self.mod.imports \
                else 0
            has_axis = len(node.args) > i and not (
                isinstance(node.args[i], ast.Constant) and
                node.args[i].value is None)

        if self.record:
            if operand.dtype == "bool" and not operand.weak and \
                    last in (_SUM_FAMILY | _MEAN_FAMILY):
                self._emit("SL004", node,
                           f"{last}() over a boolean "
                           f"{'mask' if operand.is_mask else 'array'} "
                           "without an explicit cast — the result "
                           "dtype is an implicit integer promotion; "
                           f"cast with {self.w['cast_int']} first")
            if operand.prov == PADDED and not has_axis:
                why = operand.why or "garbage filler values"
                self._emit("SL001", node,
                           f"{last}() reduces over an axis carrying "
                           f"padded slots ({why}) with no dominating "
                           f"validity mask — mask with {self.w['where']} "
                           "or slice to the live prefix first")
            elif operand.prov == ZEROED and not has_axis and \
                    last in _MEAN_FAMILY:
                self._emit("SL002", node,
                           f"{last}() over a zero-filled (masked) axis "
                           "counts the dead slots in its denominator — "
                           "use a masked sum divided by Σvalid instead")

        dtype = operand.dtype
        if operand.dtype == "bool":
            dtype = "i32" if last in _SUM_FAMILY else "f32"
        elif last in _MEAN_FAMILY and dtype.startswith(("i", "u")):
            dtype = "f32"
        return Shape(
            rank=0 if not has_axis else (
                None if operand.rank is None
                else max(operand.rank - 1, 0)),
            dtype=dtype,
            masked_sum=(last in _SUM_FAMILY and
                        operand.prov == ZEROED and not has_axis),
            maskable=operand.is_mask and last in _SUM_FAMILY,
            why=("Σmask" if operand.is_mask and last in _SUM_FAMILY
                 else ""))

    # -- creation ------------------------------------------------------

    def _eval_creation(self, node: ast.Call, last: str,
                       pos: List[Value], pos_exprs: List[ast.expr]
                       ) -> Value:
        dt = ""
        for kw in node.keywords:
            if kw.arg == "dtype":
                dt = self._dtype_of_expr(kw.value)
        if last in ("array", "asarray") and len(pos_exprs) > 1:
            dt = dt or self._dtype_of_expr(pos_exprs[1])
        if dt == "f64":
            self._maybe_sl003(node, dt, f"{last}(dtype=float64)")

        rank: Optional[int] = None
        dims: Tuple[str, ...] = ()
        if self.pol.varargs_shapes and last in ("zeros", "ones", "empty") \
                and len(pos_exprs) > 1 and not isinstance(
                    pos_exprs[0], (ast.Tuple, ast.List)):
            # torch.zeros(b, k): the sizes as positional arguments
            pos_exprs = [ast.Tuple(elts=list(pos_exprs), ctx=ast.Load())]
        if last in ("zeros", "ones", "full", "empty") and pos_exprs:
            shp = pos_exprs[0]
            if isinstance(shp, (ast.Tuple, ast.List)):
                rank = len(shp.elts)
                dims = tuple(
                    (e.id if isinstance(e, ast.Name) else
                     str(e.value) if isinstance(e, ast.Constant) else "?")
                    for e in shp.elts)
            elif isinstance(shp, (ast.Constant, ast.Name)):
                rank = 1
        elif last in ("arange", "linspace"):
            rank = 1
        elif last == "eye":
            rank = 2
        elif last.endswith("_like") and pos:
            src = collapse(pos[0])
            rank, dims = src.rank, src.dims

        pad = False
        if last == "arange" and pos and collapse(pos[0]).pad_count:
            # arange(bucket_size): indexes every slot incl. dead ones
            pad = True
        return Shape(rank=rank, dims=dims, dtype=dt or "f32",
                     pad_count=pad,
                     why="slot index range" if pad else "")

    # -- misc ----------------------------------------------------------

    @staticmethod
    def _positive_literal(node: ast.expr) -> bool:
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, (int, float)) and \
                not isinstance(node.value, bool):
            return node.value > 0
        return False

    def _zero_expr(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, (int, float)):
            return node.value == 0
        if isinstance(node, ast.Call):
            name = astgraph.dotted_name(node.func) or ""
            return name.rsplit(".", 1)[-1] in ("zeros", "zeros_like")
        if isinstance(node, ast.Name):
            v = collapse(self.env.get(node.id, BOTTOM))
            return v.why == "zeros"
        return False

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if self.record:
            self.a.emit(rule, self.mod, node, message, self.fn)
