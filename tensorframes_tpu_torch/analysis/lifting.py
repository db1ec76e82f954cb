"""Static front-end of verified UDF lifting (Tenspiler-style, 2404.18249).

The reference package's ``analysis/lifting.py``, copied: the allowlists,
the decline taxonomy, the offending AST node names and line numbers are
API (TFG112 prints them), so they read as the reference's.

A numpy UDF captured as a host callback (``numpy_udf``) is the plan
layer's last hard fusion barrier: pushdown, join reordering and kernel
selection all decline around an opaque host stage (TFG107 names it).
This module inspects the *Python source* of such a UDF and either
produces a :class:`LiftCandidate` — a validated AST restricted to a
closed allowlist of elementwise/reduction numpy ops, constants and
column refs (no control flow, no side effects, no mutable state) — or
raises :class:`LiftDeclined` naming the offending AST node.

The candidate is only half the story:
:mod:`tensorframes_tpu_torch.plan.lift` synthesizes an equivalent torch
Program from it and *verifies* the synthesis bit-exactly against the
original numpy function, on the device the stage will run on, before
any substitution happens. This module is pure ``ast``/``inspect`` (no
torch) so ``--lift-report`` and the TFG112 rule can classify UDFs
without touching a device.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

__all__ = [
    "LiftCandidate",
    "LiftDeclined",
    "inspect_udf",
    "ELEMENTWISE_OPS",
    "REDUCTION_OPS",
    "ARRAY_METHODS",
]

# ---------------------------------------------------------------------------
# The closed allowlist
# ---------------------------------------------------------------------------

#: ``np.<name>`` calls synthesized as elementwise plan-IR expressions.
#: Everything here has a torch counterpart (plan/lift's name table);
#: whether a given use verifies bit-exactly on the actual block dtypes
#: and device is decided by the plan/lift equivalence harness, not here
#: (libm-vs-device transcendental ULP differences are caught there,
#: never papered over).
ELEMENTWISE_OPS: Set[str] = {
    "abs", "absolute",
    "add", "subtract", "multiply", "divide", "true_divide",
    "floor_divide", "mod", "remainder", "power",
    "negative", "positive", "sign",
    "exp", "expm1", "exp2", "log", "log1p", "log2", "log10",
    "sqrt", "square",
    "floor", "ceil", "trunc", "rint",
    "sin", "cos", "tan", "tanh", "sinh", "cosh",
    "arcsin", "arccos", "arctan",
    "maximum", "minimum", "where", "clip",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "isnan", "isinf", "isfinite",
}

#: Full reductions (block → scalar). Float-dtype reductions are
#: *policy-declined* downstream: ``sum``/``mean``/``prod`` because
#: numpy's pairwise accumulation order is not bit-stable against a
#: device reduce (the same exactness line the optimizer's reassoc_safe
#: gate draws), ``min``/``max`` because signed-zero ties at the extremum
#: resolve position-dependently in numpy and order-free on the device. Integer
#: min/max, int/bool sum (modular), and narrow-int mean (exact f64
#: accumulation; int64 declines — inexact past 2^53) lift.
REDUCTION_OPS: Set[str] = {"sum", "mean", "prod", "min", "max", "amin", "amax"}

#: ndarray method spellings (``x.sum()``, ``x.clip(lo, hi)``) accepted as
#: aliases of the ``np.<name>`` call form.
ARRAY_METHODS: Set[str] = {"sum", "mean", "prod", "min", "max", "clip"}

_ALLOWED_BINOPS = {
    ast.Add: "add", ast.Sub: "subtract", ast.Mult: "multiply",
    ast.Div: "divide", ast.FloorDiv: "floor_divide", ast.Mod: "mod",
    ast.Pow: "power",
}
_ALLOWED_UNARY = {ast.USub: "negative", ast.UAdd: "positive",
                  ast.Invert: "invert"}
_ALLOWED_CMPOPS = (ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE)

#: Immutable scalar closure types that lift as compile-time constants.
_SCALAR_TYPES = (int, float, bool, complex)

#: Mutable closure types that make a callback a stale-closure hazard:
#: the callback re-reads them on every block, so a post-capture mutation
#: silently rebinds the UDF's behavior. Lift declines these loudly and
#: the capture path warns (TFG112).
_MUTABLE_TYPES_NAMES = (
    "list", "dict", "set", "bytearray", "ndarray", "defaultdict",
    "OrderedDict", "Counter", "deque",
)


class LiftDeclined(Exception):
    """A UDF the lifter refuses, with the taxonomy reason and — wherever
    one exists — the offending AST node (TFG112's explain()-with-fix
    names it)."""

    def __init__(self, reason: str, node: Optional[str] = None,
                 lineno: Optional[int] = None, detail: str = ""):
        self.reason = reason
        self.node = node
        self.lineno = lineno
        self.detail = detail
        loc = f" (line {lineno})" if lineno else ""
        at = f" at {node!r}" if node else ""
        super().__init__(f"{reason}{at}{loc}" + (f": {detail}" if detail else ""))


@dataclass
class LiftCandidate:
    """A UDF that passed static validation: its body is a straight-line
    sequence of allowlisted expressions over column refs, numeric
    constants and immutable scalar closures. Synthesis + bit-exact
    verification (plan/lift) still decide whether it actually lifts."""

    fn: object
    name: str
    source: str
    params: List[str]
    #: immutable scalar closure/global bindings, snapshotted at inspect
    consts: Dict[str, object]
    #: names bound to the numpy module inside the UDF ("np", "numpy")
    np_aliases: Set[str]
    #: straight-line body: zero or more single-target Assigns, then Return
    body: List[ast.stmt]
    #: syntactic evidence a full reduction appears (drives the corpus's
    #: empty-block handling: numpy min/max of an empty block raise, so
    #: the size-0 case is undefined for both paths alike)
    has_reduction: bool = False
    mutable_closures: List[str] = field(default_factory=list)


def _decline(reason: str, node: Optional[ast.AST] = None, detail: str = ""):
    name = type(node).__name__ if node is not None else None
    lineno = getattr(node, "lineno", None)
    raise LiftDeclined(reason, node=name, lineno=lineno, detail=detail)


def _get_source_tree(fn):
    """Source → AST for a def or a lambda. Lambdas come wrapped in their
    enclosing statement; locate the first Lambda node."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError) as e:
        raise LiftDeclined("no-source", detail=str(e))
    try:
        tree = ast.parse(src)
    except SyntaxError:
        # a lambda mid-expression can dedent into invalid syntax; retry
        # wrapped in parens
        try:
            tree = ast.parse(f"({src.strip()})", mode="eval")
        except SyntaxError as e:
            raise LiftDeclined("no-source", detail=f"unparseable source: {e}")
    if fn.__name__ == "<lambda>":
        for node in ast.walk(tree):
            if isinstance(node, ast.Lambda):
                return src, node
        raise LiftDeclined("no-source", detail="lambda source not found")
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(node, ast.AsyncFunctionDef):
                _decline("unsupported-syntax:AsyncFunctionDef", node)
            return src, node
    raise LiftDeclined("no-source", detail="no function definition in source")


def _closure_env(fn):
    """Snapshot the UDF's free/global bindings and classify each:
    numpy aliases, immutable scalar constants, or mutable hazards."""
    import numpy as np

    bindings: Dict[str, object] = {}
    code = getattr(fn, "__code__", None)
    if code is not None and fn.__closure__:
        for var, cell in zip(code.co_freevars, fn.__closure__):
            try:
                bindings[var] = cell.cell_contents
            except ValueError:  # empty cell
                continue
    g = getattr(fn, "__globals__", {}) or {}
    for name in (code.co_names if code is not None else ()):
        if name in g and name not in bindings:
            bindings[name] = g[name]

    np_aliases: Set[str] = set()
    consts: Dict[str, object] = {}
    mutable: List[str] = []
    for name, val in bindings.items():
        if val is np:
            np_aliases.add(name)
        elif isinstance(val, _SCALAR_TYPES) or isinstance(val, np.generic):
            consts[name] = val
        elif type(val).__name__ in _MUTABLE_TYPES_NAMES or isinstance(
            val, (list, dict, set, bytearray, np.ndarray)
        ):
            mutable.append(name)
        # anything else (modules, callables, objects) is only an offense
        # if the body actually references it — the validator decides
    return np_aliases, consts, mutable


class _Validator(ast.NodeVisitor):
    """Raise LiftDeclined on the first construct outside the allowlist.
    The taxonomy follows the TFG112 catalog: unsupported-syntax:<Node>,
    unsupported-call:<name>, mutable-closure:<var>,
    data-dependent-branch, augmented-assignment."""

    def __init__(self, cand: LiftCandidate, mutable: List[str]):
        self.c = cand
        self.mutable = set(mutable)
        self.locals: Set[str] = set(cand.params)

    # -- statements ---------------------------------------------------
    def check_body(self, stmts: List[ast.stmt]) -> List[ast.stmt]:
        body: List[ast.stmt] = []
        # a leading docstring is inert
        if stmts and isinstance(stmts[0], ast.Expr) and isinstance(
            stmts[0].value, ast.Constant
        ) and isinstance(stmts[0].value.value, str):
            stmts = stmts[1:]
        if not stmts:
            _decline("unsupported-syntax:empty-body")
        for i, st in enumerate(stmts):
            if isinstance(st, ast.Return):
                if st.value is None:
                    _decline("unsupported-syntax:bare-return", st)
                if i != len(stmts) - 1:
                    _decline("unsupported-syntax:early-return", st)
                self._check_return(st.value)
                body.append(st)
            elif isinstance(st, ast.Assign):
                if len(st.targets) != 1 or not isinstance(
                    st.targets[0], ast.Name
                ):
                    _decline("unsupported-syntax:Assign", st,
                             detail="only single-name targets lift")
                self.visit(st.value)
                self.locals.add(st.targets[0].id)
                body.append(st)
            elif isinstance(st, ast.AugAssign):
                _decline("augmented-assignment", st)
            elif isinstance(st, (ast.If,)):
                _decline("data-dependent-branch", st)
            else:
                _decline(f"unsupported-syntax:{type(st).__name__}", st)
        if not isinstance(body[-1], ast.Return):
            _decline("unsupported-syntax:no-return", body[-1])
        return body

    def _check_return(self, value: ast.expr) -> None:
        if isinstance(value, ast.Dict):
            for k in value.keys:
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    _decline("unsupported-syntax:Dict", value,
                             detail="output dict keys must be string "
                                    "literals")
            for v in value.values:
                self.visit(v)
        elif isinstance(value, (ast.Tuple, ast.List)):
            for v in value.elts:
                self.visit(v)
        else:
            self.visit(value)

    # -- expressions --------------------------------------------------
    def visit_Name(self, node: ast.Name):
        if not isinstance(node.ctx, ast.Load):
            _decline(f"unsupported-syntax:{type(node.ctx).__name__}", node)
        nm = node.id
        if nm in self.locals or nm in self.c.consts or nm in self.c.np_aliases:
            return
        if nm in self.mutable:
            raise LiftDeclined(
                f"mutable-closure:{nm}", node="Name",
                lineno=node.lineno,
                detail=f"{nm!r} is mutable captured state — the callback "
                       "re-reads it per block (stale-closure hazard)")
        _decline("unsupported-syntax:Name", node,
                 detail=f"unknown or non-scalar reference {nm!r}")

    def visit_Constant(self, node: ast.Constant):
        if not isinstance(node.value, _SCALAR_TYPES):
            _decline("unsupported-syntax:Constant", node,
                     detail=f"{type(node.value).__name__} literal")

    def visit_BinOp(self, node: ast.BinOp):
        if type(node.op) not in _ALLOWED_BINOPS:
            _decline(f"unsupported-syntax:{type(node.op).__name__}", node)
        self.visit(node.left)
        self.visit(node.right)

    def visit_UnaryOp(self, node: ast.UnaryOp):
        if isinstance(node.op, ast.Not):
            _decline("data-dependent-branch", node,
                     detail="`not` takes array truthiness; use "
                            "np.logical_not")
        if type(node.op) not in _ALLOWED_UNARY:
            _decline(f"unsupported-syntax:{type(node.op).__name__}", node)
        self.visit(node.operand)

    def visit_Compare(self, node: ast.Compare):
        if len(node.ops) != 1:
            _decline("unsupported-syntax:chained-comparison", node)
        if not isinstance(node.ops[0], _ALLOWED_CMPOPS):
            _decline(f"unsupported-syntax:{type(node.ops[0]).__name__}",
                     node)
        self.visit(node.left)
        self.visit(node.comparators[0])

    def visit_BoolOp(self, node: ast.BoolOp):
        _decline("data-dependent-branch", node,
                 detail="`and`/`or` take array truthiness; use "
                        "np.logical_and / np.logical_or")

    def visit_IfExp(self, node: ast.IfExp):
        _decline("data-dependent-branch", node,
                 detail="conditional expression branches on data; use "
                        "np.where")

    def visit_Call(self, node: ast.Call):
        # classify the callee first so e.g. np.random.rand(*shape)
        # declines as unsupported-call:np.random.rand, not as the
        # incidental Starred argument
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in self.c.np_aliases:
            # np.<name>(...)
            if f.attr in ELEMENTWISE_OPS:
                pass
            elif f.attr in REDUCTION_OPS:
                self.c.has_reduction = True
            else:
                raise LiftDeclined(
                    f"unsupported-call:np.{f.attr}", node="Call",
                    lineno=node.lineno)
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Attribute) \
                and isinstance(f.value.value, ast.Name) \
                and f.value.value.id in self.c.np_aliases:
            # np.random.rand(...) and friends: submodule calls never lift
            raise LiftDeclined(
                f"unsupported-call:np.{f.value.attr}.{f.attr}",
                node="Call", lineno=node.lineno)
        elif isinstance(f, ast.Attribute):
            # x.sum() method spelling: receiver must itself validate
            if f.attr not in ARRAY_METHODS:
                raise LiftDeclined(
                    f"unsupported-call:.{f.attr}", node="Call",
                    lineno=node.lineno)
            if f.attr != "clip":
                self.c.has_reduction = True
            self.visit(f.value)
        elif isinstance(f, ast.Name):
            if f.id == "abs":
                pass  # builtin abs maps to np.abs
            else:
                raise LiftDeclined(
                    f"unsupported-call:{f.id}", node="Call",
                    lineno=node.lineno)
        else:
            _decline("unsupported-syntax:Call", node)
        if node.keywords:
            _decline("unsupported-syntax:keyword-argument", node)
        for a in node.args:
            if isinstance(a, ast.Starred):
                _decline("unsupported-syntax:Starred", a)
            self.visit(a)

    def visit_Subscript(self, node: ast.Subscript):
        # indexing into a mutable closure (state[0], lut[k]) is the
        # stale-closure hazard itself — name it over the generic
        # Subscript decline
        if isinstance(node.value, ast.Name) and node.value.id in self.mutable:
            raise LiftDeclined(
                f"mutable-closure:{node.value.id}", node="Subscript",
                lineno=node.lineno,
                detail=f"{node.value.id!r} is mutable captured state — "
                       "the callback re-reads it per block "
                       "(stale-closure hazard)")
        _decline("unsupported-syntax:Subscript", node)

    def visit_Attribute(self, node: ast.Attribute):
        # bare attribute reads (x.T, x.shape, np.pi as value) — only
        # np.<scalar constant> style is conceivable but keep the door
        # closed until something needs it
        _decline("unsupported-syntax:Attribute", node)

    def generic_visit(self, node: ast.AST):
        if isinstance(node, (ast.Subscript, ast.Slice, ast.Lambda,
                             ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp, ast.Await, ast.Yield,
                             ast.YieldFrom, ast.NamedExpr, ast.JoinedStr,
                             ast.For, ast.While, ast.With, ast.Try,
                             ast.Global, ast.Nonlocal, ast.Raise,
                             ast.Assert, ast.Delete, ast.Import,
                             ast.ImportFrom, ast.ClassDef)):
            if isinstance(node, (ast.For, ast.While)):
                _decline(f"unsupported-syntax:{type(node).__name__}", node,
                         detail="loops do not lift")
            _decline(f"unsupported-syntax:{type(node).__name__}", node)
        super().generic_visit(node)


def inspect_udf(fn) -> LiftCandidate:
    """Validate ``fn``'s source against the lifting allowlist.

    Returns a :class:`LiftCandidate` on success; raises
    :class:`LiftDeclined` with a taxonomy reason + offending node
    otherwise. Purely static — never calls ``fn``.
    """
    src, tree = _get_source_tree(fn)
    np_aliases, consts, mutable = _closure_env(fn)

    if isinstance(tree, ast.Lambda):
        args = tree.args
        body_stmts: List[ast.stmt] = [ast.Return(value=tree.body)]
        ast.copy_location(body_stmts[0], tree.body)
        ast.fix_missing_locations(body_stmts[0])
    else:
        if tree.decorator_list:
            _decline("unsupported-syntax:decorator", tree)
        args = tree.args
        body_stmts = tree.body

    if args.vararg or args.kwarg or args.kwonlyargs or args.posonlyargs \
            or args.defaults or args.kw_defaults:
        _decline("unsupported-syntax:arguments", tree,
                 detail="only plain positional column-ref parameters lift")
    params = [a.arg for a in args.args]
    if not params:
        _decline("unsupported-syntax:arguments", tree,
                 detail="UDF takes no column inputs")

    cand = LiftCandidate(
        fn=fn,
        name=getattr(fn, "__name__", "<udf>"),
        source=src,
        params=params,
        consts=consts,
        np_aliases=np_aliases or {"np", "numpy"},
        body=[],
        mutable_closures=list(mutable),
    )
    v = _Validator(cand, mutable)
    cand.body = v.check_body(list(body_stmts))
    return cand


def detect_mutable_closures(fn) -> List[str]:
    """Names of mutable objects (list/dict/set/ndarray/…) the UDF closes
    over — the stale-closure hazard surface, reported even when the
    static validator declines for an earlier reason."""
    try:
        _, _, mutable = _closure_env(fn)
    except Exception:  # pragma: no cover - exotic callables
        return []
    return list(mutable)
