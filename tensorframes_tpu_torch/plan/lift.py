"""Verified UDF lifting: synthesis + bounded bit-exact equivalence.

The reference package's ``plan/lift.py``, over torch. The static
front-end (:mod:`tensorframes_tpu_torch.analysis.lifting`) validates a
numpy UDF's AST against a closed allowlist; this module turns a validated
candidate into a torch Program and *proves* the swap safe, on the device
the stage will run on, before it happens:

* **Synthesis** walks the candidate AST with a numpy-as-dtype-oracle
  evaluator: each op's result dtype is computed by applying the *real*
  numpy op to zero-size probe arrays (python scalars stay raw so weak
  promotion matches), every operand is cast explicitly to it (a python
  scalar becomes a 0-d tensor on the feed's device, holding numpy's
  cast of it), and the torch counterpart from an explicit name table
  (:data:`_TORCH_OPS`) is applied — reproducing numpy/NEP50 promotion
  (int÷int→f64, ``np.sum(int32)``→int64, f32+pyfloat→f32) without
  hand-derived rules.
* **Verification** runs the original numpy function on the host and the
  synthesized function eagerly on the stage's device over the
  reference's bounded corpus — dtype-boundary values (±0.0, finfo/iinfo
  extremes, ±inf, NaN, the sign-lattice hazard values), block sizes
  {0,1,2,5,8,13} — plus one seeded random block per input, drawn over
  the dtype's normal range and large enough to take torch's vectorized
  paths, and demands *bit exactness*: same dtype, same shape, same bytes.
  Anything less stays a host stage. A decision is per device: what
  verifies on the CPU says nothing of the card, and the reverse.
* **NaN** is written as one canonical quiet NaN per dtype by both paths:
  the lifted program and the host stage alike. The card's f32 arithmetic
  returns its own canonical NaN (even through negation and abs) and its
  f64 negation keeps a NaN's sign, so numpy's NaN payloads cannot be
  reproduced there; NaN-ness is. With both paths canonical, a lifted
  stage and its host stage stay equal bit for bit.
* **Policy declines** draw the reference's exactness line: float
  ``sum``/``mean``/``prod`` never lift (numpy's pairwise accumulation
  order is not bit-stable against a device reduce), neither does 64-bit
  int ``mean`` (numpy computes it in f64, where values past 2^53 round
  order-sensitively), nor float ``min``/``max`` (a signed-zero tie at the
  extremum resolves position-dependently in numpy itself); int/bool
  min/max/sum are exact (modular for sum), so those lift. Elementwise
  ``np.minimum``/``np.maximum`` stay liftable.

A lifted Program reaches no host callback, so it enters the fusion,
pushdown and cost machinery unchanged — a map→UDF→aggregate chain runs
as one program a block and its aggregate reaches the segment kernel.
Every decision (lift or decline, with the taxonomy reason and offending
AST node) lands in a bounded log read by ``--lift-report`` and the
TFG112 rule, and in the ``tftpu_lift_total`` counter family.
"""

from __future__ import annotations

import ast
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.lifting import LiftCandidate, LiftDeclined, inspect_udf
from ..config import get_config
from ..observability.metrics import counter as _counter
from ..utils import get_logger

logger = get_logger(__name__)

__all__ = [
    "build_udf_program",
    "fingerprint_token",
    "lift_log",
    "clear_lift_log",
    "lift_report",
    "LIFT_FORMAT_VERSION",
]

#: Bumped whenever synthesis or verification semantics change — joins the
#: compile-cache fingerprint env slot so keys recorded under different
#: lifting rules never collide.
LIFT_FORMAT_VERSION = 1

# Registered at import so expositions always carry the family (a process
# that never lifted reads 0 — the series does not vanish).
_LIFT_EVENTS = {
    outcome: _counter(
        "tftpu_lift_total",
        "Verified-lift decisions on captured numpy UDFs, by outcome",
        labels={"outcome": outcome},
    )
    for outcome in ("lifted", "declined")
}

#: Bounded decision log: one dict per capture-time lift decision
#: ({"udf", "lifted", "reason", "node", "lineno", "outputs", "wall_s"}).
#: Read by ``--lift-report`` and the TFG112 rule.
_LIFT_LOG: deque = deque(maxlen=512)
_LIFT_LOCK = threading.Lock()  # lint: guarded

#: Block sizes of the verification corpus; 8 and 13 straddle numpy's
#: pairwise-summation unroll width so accumulation-order divergence is
#: actually exercised, 0/1/2 cover the empty/degenerate edges.
_CORPUS_SIZES = (0, 1, 2, 5, 8, 13)

#: Distinct cyclic fill phases per corpus size (each input additionally
#: offsets by its own index, so multi-input UDFs see unaligned values).
_CORPUS_PHASES = (0, 11)

#: Values in the seeded random block of each input of a dtype wider than
#: 16 bits (the port's stratum: the boundary corpus is too small to reach
#: torch's vectorized loops, whose results can differ from numpy's, e.g.
#: the CPU's f32 and f64 ``sqrt``; narrower dtypes are verified on every
#: value). Rows are this over the product of trailing dims.
_RANDOM_VALUES = 4099
_RANDOM_SEED = 0x11F7

#: numpy dtype -> torch dtype of every value the synthesizer may hold.
_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_NP_OF_TORCH = {v: k for k, v in _TORCH_DTYPES.items()}

#: Canonical quiet NaN of each float dtype (numpy's ``nan`` bits), as
#: (bits, the integer dtype of the same width).
_CANONICAL_NAN = {
    np.dtype(np.float16): (0x7E00, np.int16),
    np.dtype(np.float32): (0x7FC00000, np.int32),
    np.dtype(np.float64): (0x7FF8000000000000, np.int64),
}


def fingerprint_token() -> dict:
    """The lifting contribution to the compile-cache environment
    fingerprint: a config flip or synthesis-rule bump must miss."""
    return {
        "enabled": bool(get_config().udf_lifting),
        "version": LIFT_FORMAT_VERSION,
    }


def _record(udf_name: str, lifted: bool, reason: Optional[str],
            node: Optional[str], lineno: Optional[int],
            outputs: Sequence[str], wall_s: float,
            detail: str = "") -> dict:
    rec = {
        "udf": udf_name,
        "lifted": lifted,
        "reason": reason,
        "node": node,
        "lineno": lineno,
        "outputs": list(outputs),
        "wall_s": round(wall_s, 6),
        "detail": detail,
    }
    _LIFT_EVENTS["lifted" if lifted else "declined"].inc()
    with _LIFT_LOCK:
        _LIFT_LOG.append(rec)
    return rec


def lift_log() -> List[dict]:
    """Snapshot of the bounded lift-decision log, oldest first."""
    with _LIFT_LOCK:
        return [dict(r) for r in _LIFT_LOG]


def clear_lift_log() -> None:
    with _LIFT_LOCK:
        _LIFT_LOG.clear()


def lift_report() -> str:
    """The ``--lift-report`` payload: one line per decision."""
    rows = lift_log()
    if not rows:
        return "lift-report: no UDF capture decisions recorded"
    lines = [f"lift-report: {len(rows)} decision(s)"]
    for r in rows:
        if r["lifted"]:
            lines.append(
                f"  LIFTED   {r['udf']} -> {', '.join(r['outputs']) or '?'}"
                f" (verify {r['wall_s']:.3f}s)"
            )
        else:
            at = f" at {r['node']}" if r["node"] else ""
            ln = f" line {r['lineno']}" if r["lineno"] else ""
            lines.append(
                f"  DECLINED {r['udf']}: {r['reason']}{at}{ln}"
                + (f" — {r['detail']}" if r["detail"] else "")
            )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Output naming and NaN shared by the host stage and the synthesizer
# ---------------------------------------------------------------------------

def as_output_dict(res, fn_name: str) -> Dict[str, object]:
    """The same naming rule ``program_from_function`` applies: dicts pass
    through, tuples become ``<name>_<i>``, singles take the UDF name."""
    if isinstance(res, dict):
        return dict(res)
    if isinstance(res, (tuple, list)):
        return {f"{fn_name}_{i}": v for i, v in enumerate(res)}
    return {fn_name: res}


def canonical_nan_numpy(a: np.ndarray) -> np.ndarray:
    """``a`` with every NaN written as its dtype's canonical quiet NaN
    (a new array when any NaN is present; ``a`` itself otherwise)."""
    canon = _CANONICAL_NAN.get(a.dtype)
    if canon is None:
        return a
    mask = np.isnan(a)
    if not mask.any():
        return a
    return np.where(mask, np.array(canon[0], dtype=canon[1]).view(a.dtype), a)


def _canonical_nan_torch(t: torch.Tensor) -> torch.Tensor:
    """The device side of :func:`canonical_nan_numpy`: an integer-typed
    0-d constant viewed as the float dtype, selected where ``t`` is NaN
    (a select moves bits; no float op touches the constant)."""
    np_dtype = _NP_OF_TORCH.get(t.dtype)
    canon = _CANONICAL_NAN.get(np_dtype) if np_dtype is not None else None
    if canon is None:
        return t
    bits = torch.full((), canon[0], dtype=_TORCH_DTYPES[np.dtype(canon[1])],
                      device=t.device).view(t.dtype)
    return torch.where(torch.isnan(t), bits, t)



# ---------------------------------------------------------------------------
# Synthesis: numpy-as-dtype-oracle AST evaluation
# ---------------------------------------------------------------------------

class _V:
    """An evaluated value: the torch side plus a zero-size numpy probe
    that carries exact numpy promotion semantics. Python scalar
    constants keep their raw value on both sides (weak typing)."""

    __slots__ = ("t", "probe", "is_scalar")

    def __init__(self, t, probe, is_scalar=False):
        self.t = t
        self.probe = probe
        self.is_scalar = is_scalar


_PY_BINOPS = {
    ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b,
    ast.FloorDiv: lambda a, b: a // b, ast.Mod: lambda a, b: a % b,
    ast.Pow: lambda a, b: a ** b,
}
_NP_BINOPS = {
    ast.Add: "add", ast.Sub: "subtract", ast.Mult: "multiply",
    ast.Div: "true_divide", ast.FloorDiv: "floor_divide",
    ast.Mod: "mod", ast.Pow: "power",
}
_CMP_NP = {
    ast.Eq: "equal", ast.NotEq: "not_equal", ast.Lt: "less",
    ast.LtE: "less_equal", ast.Gt: "greater", ast.GtE: "greater_equal",
}
#: ops whose result is bool but whose operands are used as-is
_PREDICATES = {
    "isnan", "isinf", "isfinite",
    "logical_and", "logical_or", "logical_not", "logical_xor",
}
_REDUCTIONS = {"sum", "mean", "prod", "min", "max", "amin", "amax"}
_METHOD_TO_NP = {"sum": "sum", "mean": "mean", "prod": "prod",
                 "min": "min", "max": "max", "clip": "clip"}

#: numpy name -> the torch function computing it. Explicit: several names
#: differ (``arcsin``/``asin``, ``true_divide``/``div``, ``mod``/
#: ``remainder``, ``rint``/``round`` — both round half to even —,
#: ``clip``/``clamp``, ``invert``/``bitwise_not``). Full reductions
#: (``amin``, ``sum``, ...) reduce every dim to a 0-d tensor.
_TORCH_OPS: Dict[str, Callable] = {
    "abs": torch.abs, "absolute": torch.abs,
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.div, "true_divide": torch.div,
    "floor_divide": torch.floor_divide,
    "mod": torch.remainder, "remainder": torch.remainder,
    "power": torch.pow,
    "negative": torch.neg, "positive": torch.positive,
    "invert": torch.bitwise_not, "sign": torch.sign,
    "exp": torch.exp, "expm1": torch.expm1, "exp2": torch.exp2,
    "log": torch.log, "log1p": torch.log1p, "log2": torch.log2,
    "log10": torch.log10,
    "sqrt": torch.sqrt, "square": torch.square,
    "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
    "rint": torch.round,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "tanh": torch.tanh, "sinh": torch.sinh, "cosh": torch.cosh,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "clip": torch.clamp,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_not": torch.logical_not, "logical_xor": torch.logical_xor,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "equal": torch.eq, "not_equal": torch.ne, "less": torch.lt,
    "less_equal": torch.le, "greater": torch.gt, "greater_equal": torch.ge,
    "min": torch.amin, "amin": torch.amin, "max": torch.amax,
    "amax": torch.amax, "sum": torch.sum, "prod": torch.prod,
}


def _np_op(name: str):
    fn = getattr(np, name, None)
    if fn is None:  # pragma: no cover - allowlist and numpy agree
        raise LiftDeclined(f"unsupported-call:np.{name}", node="Call")
    return fn


def _torch_op(name: str):
    fn = _TORCH_OPS.get(name)
    if fn is None:
        raise LiftDeclined(f"unsupported-call:np.{name}", node="Call")
    return fn


class _Synthesizer:
    """Evaluate a validated candidate body against torch feeds, with the
    numpy dtype oracle deciding every cast. Raises LiftDeclined for the
    dtype-dependent policy declines (float reductions) the static
    front-end cannot see. Never reads a value back from the device: it
    runs as well on fake and meta tensors."""

    def __init__(self, cand: LiftCandidate, probes: Dict[str, np.ndarray],
                 device):
        self.c = cand
        self.probes = probes  # param -> zero-size np array
        self.device = device  # where scalar constants are placed

    # -- coercion helpers ---------------------------------------------
    def _cast(self, v: _V, dtype):
        td = _TORCH_DTYPES[np.dtype(dtype)]
        if v.is_scalar:
            # numpy's own cast of the scalar, placed on the device as a
            # 0-d tensor (a CPU scalar would let CUDA's true division
            # take its reciprocal route)
            val = np.asarray(v.probe, dtype=dtype)[()].item()
            return torch.full((), val, dtype=td, device=self.device)
        return v.t if v.t.dtype == td else v.t.to(td)

    def _tensor(self, v: _V):
        """A value as a tensor of its own numpy dtype (predicates)."""
        if not v.is_scalar:
            return v.t
        return self._cast(v, np.asarray(v.probe).dtype)

    def _apply_oracle(self, np_name: str, vals: List[_V],
                      node: ast.AST) -> _V:
        """Elementwise op: probe numpy for the result dtype, cast every
        operand to it, run the torch counterpart, pin the result dtype."""
        with np.errstate(all="ignore"):
            probe_res = _np_op(np_name)(*[v.probe for v in vals])
        if all(v.is_scalar for v in vals):
            # constant folding on the host: real execution would run this
            # in numpy before the arrays ever see it
            return _V(probe_res, probe_res, is_scalar=True)
        dt_res = np.asarray(probe_res).dtype
        self._check_dtype(dt_res, node)
        targs = [self._cast(v, dt_res) for v in vals]
        out = _torch_op(np_name)(*targs)
        if out.dtype != _TORCH_DTYPES[dt_res]:
            out = out.to(_TORCH_DTYPES[dt_res])
        return _V(out, np.zeros(np.asarray(probe_res).shape
                                if np.asarray(probe_res).ndim else (),
                                dtype=dt_res))

    def _apply_predicate(self, np_name: str, vals: List[_V],
                         node: ast.AST) -> _V:
        with np.errstate(all="ignore"):
            probe_res = _np_op(np_name)(*[v.probe for v in vals])
        if all(v.is_scalar for v in vals):
            return _V(probe_res, probe_res, is_scalar=True)
        out = _torch_op(np_name)(*[self._tensor(v) for v in vals])
        return _V(out, np.zeros(np.asarray(probe_res).shape, dtype=bool))

    def _apply_compare(self, np_name: str, a: _V, b: _V,
                       node: ast.AST) -> _V:
        if a.is_scalar and b.is_scalar:
            with np.errstate(all="ignore"):
                r = _np_op(np_name)(a.probe, b.probe)
            return _V(r, r, is_scalar=True)
        # numpy compares in the common operand type
        common = np.result_type(a.probe, b.probe)
        self._check_dtype(common, node)
        with np.errstate(all="ignore"):
            probe_res = _np_op(np_name)(a.probe, b.probe)
        out = _torch_op(np_name)(self._cast(a, common), self._cast(b, common))
        return _V(out, np.zeros(np.asarray(probe_res).shape,
                                dtype=np.asarray(probe_res).dtype))

    def _apply_reduction(self, np_name: str, v: _V, node: ast.AST) -> _V:
        if v.is_scalar:
            raise LiftDeclined("unsupported-syntax:scalar-reduction",
                               node="Call",
                               lineno=getattr(node, "lineno", None))
        in_dtype = v.probe.dtype
        canon = {"amin": "min", "amax": "max"}.get(np_name, np_name)
        if canon in ("sum", "mean", "prod") and np.issubdtype(
            in_dtype, np.floating
        ):
            raise LiftDeclined(
                "float-reduction", node="Call",
                lineno=getattr(node, "lineno", None),
                detail=f"np.{canon} over {in_dtype} accumulates in an "
                       "order numpy (pairwise) and a device reduce do not "
                       "share — not bit-stable, stays a callback (same "
                       "exactness line as the optimizer's reassoc_safe "
                       "gate)")
        if canon in ("min", "max") and np.issubdtype(
            in_dtype, np.floating
        ):
            # measured: np.min([+0.,-0.]) returns -0 but
            # np.min([-0.,+0.]) returns +0 (position-dependent) — a
            # signed-zero tie at the extremum makes the float result
            # order-sensitive on numpy's OWN side, so no order-free
            # synthesis can match
            raise LiftDeclined(
                "float-reduction", node="Call",
                lineno=getattr(node, "lineno", None),
                detail=f"np.{canon} over {in_dtype}: signed-zero ties "
                       "at the extremum resolve position-dependently in "
                       "numpy and order-free on the device — not "
                       "bit-stable, stays a callback")
        if canon in ("min", "max"):
            out = _torch_op(canon)(v.t)
            dt_res = in_dtype
        else:
            # sum/prod accumulate in the numpy result dtype (int64 for
            # int/bool input — modular, order-free); mean accumulates
            # exactly in f64 for int inputs small enough to stay < 2^53
            with np.errstate(all="ignore"):
                probe_res = _np_op(canon)(np.zeros((0,), in_dtype)) \
                    if canon != "mean" else np.float64(0)
            if canon == "mean" and np.dtype(in_dtype).itemsize >= 8:
                # int64 mean is computed in f64 on both sides, but
                # values past 2^53 are inexact there and numpy's
                # pairwise order then rounds differently from a device
                # reduce — same exactness line as float reductions
                raise LiftDeclined(
                    "float-reduction", node="Call",
                    lineno=getattr(node, "lineno", None),
                    detail=f"np.mean over {in_dtype} accumulates in "
                           "float64, inexact past 2^53 and therefore "
                           "order-sensitive — not bit-stable, stays a "
                           "callback")
            if canon == "mean":
                # numpy divides the exact f64 sum by the count: a true
                # division by a device tensor, never a product with the
                # reciprocal
                dt_res = np.mean(np.zeros((1,), in_dtype)).dtype
                self._check_dtype(dt_res, node)
                td = _TORCH_DTYPES[dt_res]
                total = torch.sum(v.t.to(td))
                count = torch.full((), float(v.t.numel()), dtype=td,
                                   device=self.device)
                out = total / count
            else:
                dt_res = np.asarray(probe_res).dtype
                self._check_dtype(dt_res, node)
                out = _torch_op(canon)(v.t.to(_TORCH_DTYPES[dt_res]))
            if out.dtype != _TORCH_DTYPES[dt_res]:
                out = out.to(_TORCH_DTYPES[dt_res])
        return _V(out, np.zeros((), dtype=dt_res))

    def _check_dtype(self, dtype, node) -> None:
        d = np.dtype(dtype)
        if d not in _TORCH_DTYPES:
            # the reference also lowers uint16/32/64; torch's support for
            # those is partial, and no frame column can hold them here
            raise LiftDeclined(
                "unsupported-dtype", node=type(node).__name__,
                lineno=getattr(node, "lineno", None),
                detail=f"{d} has no verified lowering")

    # -- evaluation ---------------------------------------------------
    def run(self, feeds) -> Dict[str, object]:
        env: Dict[str, _V] = {}
        for p in self.c.params:
            env[p] = _V(feeds[p], self.probes[p])
        for name, val in self.c.consts.items():
            env[name] = _V(val, val, is_scalar=True)
        ret: Optional[ast.expr] = None
        for st in self.c.body:
            if isinstance(st, ast.Assign):
                env[st.targets[0].id] = self._eval(st.value, env)
            else:  # Return — validator guarantees it is last
                ret = st.value
        if ret is None:  # pragma: no cover - the validator demands a Return
            raise LiftDeclined("unsupported-syntax:no-return")
        return self._outputs(ret, env)

    def _out(self, v: _V):
        t = self._tensor(v)
        return _canonical_nan_torch(t)

    def _outputs(self, value: ast.expr, env) -> Dict[str, object]:
        if isinstance(value, ast.Dict):
            return {k.value: self._out(self._eval(v, env))
                    for k, v in zip(value.keys, value.values)}
        if isinstance(value, (ast.Tuple, ast.List)):
            return {f"{self.c.name}_{i}": self._out(self._eval(v, env))
                    for i, v in enumerate(value.elts)}
        return {self.c.name: self._out(self._eval(value, env))}

    def _eval(self, node: ast.expr, env: Dict[str, _V]) -> _V:
        if isinstance(node, ast.Name):
            return env[node.id]
        if isinstance(node, ast.Constant):
            return _V(node.value, node.value, is_scalar=True)
        if isinstance(node, ast.BinOp):
            a = self._eval(node.left, env)
            b = self._eval(node.right, env)
            if a.is_scalar and b.is_scalar:
                # python evaluates scalar-scalar before numpy sees it:
                # stay weak by using the python operator
                r = _PY_BINOPS[type(node.op)](a.probe, b.probe)
                return _V(r, r, is_scalar=True)
            return self._apply_oracle(_NP_BINOPS[type(node.op)], [a, b],
                                      node)
        if isinstance(node, ast.UnaryOp):
            v = self._eval(node.operand, env)
            if v.is_scalar:
                r = (-v.probe if isinstance(node.op, ast.USub)
                     else +v.probe if isinstance(node.op, ast.UAdd)
                     else ~v.probe)
                return _V(r, r, is_scalar=True)
            name = {"USub": "negative", "UAdd": "positive",
                    "Invert": "invert"}[type(node.op).__name__]
            return self._apply_oracle(name, [v], node)
        if isinstance(node, ast.Compare):
            a = self._eval(node.left, env)
            b = self._eval(node.comparators[0], env)
            return self._apply_compare(_CMP_NP[type(node.ops[0])], a, b,
                                       node)
        if isinstance(node, ast.Call):
            return self._call(node, env)
        raise LiftDeclined(f"unsupported-syntax:{type(node).__name__}",
                           node=type(node).__name__,
                           lineno=getattr(node, "lineno", None))

    def _call(self, node: ast.Call, env) -> _V:
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in self.c.np_aliases:
            name = f.attr
            args = [self._eval(a, env) for a in node.args]
        elif isinstance(f, ast.Attribute):
            # method spelling x.sum() — receiver first, then args
            name = _METHOD_TO_NP[f.attr]
            args = [self._eval(f.value, env)] + [
                self._eval(a, env) for a in node.args]
        elif isinstance(f, ast.Name) and f.id == "abs":
            name = "abs"
            args = [self._eval(a, env) for a in node.args]
        else:  # pragma: no cover - validator blocks this
            raise LiftDeclined("unsupported-syntax:Call", node="Call",
                               lineno=node.lineno)
        canon = {"absolute": "abs"}.get(name, name)
        if canon in _REDUCTIONS:
            if len(args) != 1:
                raise LiftDeclined(
                    "unsupported-syntax:reduction-arguments", node="Call",
                    lineno=node.lineno,
                    detail="only full single-array reductions lift")
            return self._apply_reduction(canon, args[0], node)
        if canon in _PREDICATES:
            return self._apply_predicate(canon, args, node)
        if canon == "where" and len(args) == 3:
            cond, x, y = args
            with np.errstate(all="ignore"):
                probe_res = np.where(cond.probe, x.probe, y.probe)
            dt_res = probe_res.dtype
            self._check_dtype(dt_res, node)
            if cond.is_scalar:
                c = torch.full((), bool(cond.probe), dtype=torch.bool,
                               device=self.device)
            else:
                c = cond.t if cond.t.dtype == torch.bool \
                    else cond.t.to(torch.bool)
            out = torch.where(c, self._cast(x, dt_res), self._cast(y, dt_res))
            return _V(out, np.zeros(probe_res.shape, dtype=dt_res))
        return self._apply_oracle(canon, args, node)


# ---------------------------------------------------------------------------
# Verification corpus
# ---------------------------------------------------------------------------

def _boundary_pool(dtype: np.dtype) -> np.ndarray:
    """Deterministic 1-D pool of hazard values for one dtype: ±0.0,
    ±1, finfo/iinfo extremes, ±inf, NaN, and the sign-lattice hazard
    band (negatives / signed zeros / tiny positives). The reference's
    pool, value for value."""
    d = np.dtype(dtype)
    if d == np.bool_:
        return np.array([True, False, True, True, False], dtype=d)
    if np.issubdtype(d, np.integer):
        info = np.iinfo(d)
        vals = [0, 1, 2, 3, 5, 7, 100]
        for v in (-1, -2, -7, -100):
            if v >= info.min:
                vals.append(v)
        vals += [info.min, info.max, info.min + 1, info.max - 1]
        vals = [v for v in vals if info.min <= v <= info.max]
        return np.array(vals, dtype=d)
    info = np.finfo(d)
    # The verified envelope is the IEEE NORMAL range, as the
    # reference's: subnormal inputs are absent. ±tiny (the smallest
    # normal) stays in the pool to pin the underflow boundary itself.
    vals = [
        0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.5, 7.0, 3.140625,
        float(info.max), float(-info.max), float(info.tiny),
        float(-info.tiny), float(info.eps), float(1.0 + info.eps),
        # sign-lattice hazard band: values whose sign/zero classification
        # diverges across naive rewrites
        -3.5, -1e-30, 1e-30, -1e-7, 1e-7,
        float("inf"), float("-inf"), float("nan"),
    ]
    with np.errstate(all="ignore"):
        arr = np.array(vals, dtype=d)
    # narrow dtypes (f16) turn some hazard values subnormal on
    # conversion — drop those, keep zeros/inf/NaN and normals
    keep = ~np.isfinite(arr) | (arr == 0) | (np.abs(arr) >= info.tiny)
    return arr[keep]


def _corpus_block(pool: np.ndarray, n: int, trailing: Tuple[int, ...],
                  phase: int) -> np.ndarray:
    """Cyclic fill of a (n, *trailing) block from the pool, rolled by
    ``phase`` so multiple inputs never align."""
    total = n
    for t in trailing:
        total *= t
    if total == 0:
        return np.zeros((n,) + trailing, dtype=pool.dtype)
    idx = (np.arange(total) + phase) % len(pool)
    return pool[idx].reshape((n,) + trailing)


def _random_block(dtype: np.dtype, trailing: Tuple[int, ...],
                  seed: int) -> np.ndarray:
    """A seeded block: for dtypes of at most 16 bits every value
    (:func:`_every_value`) in a seeded order; else about
    :data:`_RANDOM_VALUES` values, integers half uniform over the dtype's
    whole range and half rounded normals of scale 1,000, floats half
    log-uniform over the normal range (random signs and mantissas) and
    half standard normals."""
    d = np.dtype(dtype)
    per_row = int(np.prod(trailing)) if trailing else 1
    rng = np.random.default_rng(seed)
    if d.itemsize <= 2:
        # narrow dtypes: every value (f16: every zero and normal), in a
        # seeded order — a sample would miss the rare disagreement
        vals = rng.permutation(_every_value(d))
        rows = -(-len(vals) // max(per_row, 1))
        vals = np.resize(vals, rows * per_row)
        return vals.reshape((rows,) + trailing)
    rows = max(1, -(-_RANDOM_VALUES // max(per_row, 1)))
    n = rows * per_row
    if np.issubdtype(d, np.integer):
        # half over the whole range, half small (where int -> float
        # ops such as tanh or exp are not saturated)
        info = np.iinfo(d)
        half = n // 2
        small = np.clip(np.rint(rng.standard_normal(n - half) * 1000),
                        info.min, info.max).astype(d)
        vals = np.concatenate([
            rng.integers(info.min, info.max, half, dtype=d, endpoint=True),
            small])
    else:
        info = np.finfo(d)
        half = n // 2
        lo, hi = np.log2(float(info.tiny)), np.log2(float(info.max))
        mag = np.exp2(rng.uniform(lo, hi, half))
        wide = np.copysign(mag, rng.integers(0, 2, half) * 2.0 - 1.0)
        with np.errstate(all="ignore"):
            vals = np.concatenate(
                [wide, rng.standard_normal(n - half)]).astype(d)
        # rounding to a narrow dtype can reach inf or a subnormal: keep
        # the stratum inside the normal range
        vals = np.where(np.isfinite(vals) & (np.abs(vals) >= info.tiny),
                        vals, d.type(1.0))
    return vals.reshape((rows,) + trailing)


def _every_value(d: np.dtype) -> np.ndarray:
    """Every value of a dtype of at most 16 bits; for f16 its zeros and
    normals (the verified envelope), as :func:`_random_block` uses them."""
    if d == np.bool_:
        return np.array([False, True])
    if np.issubdtype(d, np.integer):
        info = np.iinfo(d)
        return np.arange(int(info.min), int(info.max) + 1).astype(d)
    vals = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(d)
    keep = np.isfinite(vals) & ((vals == 0) | (np.abs(vals) >= np.finfo(d).tiny))
    return vals[keep]


def _input_shapes(spec) -> Tuple[int, ...]:
    """Concrete trailing dims of a block spec (lead dim is the corpus
    size; Unknown trailing dims probe at 3)."""
    from ..shape import Unknown

    dims = list(spec.shape.dims)[1:]  # drop the lead (block) dim
    return tuple(3 if d is Unknown or d == Unknown else int(d)
                 for d in dims)


def _host_outputs(fn, arrays, fn_name: str) -> Dict[str, np.ndarray]:
    """The numpy function's outputs on host arrays, as arrays with NaN
    canonical."""
    with np.errstate(all="ignore"):
        out = as_output_dict(fn(*arrays), fn_name)
    return {k: canonical_nan_numpy(np.asarray(v)) for k, v in out.items()}


def verify_candidate(cand: LiftCandidate, specs: Dict[str, object],
                     synth_fn: Callable, device) -> None:
    """Bounded exhaustive equivalence on ``device``: run the original
    numpy UDF on the host and the synthesized torch function eagerly on
    the device over the boundary corpus and the seeded random blocks, and
    demand bit-exact agreement (dtype + shape + bytes) on every output.
    Raises LiftDeclined('verify-mismatch' | 'probe-failure') on any
    divergence; returns silently when every case agrees."""
    from .. import dtypes as dt

    device = torch.device(device)
    sizes = [s for s in _CORPUS_SIZES if s > 0 or not cand.has_reduction]
    pools = {}
    for p in cand.params:
        spec = specs[p]
        d = np.dtype(spec.dtype.np_dtype)
        pools[p] = _boundary_pool(d)

    blocks = []
    for n in sizes:
        for phase in _CORPUS_PHASES:
            feeds_np = {}
            for i, p in enumerate(cand.params):
                trailing = _input_shapes(specs[p])
                feeds_np[p] = _corpus_block(
                    pools[p], n, trailing, phase + 5 * i + n)
            blocks.append((f"corpus block n={n}",
                           f"corpus block n={n} phase={phase}", feeds_np))
    rand = {p: _random_block(np.dtype(specs[p].dtype.np_dtype),
                             _input_shapes(specs[p]), _RANDOM_SEED + i)
            for i, p in enumerate(cand.params)}
    # inputs of several dtypes: the shorter blocks repeat cyclically
    rows = max(a.shape[0] for a in rand.values())
    rand = {p: np.resize(a, (rows,) + a.shape[1:]) for p, a in rand.items()}
    blocks.append((f"random block n={rows}", f"random block n={rows}", rand))

    for where, where_phase, feeds_np in blocks:
        try:
            ref = _host_outputs(
                cand.fn, [feeds_np[p] for p in cand.params], cand.name)
        except Exception as e:
            raise LiftDeclined(
                "probe-failure", node=None,
                detail=f"reference raised {type(e).__name__} on "
                       f"{where}: {e}")
        try:
            with torch.no_grad():
                got = synth_fn({p: dt.to_torch(feeds_np[p], device)
                                for p in cand.params})
            got = {k: dt.to_numpy(v) for k, v in got.items()}
        except LiftDeclined:
            # dtype-dependent policy declines (float-reduction,
            # unsupported-dtype) surface during synthesis — keep the
            # taxonomy reason, do not relabel as probe-failure
            raise
        except Exception as e:
            raise LiftDeclined(
                "probe-failure", node=None,
                detail=f"synthesized program raised "
                       f"{type(e).__name__} on {where}: "
                       f"{e}")
        if set(ref) != set(got):
            raise LiftDeclined(
                "verify-mismatch",
                detail=f"output names differ: {sorted(ref)} vs "
                       f"{sorted(got)}")
        for k in ref:
            r, g = ref[k], got[k]
            if r.dtype != g.dtype or r.shape != g.shape \
                    or r.tobytes() != g.tobytes():
                raise LiftDeclined(
                    "verify-mismatch",
                    detail=f"output {k!r} diverges on {where_phase}: "
                           f"reference {r.dtype}{list(r.shape)} vs "
                           f"synthesized {g.dtype}{list(g.shape)} "
                           f"(bit-exact comparison on {device.type})")


# ---------------------------------------------------------------------------
# Program construction
# ---------------------------------------------------------------------------

def _udf_params(fn, specs: Dict[str, object]) -> List[str]:
    import inspect as _inspect

    sig = _inspect.signature(fn)
    params = [p.name for p in sig.parameters.values()
              if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]
    missing = [p for p in params if p not in specs]
    if missing:
        raise ValueError(
            f"numpy_udf parameter(s) {missing} do not match any known "
            f"input; available: {sorted(specs)}")
    return params


def _is_abstract(tensors) -> bool:
    """True when the tensors carry no data: fake tensors (a
    ``FakeTensorMode`` or ``make_fx`` trace) or meta tensors."""
    from torch._guards import detect_fake_mode

    return detect_fake_mode(list(tensors)) is not None or any(
        t.device.type == "meta" for t in tensors)


def _build_callback_program(fn, params: List[str],
                            specs: Dict[str, object], fn_name: str):
    """The reference path: the UDF runs on the host once per block — the
    inputs copied to the host (the copy waits on the current stream
    only), numpy run on them, each output cast to the dtype the probes
    found, made contiguous, its NaNs canonical, and copied back to the
    inputs' device. Output shapes/dtypes are discovered by probing the
    numpy function on small ones-blocks (two probe sizes disambiguate
    batch-covariant dims); on fake or meta tensors the program returns
    empty tensors of those shapes and touches no data."""
    from .. import dtypes as dt
    from ..program import Program

    def _probe_shapes(lead_shapes):
        probe_ins = [np.ones(s, dtype=np.dtype(specs[p].dtype.np_dtype))
                     for p, s in zip(params, lead_shapes)]
        with np.errstate(all="ignore"):
            out = as_output_dict(fn(*probe_ins), fn_name)
        return {k: np.asarray(v) for k, v in out.items()}

    def _result_shapes(shapes) -> Dict[str, tuple]:
        def with_lead(n):
            return [((n,) + s[1:]) if len(s) else s for s in shapes]

        try:
            out_a = _probe_shapes(with_lead(3))
            out_b = _probe_shapes(with_lead(4))
        except Exception as e:
            raise TypeError(
                f"numpy_udf {fn_name!r} failed shape probing "
                f"({type(e).__name__}: {e}); the UDF must be total on "
                "ones-filled blocks") from e
        lead = shapes[0][0] if shapes and shapes[0] else None
        result = {}
        for k, va in out_a.items():
            vb = out_b[k]
            dims = tuple(
                (lead if (da != db and lead is not None) else da)
                for da, db in zip(va.shape, vb.shape))
            result[k] = (dims, va.dtype)
        return result

    def callback_fn(feeds):
        arrs = [feeds[p] for p in params]
        if any(torch._C._functorch.is_batchedtensor(a) for a in arrs):
            raise NotImplementedError(
                f"numpy_udf {fn_name!r} stayed a host stage, which runs "
                "once per block and cannot run under torch.func.vmap (the "
                "generic aggregate maps its program over groups); make "
                "the UDF liftable (TFG112 names why it is not) or use "
                "reduce_blocks")
        shapes = [tuple(int(d) for d in a.shape) for a in arrs]
        result = _result_shapes(shapes)
        device = arrs[0].device if arrs else torch.device("cpu")
        if _is_abstract(arrs):
            return {k: torch.empty(dims, dtype=dt.from_numpy(d).torch_dtype,
                                   device=device)
                    for k, (dims, d) in result.items()}
        host = [dt.to_numpy(a) for a in arrs]
        for h in host:
            # on the CPU the array shares the frame's block: the UDF
            # reads it, never writes it
            h.flags.writeable = False
        out = _host_outputs(fn, host, fn_name)
        res = {}
        for k, (dims, d) in result.items():
            a = np.asarray(out[k], dtype=d)
            # contiguous (torch.from_numpy refuses negative strides); a
            # 0-d output stays 0-d (ascontiguousarray returns >= 1-d)
            a = canonical_nan_numpy(np.ascontiguousarray(a).reshape(a.shape))
            if not a.flags.writeable:
                a = a.copy()
            if a.shape != dims:
                raise ValueError(
                    f"numpy_udf {fn_name!r} output {k!r} has shape "
                    f"{list(a.shape)}; its shape probes gave {list(dims)}")
            res[k] = torch.from_numpy(a).to(device)
        return res

    inputs = [specs[p] for p in params]
    return Program(callback_fn, inputs)


def _build_lifted_program(cand: LiftCandidate, params: List[str],
                          specs: Dict[str, object]):
    from ..program import Program

    probes = {
        p: np.zeros((0,) + _input_shapes(specs[p]),
                    dtype=np.dtype(specs[p].dtype.np_dtype))
        for p in params
    }

    def lifted_fn(feeds):
        device = feeds[params[0]].device if params else None
        return _Synthesizer(cand, probes, device).run(feeds)

    inputs = [specs[p] for p in params]
    return Program(lifted_fn, inputs), lifted_fn


def build_udf_program(fn, specs: Dict[str, object], *, device=None):
    """Capture a numpy UDF as a Program for ``device`` (default
    ``config.device``): lifted when synthesis verifies bit-exactly on that
    device, a counted host stage otherwise.

    ``specs`` maps input names to TensorSpecs (block shapes). The
    returned Program is fully analyzed; lifted programs carry
    ``_tftpu_lifted=True`` and ``_tftpu_has_callback=False`` (no host
    stage — fuses), host-stage programs ``_tftpu_has_callback=True``;
    both carry ``_tftpu_lift_info``, the decision record (with the
    taxonomy decline reason) that TFG112 and ``--lift-report`` surface.
    The reference's ``demotion-active`` decline has no counterpart: the
    port has no x64 demotion.
    """
    from ..config import resolve_device
    from ..program import analyze_program

    device = resolve_device(device)
    fn_name = getattr(fn, "__name__", "udf")
    if fn_name == "<lambda>":
        fn_name = "udf"
    params = _udf_params(fn, specs)
    cfg = get_config()

    t0 = time.perf_counter()
    info: Optional[dict] = None
    lifted_program = None
    if not cfg.udf_lifting:
        info = _record(fn_name, False, "lifting-disabled", None, None,
                       [], time.perf_counter() - t0,
                       detail="config.udf_lifting is off (TFTPU_LIFT=0)")
    else:
        try:
            cand = inspect_udf(fn)
            program, lifted_fn = _build_lifted_program(
                cand, params, specs)
            verify_candidate(cand, specs, lifted_fn, device)
            lifted_program = analyze_program(program, device=device)
            info = _record(
                fn_name, True, None, None, None,
                [o.name for o in lifted_program.outputs],
                time.perf_counter() - t0)
        except LiftDeclined as d:
            info = _record(fn_name, False, d.reason, d.node, d.lineno,
                           [], time.perf_counter() - t0, detail=d.detail)
        except Exception as e:  # pragma: no cover - synthesis bug guard
            logger.warning("lift synthesis failed unexpectedly: %s", e)
            info = _record(fn_name, False, "probe-failure", None, None,
                           [], time.perf_counter() - t0,
                           detail=f"{type(e).__name__}: {e}")

    if lifted_program is not None:
        lifted_program._tftpu_lifted = True
        lifted_program._tftpu_has_callback = False
        lifted_program._tftpu_lift_info = info
        return lifted_program

    program = _build_callback_program(fn, params, specs, fn_name)
    program = analyze_program(program, device=device)
    program._tftpu_has_callback = True
    program._tftpu_lift_info = info
    return program
