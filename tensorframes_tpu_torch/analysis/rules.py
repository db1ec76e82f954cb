"""The rule catalog: pure functions from a captured-program context to
:class:`~tensorframes_tpu_torch.analysis.diagnostics.Diagnostic` lists.

The reference package's ``analysis/rules.py``, over the program's FX
graph of aten ops (:func:`~tensorframes_tpu_torch.program.capture_graph`,
``make_fx`` under ``FakeTensorMode``) where the reference walks jaxpr
equations. A graph site is ``node#<i>:<aten op>``, ``i`` counting the
graph's op nodes in order.

* **TFG101 recompile-storm** — unknown dims the lead-dim bucket ladder
  (:func:`tensorframes_tpu_torch.ops.executor.bucket_table`) cannot
  bound, and frames presenting ≥3 distinct block shapes.
* **TFG102 f64-leak** — float64 creeping into a sub-64-bit program (a
  captured float64 constant, an op emitting float64 from narrower
  operands). ``info``: the port has no x64 demotion boundary, so the
  reference's ``warn`` (under demotion) does not arise.
* **TFG103 unused-input** — placeholders no output reads still pay
  validation, marshalling and the host→device copy per block.
* **TFG104 donation-alias** — a feed kept as an output column under its
  own name; always ``error``, the reference's default severity. The
  port donates no input and has no donation switch: the finding marks
  a program that the JAX package, which donates feeds by default, would
  run with the kept column aliasing a reused buffer.
* **TFG105 nan-hazard** — ``log``/``div``/``reciprocal``/``rsqrt``/
  ``sqrt`` whose operand is not provably positive (resp. nonnegative /
  nonzero) under a sign-lattice walk of the aten graph.
* **TFG106 hbm-budget** — static residency estimate (captured constants
  + probe-batch inputs + outputs) against the device's memory.
* **TFG107/109/110/111** — plan-chain rules (``lint_plan`` only):
  fusion barriers, unfused aggregates, missed pushdowns, forced
  materializations past the block-store budget.
* **TFG108 cache-fingerprint-unstable** — the program fingerprint
  differs across two identical rebuilds.
* **TFG112 liftable-callback** — verified-lift decisions on a chain's
  numpy UDF stages (``lint_plan`` only, from :mod:`..plan.lift`'s
  capture records): ``info`` when lifted, ``warn`` with the decline
  reason and the offending AST node otherwise.
* **TFG113/114** — serving evidence (``lint_plan`` only): prefix-cache
  ineligibility, registered queries that cannot cache or refresh
  incrementally.

Rules never dispatch: they read specs, the captured graph (node
metadata, and the values of small host constants only) and config.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..shape import Unknown
from .diagnostics import Diagnostic

__all__ = ["RuleContext", "RULES", "run_rules"]

#: Captured constants up to this many elements lying in host memory are
#: read for their sign (TFG105); larger ones and GPU tensors never are.
SMALL_CONST_NUMEL = 4096


@dataclasses.dataclass
class RuleContext:
    """Everything a rule may read. ``graph`` is the program's
    :class:`~tensorframes_tpu_torch.program.CapturedGraph` (None when the
    capture failed — spec-level rules still run); ``in_names``/
    ``in_avals`` follow the graph's placeholder order, each aval a
    ``(shape, dtype)`` pair."""

    program: object
    probe: int = 8
    graph: object = None
    in_names: Sequence[str] = ()
    in_avals: Sequence[tuple] = ()
    out_names: Sequence[str] = ()
    out_avals: Sequence[tuple] = ()
    #: True for block-mode use, False for row-mode, None when unknown.
    block_mode: Optional[bool] = None
    #: Distinct block row counts of an already-materialized frame (None
    #: when no frame context or the frame is lazy — never forces one).
    block_row_counts: Optional[Tuple[int, ...]] = None
    hbm_budget_bytes: Optional[int] = None
    #: lint_plan evidence (the reference's fields, read by the same rules)
    plan_barriers: Optional[Sequence[dict]] = None
    unfused_epilogues: Optional[Sequence[dict]] = None
    pushdown_misses: Optional[Sequence[dict]] = None
    oversized_materializations: Optional[Sequence[dict]] = None
    #: Verified-lift decisions for numpy UDF stages on a frame's plan
    #: chain (lint_plan only): the capture records attached by
    #: plan.lift.build_udf_program — dicts with ``udf``, ``lifted``,
    #: ``reason``, ``node``, ``lineno``, ``detail``; read by TFG112.
    lift_events: Optional[Sequence[dict]] = None
    prefix_cache_events: Optional[Sequence[dict]] = None
    query_cache_events: Optional[Sequence[dict]] = None
    #: A sharded program's mesh and input-name → layout: part of the
    #: fingerprint TFG108 probes (the key its dispatches carry).
    mesh: object = None
    shardings: Optional[Dict[str, object]] = None


# ---------------------------------------------------------------------------
# graph walking helpers
# ---------------------------------------------------------------------------

def _op_nodes(graph) -> list:
    return [n for n in graph.gm.graph.nodes if n.op == "call_function"]


def _op_name(node) -> str:
    target = node.target
    if target is operator.getitem:
        return "getitem"
    name = getattr(target, "_opname", None)
    if name is not None:
        return name
    return getattr(target, "__name__", str(target))


def _dtype_of(node):
    val = node.meta.get("val") if hasattr(node, "meta") else None
    if isinstance(val, (tuple, list)):
        return [getattr(v, "dtype", None) for v in val]
    return getattr(val, "dtype", None)


def _const_of(graph, node):
    """The captured tensor a ``get_attr`` node reads, else None."""
    if node.op != "get_attr":
        return None
    val = getattr(graph.gm, node.target, None)
    return val if torch.is_tensor(val) else None


def _flat_args(node) -> list:
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


def _is_node(a) -> bool:
    return isinstance(a, torch.fx.Node)


# ---------------------------------------------------------------------------
# TFG101 — recompile-storm
# ---------------------------------------------------------------------------

def _rule_recompile_storm(ctx: RuleContext) -> List[Diagnostic]:
    from ..ops.executor import bucket_table

    out: List[Diagnostic] = []
    table = bucket_table()
    head = ", ".join(str(b) for b in table[:6]) + ("…" if len(table) > 6 else "")
    for spec in ctx.program.inputs:
        dims = spec.shape.dims
        if any(d == Unknown for d in dims[1:]):
            out.append(Diagnostic(
                "TFG101", "warn",
                f"input {spec.name!r} has unknown non-leading dim(s) in "
                f"{spec.shape}: the executor buckets only the LEAD dim "
                f"(bucket table: [{head}]), so every distinct inner extent "
                "dispatches at a fresh key",
                subject=spec.name,
                fix="pin the inner dims in the placeholder/TensorSpec (or "
                    "pad the data to a fixed extent) so the dispatch keys "
                    "stay O(log n) instead of O(#shapes)",
            ))
        if dims and dims[0] == Unknown and len(table) <= 1:
            out.append(Diagnostic(
                "TFG101", "warn",
                f"input {spec.name!r} has an unknown batch dim but lead-dim "
                "bucketing is disabled (config.max_bucket_doublings <= 0): "
                "every distinct row count dispatches at a fresh key",
                subject=spec.name,
                fix="re-enable bucketing (configure(max_bucket_doublings=...)"
                    ") or feed fixed-size blocks",
            ))
    if (
        ctx.block_mode is True
        and ctx.block_row_counts is not None
        and len(set(ctx.block_row_counts)) >= 3
    ):
        sizes = sorted(set(ctx.block_row_counts))
        shown = ", ".join(str(s) for s in sizes[:6])
        out.append(Diagnostic(
            "TFG101", "warn",
            f"frame presents {len(sizes)} distinct block row counts "
            f"([{shown}{'…' if len(sizes) > 6 else ''}]); block-mode "
            "dispatch keys one entry per distinct shape — the bucket "
            "table bounds map_rows only",
            subject="frame",
            fix="repartition() the frame (the partitioner yields at most "
                "two block sizes) or switch to map_rows, whose vmapped "
                "lead dim is bucketed",
        ))
    return out


# ---------------------------------------------------------------------------
# TFG102 — f64-leak
# ---------------------------------------------------------------------------

def _rule_f64_leak(ctx: RuleContext) -> List[Diagnostic]:
    if ctx.graph is None:
        return []
    f64 = torch.float64
    if any(dtype == f64 for (_, dtype) in ctx.in_avals):
        return []  # a genuinely-f64 program: nothing is "leaking"
    # the port has no x64 demotion boundary: the reference's severity
    # with demotion inactive
    severity = "info"
    boundary = "promotes an otherwise sub-64-bit program to float64"
    out: List[Diagnostic] = []
    for _, const in ctx.graph.consts:
        if const.dtype == f64:
            shape = tuple(const.shape)
            out.append(Diagnostic(
                "TFG102", severity,
                f"captured float64 constant (shape {shape}) {boundary}",
                subject=f"const{shape}",
                fix="build the constant at the framework dtype policy — "
                    "dsl.zeros/ones/fill default to dtypes."
                    "default_float(); for raw numpy use dtype=np.float32 "
                    "(or dtypes.default_float().np_dtype)",
            ))

    def node_dtype(a):
        const = _const_of(ctx.graph, a)
        return const.dtype if const is not None else _dtype_of(a)

    seen = 0
    for i, node in enumerate(_op_nodes(ctx.graph)):
        in_f64 = any(node_dtype(a) == f64 for a in _flat_args(node) if _is_node(a))
        dt_out = _dtype_of(node)
        outs = dt_out if isinstance(dt_out, list) else [dt_out]
        if any(d == f64 for d in outs) and not in_f64:
            seen += 1
            if seen > 8:  # cap the spam; the first sites locate the leak
                break
            name = _op_name(node)
            out.append(Diagnostic(
                "TFG102", severity,
                f"{name} at node#{i} emits float64 from non-float64 "
                f"operands — {boundary}",
                subject=f"node#{i}:{name}",
                fix="pin the op's dtype (e.g. dtype=torch.float32) or drop "
                    "the float64 value feeding it",
            ))
    return out


# ---------------------------------------------------------------------------
# TFG103 — unused-input
# ---------------------------------------------------------------------------

def _rule_unused_input(ctx: RuleContext) -> List[Diagnostic]:
    if ctx.graph is None:
        return []
    if getattr(ctx.program, "_tftpu_has_callback", False):
        # a numpy_udf host stage hands every input to the numpy function;
        # its captured graph is only the empty outputs it returns under
        # fake tensors
        return []
    placeholders = [n for n in ctx.graph.gm.graph.nodes if n.op == "placeholder"]
    out: List[Diagnostic] = []
    for name, node in zip(ctx.in_names, placeholders):
        if not node.users:
            out.append(Diagnostic(
                "TFG103", "info",
                f"input {name!r} is consumed by no output (dead fetch): it "
                "still pays schema validation, marshalling and host→HBM "
                "transfer on every block",
                subject=name,
                fix=f"drop {name!r} from the program's inputs (or from the "
                    "feed_dict) so the column never ships to the device",
            ))
    return out


# ---------------------------------------------------------------------------
# TFG104 — donation-alias
# ---------------------------------------------------------------------------

def _rule_donation_alias(ctx: RuleContext) -> List[Diagnostic]:
    in_names = [s.name for s in ctx.program.inputs]
    out_names = (
        [s.name for s in ctx.program.outputs]
        if ctx.program.outputs else list(ctx.out_names)
    )
    clash = sorted(set(in_names) & set(out_names))
    if not clash:
        return []
    return [Diagnostic(
        "TFG104", "error",
        f"feed(s) {clash} are also kept as output column(s) under the same "
        "name: this package donates no input, but the JAX package donates "
        "feeds by default, and there XLA may reuse a donated input buffer "
        "for an output, so the kept column can alias freed memory",
        subject=",".join(clash),
        fix="fetch the column under a different output name (e.g. via "
            "identity(...).named('x_out'))",
    )]


# ---------------------------------------------------------------------------
# TFG105 — nan-hazard (sign-lattice walk over aten ops)
# ---------------------------------------------------------------------------

_POS, _NONNEG, _UNK = "positive", "nonnegative", "unknown"


def _host_values(t):
    """A small host constant's values as numpy, else None (GPU tensors
    and large constants are never read)."""
    if not torch.is_tensor(t) or t.device.type != "cpu" or t.numel() > SMALL_CONST_NUMEL:
        return None
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    try:
        return t.detach().numpy()
    except Exception:
        return None


def _sign_of_value(val) -> str:
    try:
        arr = np.asarray(val)
        if arr.size == 0 or arr.dtype.kind not in "ifub":
            return _UNK
        if np.all(arr > 0):
            return _POS
        if np.all(arr >= 0):
            return _NONNEG
    except Exception:
        pass
    return _UNK


def _nonzero_of_value(val) -> bool:
    try:
        arr = np.asarray(val)
        return arr.size > 0 and arr.dtype.kind in "ifub" and bool(
            np.all(arr != 0)
        )
    except Exception:
        return False


def _sign_of_dtype(dtype) -> str:
    if dtype in (torch.uint8, torch.bool, torch.uint16, torch.uint32, torch.uint64):
        return _NONNEG
    return _UNK


def _join2(a: str, b: str, table: Dict[Tuple[str, str], str]) -> str:
    return table.get((a, b)) or table.get((b, a)) or _UNK


_ADD = {(_POS, _POS): _POS, (_POS, _NONNEG): _POS, (_NONNEG, _NONNEG): _NONNEG}
_MUL = {(_POS, _POS): _POS, (_POS, _NONNEG): _NONNEG,
        (_NONNEG, _NONNEG): _NONNEG}
_MAX = {(_POS, _POS): _POS, (_POS, _NONNEG): _POS, (_POS, _UNK): _POS,
        (_NONNEG, _NONNEG): _NONNEG, (_NONNEG, _UNK): _NONNEG}

#: aten ops that preserve their (first) operand's sign
_SIGN_PRESERVING = frozenset({
    "expand", "expand_copy", "view", "view_copy", "reshape", "_unsafe_view",
    "squeeze", "unsqueeze", "permute", "transpose", "t", "slice", "select",
    "index_select", "index", "gather", "_to_copy", "clone", "alias", "detach",
    "lift_fresh_copy", "contiguous", "amax", "amin", "flip", "repeat",
})

#: ops whose result is a constant fill: op -> index of the fill value
#: (None: the sign is the op's own)
_FILLS = {"ones": _POS, "ones_like": _POS, "new_ones": _POS,
          "zeros": _NONNEG, "zeros_like": _NONNEG, "new_zeros": _NONNEG}
_FILL_ARG = {"full": 1, "full_like": 1, "new_full": 2, "scalar_tensor": 0}


def _meet(signs) -> str:
    """Strongest sign every element of a mixed bag satisfies (``cat``: the
    result is only as positive as its WEAKEST operand)."""
    signs = list(signs)
    if signs and all(s == _POS for s in signs):
        return _POS
    if signs and all(s in (_POS, _NONNEG) for s in signs):
        return _NONNEG
    return _UNK


#: hazard op -> (operand index, sign required to be safe, hazard text,
#: the reference's primitive name)
_HAZARDS = {
    "log": (0, _POS, "log of a non-positive value is -inf/NaN", "log"),
    "log2": (0, _POS, "log of a non-positive value is -inf/NaN", "log"),
    "log10": (0, _POS, "log of a non-positive value is -inf/NaN", "log"),
    "div": (1, _POS, "division by a value not provably nonzero", "div"),
    "reciprocal": (0, _POS, "division by a value not provably nonzero", "div"),
    "rsqrt": (0, _POS, "rsqrt of a non-positive value is inf/NaN", "rsqrt"),
    "sqrt": (0, _NONNEG, "sqrt of a negative value is NaN", "sqrt"),
}

_SAFE_REQ = {_POS: (_POS,), _NONNEG: (_POS, _NONNEG)}


def _walk_signs(graph, hazards) -> None:
    """Forward sign pass over the graph; appends (site, op, sign, text)
    hazard tuples. A parallel nonzero lattice covers the div hazard for
    values that are provably nonzero without being positive (a ``-2.0``
    literal)."""
    env: Dict[object, str] = {}
    nz: Dict[object, bool] = {}
    for node in graph.gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = _sign_of_dtype(_dtype_of(node))
        elif node.op == "get_attr":
            vals = _host_values(_const_of(graph, node))
            env[node] = _sign_of_value(vals) if vals is not None else _UNK
            nz[node] = _nonzero_of_value(vals) if vals is not None else False

    def sign_of(a) -> str:
        if _is_node(a):
            return env.get(a, _UNK)
        if isinstance(a, (bool, int, float)):
            return _sign_of_value(a)
        return _UNK

    def nonzero_of(a) -> bool:
        if _is_node(a):
            return nz.get(a, False) or env.get(a, _UNK) == _POS
        if isinstance(a, (bool, int, float)):
            return _nonzero_of_value(a)
        return False

    for i, node in enumerate(_op_nodes(graph)):
        name = _op_name(node)
        args = list(node.args)
        ins = [sign_of(a) for a in args]
        ins_nz = [nonzero_of(a) for a in args]
        if name in _HAZARDS:
            idx, need, text, _ = _HAZARDS[name]
            got = ins[idx] if idx < len(ins) else _UNK
            safe = got in _SAFE_REQ[need]
            if name in ("div", "reciprocal") and idx < len(ins_nz) and ins_nz[idx]:
                safe = True  # nonzero (even negative) denominator: no NaN
            if not safe:
                hazards.append((f"node#{i}:{name}", name, got, text))
        # transfer
        res, res_nz = _UNK, False
        if name in ("exp", "exp2", "_softmax"):
            res, res_nz = _POS, True
        elif name == "neg":
            res_nz = ins_nz[0] if ins_nz else False
        elif name == "cat":
            parts = args[0] if args and isinstance(args[0], (list, tuple)) else []
            res = _meet(sign_of(p) for p in parts)
            res_nz = bool(parts) and all(nonzero_of(p) for p in parts)
        elif name in ("abs", "square"):
            res = _POS if ins and ins[0] == _POS else _NONNEG
            res_nz = ins_nz[0] if ins_nz else False
        elif name == "relu":
            res = _POS if ins and ins[0] == _POS else _NONNEG
        elif name == "pow" and len(args) == 2 and _is_node(args[0]) \
                and isinstance(args[1], (int, float)) and float(args[1]).is_integer():
            y = int(args[1])
            if y % 2 == 0:
                res = _POS if ins[0] == _POS else _NONNEG
                res_nz = ins_nz[0] if y == 2 else False
            else:
                res = ins[0]
        elif name == "add":
            alpha = node.kwargs.get("alpha", 1)
            if len(ins) >= 2 and sign_of(alpha) == _POS:
                res = _join2(ins[0], ins[1], _ADD)
        elif name in ("sum", "mean"):
            res = ins[0] if ins else _UNK
            if res == _POS:
                # an empty reduction yields 0 (NaN for a mean): a sum of
                # positives is positive only over non-empty extents
                val = args[0].meta.get("val") if _is_node(args[0]) else None
                shape = tuple(getattr(val, "shape", ()))
                dims = args[1] if len(args) > 1 and args[1] is not None else range(len(shape))
                dims = [dims] if isinstance(dims, int) else list(dims)
                if not all(shape[d] > 0 for d in dims if -len(shape) <= d < len(shape)):
                    res = _NONNEG
        elif name in ("mul", "div"):
            res = _join2(ins[0], ins[1], _MUL) if len(ins) >= 2 else _UNK
            res_nz = len(ins_nz) >= 2 and ins_nz[0] and ins_nz[1]
        elif name in ("maximum", "clamp_min"):
            res = _join2(ins[0], ins[1], _MAX) if len(ins) >= 2 else _UNK
        elif name == "clamp":
            lo = args[1] if len(args) > 1 else node.kwargs.get("min")
            if lo is not None:
                res = _join2(ins[0], sign_of(lo), _MAX)
        elif name in ("sqrt", "rsqrt"):
            res = ins[0] if ins and ins[0] in (_POS, _NONNEG) else _UNK
            if name == "rsqrt" and res == _NONNEG:
                res = _UNK  # rsqrt(0) = inf
            res_nz = ins_nz[0] if ins_nz else False
        elif name in _FILLS:
            res = _FILLS[name]
        elif name in _FILL_ARG:
            k = _FILL_ARG[name]
            if k < len(args):
                res, res_nz = sign_of(args[k]), nonzero_of(args[k])
        elif name == "getitem":
            if len(args) > 1 and args[1] == 0:
                res = ins[0]
                res_nz = ins_nz[0]
        elif name in _SIGN_PRESERVING:
            res = ins[0] if ins else _UNK
            res_nz = ins_nz[0] if ins_nz else False
        env[node] = res
        nz[node] = res_nz or res == _POS


def _rule_nan_hazard(ctx: RuleContext) -> List[Diagnostic]:
    if ctx.graph is None:
        return []
    hazards: List[Tuple[str, str, str, str]] = []
    _walk_signs(ctx.graph, hazards)
    out: List[Diagnostic] = []
    for site, prim, got, text in hazards[:8]:
        out.append(Diagnostic(
            "TFG105", "warn",
            f"{text} (operand sign statically {got}) at {site}",
            subject=site,
            fix="clamp or guard the operand before the op (e.g. "
                "torch.clamp(x, min=eps), torch.where(mask, x, safe)); "
                "resilience.guards.StepGuard only catches the NaN after "
                "the step already ran",
        ))
    return out


# ---------------------------------------------------------------------------
# TFG106 — hbm-budget
# ---------------------------------------------------------------------------

def _aval_bytes(avals) -> int:
    total = 0
    for shape, dtype in avals:
        if dtype is None:
            continue
        itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
        total += int(np.prod(shape, dtype=np.int64)) * itemsize
    return total


def _device_budget_bytes(device) -> Optional[int]:
    """The GPU's total memory (``torch.cuda.mem_get_info``) when the
    program runs on one; None on the CPU, where the rule is silent."""
    try:
        device = torch.device(device if device is not None else "cpu")
        if device.type != "cuda" or not torch.cuda.is_available():
            return None
        return int(torch.cuda.mem_get_info(device)[1])
    except Exception:
        return None


def _rule_hbm_budget(ctx: RuleContext) -> List[Diagnostic]:
    if ctx.graph is None:
        return []
    budget = ctx.hbm_budget_bytes
    if budget is None:
        budget = _device_budget_bytes(getattr(ctx.program, "device", None))
    if not budget:
        return []  # no budget known: the rule has nothing to compare against
    const_b = _aval_bytes((tuple(c.shape), c.dtype) for _, c in ctx.graph.consts)
    in_b = _aval_bytes(ctx.in_avals)
    out_b = _aval_bytes(ctx.out_avals)
    est = const_b + in_b + out_b
    # the program's own cost analysis, when one was already memoized
    # (the rule never runs one itself)
    cost_note = ""
    cache = getattr(ctx.program, "_cost_cache", None)
    if cache:
        peak = max(
            (float(c.get("bytes accessed", 0.0)) for c in cache.values()),
            default=0.0,
        )
        if peak:
            cost_note = (
                f"; memoized cost model reports {peak / 1e6:.1f} MB "
                "accessed"
            )
            est = max(est, int(peak))
    if est <= budget:
        return []
    return [Diagnostic(
        "TFG106", "warn",
        f"static residency estimate {est / 1e6:.1f} MB (consts "
        f"{const_b / 1e6:.1f} + inputs {in_b / 1e6:.1f} + outputs "
        f"{out_b / 1e6:.1f} MB at probe batch {ctx.probe}) exceeds the "
        f"device budget {budget / 1e6:.1f} MB{cost_note} — expect OOM "
        "before the first result",
        subject="program",
        fix="shrink the per-call batch (more blocks / smaller buckets), "
            "quantize the weights (int8 keeps the weight residency at "
            "one byte per element), or split the frame over more devices",
    )]


# ---------------------------------------------------------------------------
# TFG107 — fusion-barrier (plan-chain rule: lint_plan only)
# ---------------------------------------------------------------------------

def _rule_fusion_barrier(ctx: RuleContext) -> List[Diagnostic]:
    if not ctx.plan_barriers:
        return []
    out: List[Diagnostic] = []
    for b in ctx.plan_barriers:
        up = int(b.get("upstream_maps", 0))
        down = int(b.get("downstream_maps", 0))
        if up + down < 1:
            continue  # a barrier with no fusable neighbor splits nothing
        up_txt = str(up) if b.get("upstream_exact", True) else f">={up}"
        out.append(Diagnostic(
            "TFG107", "warn",
            f"chain contains a fusion barrier — {b['reason']} — between "
            f"otherwise-fusable map stages ({up_txt} upstream, {down} "
            "downstream): each side dispatches its own program and "
            "the boundary materializes every intermediate column",
            subject=str(b["reason"]).split(":")[0],
            fix="move the barrier out of the hot chain (materialize once "
                "up front, run analyze() to densify ragged columns, keep "
                "host callbacks out of chained stages), or accept the "
                "split — the plan layer already fuses each side "
                "separately",
        ))
    return out


# ---------------------------------------------------------------------------
# TFG109 — unfused-aggregate (plan-chain rule: lint_plan only)
# ---------------------------------------------------------------------------

def _rule_unfused_aggregate(ctx: RuleContext) -> List[Diagnostic]:
    """An ``aggregate``/``join`` consuming an otherwise-fusable lazy chain
    stayed a fusion barrier for a reason the user can fix (the plan layer
    records only fixable causes)."""
    if not ctx.unfused_epilogues:
        return []
    out: List[Diagnostic] = []
    for e in ctx.unfused_epilogues:
        out.append(Diagnostic(
            "TFG109", "warn",
            f"{e['verb']} stayed a fusion barrier on an otherwise-"
            f"fusable chain — {e['reason']} — so the upstream mapped "
            "columns materialized and the epilogue dispatched as a "
            "separate program instead of fusing into one dispatch per "
            "block",
            subject=str(e["verb"]),
            fix=str(e["reason"]),
        ))
    return out


# ---------------------------------------------------------------------------
# TFG110 — missed-aggregate-pushdown (plan-chain rule: lint_plan only)
# ---------------------------------------------------------------------------

def _rule_missed_pushdown(ctx: RuleContext) -> List[Diagnostic]:
    """An aggregate sits above a join the adaptive optimizer could push it
    below, but a fixable cause blocks the rewrite (each finding names the
    blocking column or fetch and the fix)."""
    if not ctx.pushdown_misses:
        return []
    out: List[Diagnostic] = []
    for m in ctx.pushdown_misses:
        out.append(Diagnostic(
            "TFG110", "warn",
            "aggregate sits above a join it could push below, but "
            f"{m.get('detail', m.get('cause', 'an unknown cause'))} — "
            "so every row match-expands through the join and the "
            "epilogue reduces the expanded table instead of the "
            "pre-join partials",
            subject=str(m.get("subject", "aggregate")),
            fix=str(m.get("fix", "")),
        ))
    return out


# ---------------------------------------------------------------------------
# TFG111 — larger-than-budget materialization (plan-chain rule: lint_plan)
# ---------------------------------------------------------------------------

def _rule_oversized_materialization(ctx: RuleContext) -> List[Diagnostic]:
    """A forced ``to_host``/``to_numpy`` materialized an estimated byte
    volume past the block-store budget (``TFTPU_BLOCK_BUDGET_MB``)."""
    if not ctx.oversized_materializations:
        return []
    out: List[Diagnostic] = []
    for m in ctx.oversized_materializations:
        est_mb = m["estimated_bytes"] / (1 << 20)
        bud_mb = m["budget_bytes"] / (1 << 20)
        out.append(Diagnostic(
            "TFG111", "warn",
            f"forced materialization ({m['reason']}) holds an estimated "
            f"{est_mb:.0f} MiB ({m['rows']:,} rows) in host RAM at once "
            f"— past the {bud_mb:.0f} MiB block-store budget "
            "(TFTPU_BLOCK_BUDGET_MB)",
            subject="to_host",
            fix="stream instead of materializing: walk the chain with "
                "blockstore.stream_chain(io.scan_csv/scan_parquet(...), "
                "chain_fn, fold_fn=...) — results spill to the block "
                "store as they complete and peak RSS stays under the "
                "budget — or spill the frame explicitly with "
                "frame.spill_to(BlockStore()); raise "
                "TFTPU_BLOCK_BUDGET_MB only if the host genuinely has "
                "the RAM",
        ))
    return out


# ---------------------------------------------------------------------------
# TFG108 — cache-fingerprint-unstable
# ---------------------------------------------------------------------------

_TFG108_WHAT = {
    "graph": "the captured graph itself (trace-time control flow or "
             "Python values baked into the graph differ between rebuilds)",
    "consts": "a captured constant differs between rebuilds",
    "avals": "the abstract input signature",
    "outs": "the fetch order",
    "env": "the environment component",
}


def _rule_fingerprint_unstable(ctx: RuleContext) -> List[Diagnostic]:
    """The persistent store keys a dispatch by a content hash of the
    captured program (:mod:`tensorframes_tpu_torch.compilecache`). A
    program whose fingerprint differs across two identical rebuilds — a
    value drawn from an unseeded RNG at trace time, any capture that
    differs per build — never matches a key recorded by an earlier
    process. Two independent captures, no dispatch; host constants enter
    by value, GPU tensors by shape and dtype (a GPU capture whose values
    differ per process is the rule's blind spot)."""
    if ctx.program is None or ctx.graph is None:
        return []
    from ..compilecache.fingerprint import program_fingerprint

    kw = dict(probe=ctx.probe, mesh=ctx.mesh, shardings=ctx.shardings)
    a = program_fingerprint(ctx.program, components=True, **kw)
    b = program_fingerprint(ctx.program, components=True, **kw)
    if a is None or b is None or a == b:
        return []
    moved = [k for k in ("graph", "consts", "avals", "outs", "env")
             if a.get(k) != b.get(k)]
    sh_a, sh_b = a.get("shardings", {}), b.get("shardings", {})
    moved += [f"shardings[{n}]" for n in sorted(set(sh_a) | set(sh_b))
              if sh_a.get(n) != sh_b.get(n)]
    detail = "; ".join(_TFG108_WHAT.get(m, m) for m in moved)
    return [Diagnostic(
        "TFG108", "warn",
        "cache fingerprint differs across two identical rebuilds of "
        f"this program (unstable component(s): {', '.join(moved)} — "
        f"{detail}): the persistent store (TFTPU_COMPILE_CACHE) misses "
        "on every process start — a miss storm: no key an earlier "
        "process recorded ever matches, and warmup's manifest replays "
        "none of them",
        subject="program",
        fix="make trace-time captures deterministic (seed the RNG that "
            "builds captured arrays, avoid set/dict-order-dependent "
            "constructions); closure values must be a pure function of "
            "the program definition for the cache key to be stable",
    )]


# ---------------------------------------------------------------------------
# TFG112 — liftable-callback / lift-declined (plan-chain rule)
# ---------------------------------------------------------------------------

def _rule_liftable_callback(ctx: RuleContext) -> List[Diagnostic]:
    """Verified UDF lifting decisions on the chain's numpy UDF stages
    (plan/lift): a *lifted* stage is an info — the callback barrier was
    cleared after bit-exact verification and the stage fuses like any
    other; a *declined* stage is a warn carrying the taxonomy reason
    and, where one exists, the offending AST node — the actionable
    rewrite that would let the UDF lift."""
    if not ctx.lift_events:
        return []
    out: List[Diagnostic] = []
    for ev in ctx.lift_events:
        udf = str(ev.get("udf", "<udf>"))
        if ev.get("lifted"):
            out.append(Diagnostic(
                "TFG112", "info",
                f"numpy UDF {udf!r} lifted into the plan IR (synthesis "
                "verified bit-exact on the boundary corpus): the stage "
                "fuses — no callback barrier, no per-stage dispatch",
                subject=udf,
                fix="none needed — TFTPU_LIFT=0 replays the callback "
                    "path if you need the host-side original",
            ))
            continue
        reason = str(ev.get("reason", "unknown"))
        node = ev.get("node")
        lineno = ev.get("lineno")
        at = f" at AST node {node}" if node else ""
        at += f" (line {lineno})" if lineno else ""
        detail = str(ev.get("detail") or "")
        out.append(Diagnostic(
            "TFG112", "warn",
            f"numpy UDF {udf!r} stayed a host-callback barrier — "
            f"lift declined: {reason}{at}"
            + (f" — {detail}" if detail else ""),
            subject=udf,
            fix="restrict the UDF to the lifting allowlist (elementwise "
                "numpy ops, min/max and int/bool sum/mean reductions, "
                "constants, column refs — no loops, branches, mutable "
                "closures or np.random); see docs/analysis.md#tfg112 "
                "for the full table, or keep the callback and accept "
                "the barrier",
        ))
    return out


# ---------------------------------------------------------------------------
# TFG113 — prefix-cache ineligible (serving evidence rule)
# ---------------------------------------------------------------------------

_TFG113_FIXES = {
    "store_unarmed":
        "arm the cache: register_decode(..., DecodeConfig("
        "prefix_cache=True)) — repeated prompt prefixes were observed, "
        "so those prefill chunks would be shared (docs/serving.md#kv-"
        "memory-hierarchy)",
    "page_misalignment":
        "prompts this short never fill one KV page, so nothing can be "
        "published or matched at page granularity — lower "
        "DecodeConfig.page_size below the common prefix length (the "
        "cache matches whole pages only)",
    "sampling_state_mismatch":
        "replay-resumed joins must reproduce their recorded tokens "
        "against the page state of first admission, so they bypass the "
        "cache by design — size the pool (num_pages) or arm kv_swap so "
        "fewer sequences resume through the recompute path",
}


def _rule_prefix_cache_ineligible(ctx: RuleContext) -> List[Diagnostic]:
    """Decode-engine evidence that prompt prefill work could not ride the
    prefix cache; each finding's fix names the config change."""
    if not ctx.prefix_cache_events:
        return []
    out: List[Diagnostic] = []
    for ev in ctx.prefix_cache_events:
        reason = str(ev.get("reason", "unknown"))
        endpoint = str(ev.get("endpoint", "<endpoint>"))
        out.append(Diagnostic(
            "TFG113", "warn",
            f"decode endpoint {endpoint!r}: prompt prefill was not "
            f"shareable through the prefix cache — {reason} "
            f"(prompt_len={ev.get('prompt_len')}, "
            f"page_size={ev.get('page_size')})",
            subject=endpoint,
            fix=_TFG113_FIXES.get(
                reason,
                "see docs/analysis.md#tfg113 for the reason taxonomy",
            ),
        ))
    return out


# ---------------------------------------------------------------------------
# TFG114 — registered query not cacheable/incremental (serving evidence)
# ---------------------------------------------------------------------------

_TFG114_FIXES = {
    "host_callback":
        "the map stage runs a host callback, so results are not a pure "
        "function of the plan fingerprint — lift the UDF "
        "(plan.lift/TFG112 names whether it is liftable) or move the "
        "callback out of the served pipeline",
    "non_algebraic":
        "the aggregate fetches a non-algebraic reduction, so it "
        "executes on the host instead of the plan — restrict fetches "
        "to sum/min/max/mean over the grouped column "
        "(docs/plan.md#incremental-partials)",
    "eager":
        "build() returned an already-materialized frame (no recorded "
        "plan chain) — return the LAZY verb chain without forcing it "
        "(no collect()/column_values inside build), and check "
        "TFTPU_FUSION is not disabled",
    "join":
        "per-chunk partials of a join-then-aggregate are not "
        "maintained (build-side changes would stale them silently) — "
        "pre-join into the scanned table, or accept counted full "
        "recompute per refresh",
    "computed_key":
        "the group key is computed by a map stage, so a chunk's key "
        "set is not a pure function of the chunk — materialize the "
        "key into the source table so it passes through the scan",
    "reduce_mean":
        "a mean only folds across chunks as a (sum, count) companion "
        "pair, which partial tables do not carry — aggregate "
        "reduce_sum and a count column instead and divide at read "
        "time",
    "float_accumulation":
        "float sums reassociate across chunk partials, so the fold "
        "would not be bit-identical to full recompute — cast the "
        "summed column to an integer dtype, or accept counted full "
        "recompute (min/max stay incremental at any dtype)",
    "no_terminal_aggregate":
        "only terminal keyed aggregates fold incrementally — end the "
        "registered chain in aggregate(...), or accept that refreshes "
        "re-execute the whole pipeline (repeat queries still cache)",
}


def _rule_query_not_incremental(ctx: RuleContext) -> List[Diagnostic]:
    """Registered-query evidence that the served pipeline degraded to
    counted full recompute (mode ``cache``: every request re-executes;
    ``incremental``: refreshes pay O(table))."""
    if not ctx.query_cache_events:
        return []
    out: List[Diagnostic] = []
    for ev in ctx.query_cache_events:
        reason = str(ev.get("reason", "unknown"))
        endpoint = str(ev.get("endpoint", "<endpoint>"))
        mode = str(ev.get("mode", "cache"))
        what = ("result caching" if mode == "cache"
                else "incremental refresh")
        out.append(Diagnostic(
            "TFG114", "warn",
            f"query endpoint {endpoint!r}: plan blocks {what} — "
            f"{reason}: {ev.get('detail', '')}",
            subject=endpoint,
            fix=_TFG114_FIXES.get(
                reason,
                "see docs/analysis.md#tfg114 for the reason taxonomy",
            ),
        ))
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

RULES: Dict[str, Callable[[RuleContext], List[Diagnostic]]] = {
    "TFG101": _rule_recompile_storm,
    "TFG102": _rule_f64_leak,
    "TFG103": _rule_unused_input,
    "TFG104": _rule_donation_alias,
    "TFG105": _rule_nan_hazard,
    "TFG106": _rule_hbm_budget,
    "TFG107": _rule_fusion_barrier,
    "TFG108": _rule_fingerprint_unstable,
    "TFG109": _rule_unfused_aggregate,
    "TFG110": _rule_missed_pushdown,
    "TFG111": _rule_oversized_materialization,
    "TFG112": _rule_liftable_callback,
    "TFG113": _rule_prefix_cache_ineligible,
    "TFG114": _rule_query_not_incremental,
}


def run_rules(
    ctx: RuleContext, codes: Optional[Sequence[str]] = None
) -> List[Diagnostic]:
    """Run the selected rules (all by default) over one context. A rule
    that raises is a bug in the rule, not the user's program — it
    degrades to a single info diagnostic naming itself, so lint can
    never make a valid program un-runnable."""
    out: List[Diagnostic] = []
    for code, rule in RULES.items():
        if codes is not None and code not in codes:
            continue
        try:
            out.extend(rule(ctx))
        except Exception as e:  # pragma: no cover - rule bug safety net
            out.append(Diagnostic(
                code, "info",
                f"rule crashed ({type(e).__name__}: {e}); finding skipped",
                subject="analyzer",
                fix="report this as an analyzer bug",
            ))
    return out
