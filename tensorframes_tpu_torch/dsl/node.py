"""The DSL expression graph: nodes, naming, and compilation to Programs.

The analogue of the reference's two graph-building surfaces at once:

* the Python placeholder style (``x = tfs.block(df, "x"); z = tf.add(x, 3,
  name='z')``, README.md:69-76) — here ``block``/``row`` return DSL nodes
  that support operators and named ops;
* the Scala DSL (``dsl/package.scala:17-134``: placeholder, constant,
  zeros, ones, fill, identity, add, div, reduce_sum, reduce_min; operator
  sugar and ``named``; ``dsl/Operation.scala``) with its scoped, counted
  naming context (``dsl/Paths.scala:17-55`` — ``scope/name``, dedup as
  ``name_1``, ``name_2``).

A fetch list compiles directly to a :class:`~tensorframes_tpu_torch.program.Program`
whose function evaluates the graph with torch ops. Dtype promotion follows
the reference package (JAX with 64-bit types on), so the same graph gives
the same result dtypes in both packages: operands of two tensors promote
by dtype alone (a 0-d tensor counts like any other); a Python scalar is
weak and adopts the tensor's dtype, except that a Python float turns an
integer tensor into float64; true division and mean of integers compute
in float32 (float64 for int64).
"""

from __future__ import annotations

import contextlib
import operator
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import dtypes as dt
from ..program import Program, TensorSpec
from ..shape import Shape


class GraphContext:
    """Naming state: scope stack + per-name dedup counters."""

    def __init__(self):
        self.scopes: List[str] = []
        self.counters: Dict[str, int] = {}

    def reset(self):
        self.scopes.clear()
        self.counters.clear()

    def qualify(self, name: str) -> str:
        return "/".join(self.scopes + [name]) if self.scopes else name

    def unique(self, base: str) -> str:
        """TF-style dedup: first use keeps ``base``, later uses get
        ``base_1``, ``base_2``, … (≙ dsl/Paths.scala:40-55)."""
        qualified = self.qualify(base)
        n = self.counters.get(qualified, 0)
        self.counters[qualified] = n + 1
        return qualified if n == 0 else f"{qualified}_{n}"


_tls = threading.local()


def current_graph() -> GraphContext:
    g = getattr(_tls, "graph", None)
    if g is None:
        g = GraphContext()
        _tls.graph = g
    return g


@contextlib.contextmanager
def with_graph():
    """Fresh naming context for the duration of the block (recommended
    scoping practice, README.md:133-135; test hygiene ≙ GraphScoping)."""
    old = getattr(_tls, "graph", None)
    _tls.graph = GraphContext()
    try:
        yield _tls.graph
    finally:
        _tls.graph = old


@contextlib.contextmanager
def scope(name: str):
    """Name scope: nodes created inside get ``name/`` prefixed
    (≙ dsl/package.scala:32-33, Paths.withScope)."""
    g = current_graph()
    g.scopes.append(name)
    try:
        yield
    finally:
        g.scopes.pop()


ConstLike = Union[int, float, bool, list, tuple, np.ndarray]


# -- dtype promotion (the reference package's rules, see module doc) -------

def _inexact(dtype: torch.dtype) -> torch.dtype:
    """The float type an integer/bool computes in when the op needs one."""
    return torch.float64 if dtype == torch.int64 else torch.float32


def _promote(x, y):
    tx, ty = torch.is_tensor(x), torch.is_tensor(y)
    if tx and ty:
        common = torch.promote_types(x.dtype, y.dtype)
        return x.to(common), y.to(common)
    if tx and isinstance(y, float) and not x.is_floating_point():
        return x.to(torch.float64), y
    if ty and isinstance(x, float) and not y.is_floating_point():
        return x, y.to(torch.float64)
    return x, y


def _binop(fn: Callable) -> Callable:
    def op(x, y):
        return fn(*_promote(x, y))

    return op


def _true_div(x, y):
    x, y = _promote(x, y)
    t = x if torch.is_tensor(x) else y
    if not t.is_floating_point():
        inexact = _inexact(t.dtype)
        x = x.to(inexact) if torch.is_tensor(x) else x
        y = y.to(inexact) if torch.is_tensor(y) else y
    return x / y


def _float_fn(fn: Callable) -> Callable:
    """A unary float function that computes integer inputs in their
    inexact type (as ``jnp.exp`` of int32 gives float32)."""

    def op(v):
        if not v.is_floating_point():
            v = v.to(_inexact(v.dtype))
        return fn(v)

    return op


class Node:
    """One DSL graph node.

    ``eval_fn`` consumes the evaluated parent tensors and produces this
    node's tensor; placeholders instead read from the feed dict, and
    constants materialize on the device of the feeds.
    """

    def __init__(
        self,
        op: str,
        parents: Sequence["Node"],
        eval_fn: Optional[Callable],
        name: Optional[str] = None,
        dtype: Optional[dt.ScalarType] = None,
        shape: Optional[Shape] = None,
        reduce_axis: Optional[int] = None,
    ):
        g = current_graph()
        self.op = op
        self.parents = list(parents)
        self.eval_fn = eval_fn
        self.name = g.unique(name) if name else g.unique(op)
        self.dtype = dtype
        self.shape = shape
        # set for algebraic reducers (reduce_sum/min/max/mean over axis 0);
        # lets `aggregate` lower to vectorized segment ops.
        self.reduce_axis = reduce_axis
        self.is_placeholder = op == "placeholder"

    # -- naming -------------------------------------------------------------
    def named(self, name: str) -> "Node":
        """Rename (≙ the DSL's ``named``, dsl/Operation.scala:30-38)."""
        self.name = current_graph().qualify(name)
        return self

    def __repr__(self):
        return f"Node({self.op}:{self.name})"

    # -- operator sugar (≙ dsl/Implicits + Operation `+` `/`) ----------------
    def _lift(self, other) -> "Node":
        if isinstance(other, Node):
            return other
        return constant(other)

    def __add__(self, other):
        return add(self, self._lift(other))

    def __radd__(self, other):
        return add(self._lift(other), self)

    def __sub__(self, other):
        return sub(self, self._lift(other))

    def __rsub__(self, other):
        return sub(self._lift(other), self)

    def __mul__(self, other):
        return mul(self, self._lift(other))

    def __rmul__(self, other):
        return mul(self._lift(other), self)

    def __truediv__(self, other):
        return div(self, self._lift(other))

    def __rtruediv__(self, other):
        return div(self._lift(other), self)

    def __neg__(self):
        return unary("neg", operator.neg, self)

    def __pow__(self, other):
        return binary("pow", _binop(operator.pow), self, self._lift(other))


def placeholder(
    dtype, shape, name: Optional[str] = None
) -> Node:
    """Explicit placeholder (≙ dsl/package.scala:45-50; tf.placeholder in
    the Python path). ``shape`` entries may be None/-1 for Unknown."""
    scalar = dtype if isinstance(dtype, dt.ScalarType) else dt.from_numpy(dtype)
    return Node(
        "placeholder",
        [],
        None,
        name=name or "placeholder",
        dtype=scalar,
        shape=Shape.from_any(shape),
    )


class _Constant:
    """A constant's value, materialized once per device it is used on."""

    def __init__(self, value):
        self.value = value
        self._by_device: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device):
        if not isinstance(self.value, np.ndarray):
            return self.value  # a weak Python scalar
        t = self._by_device.get(device)
        if t is None:
            t = dt.to_torch(self.value, device)
            if device.type != "meta" and not _is_fake(t):
                self._by_device[device] = t
        return t


def _is_fake(t) -> bool:
    return type(t).__name__ == "FakeTensor"


def constant(
    value: ConstLike, name: Optional[str] = None, dtype=None
) -> Node:
    """Embed a constant (≙ dsl/package.scala:53-58; DenseTensor constants).

    Plain Python scalars behave exactly like literals (``x + 3.0``):
    weak-typed, adopting the other operand's dtype. Typed values (numpy
    scalars/arrays, nested lists) keep their exact dtype — floats default
    to float64, ints to int64, matching frame inference. Pass ``dtype=``
    to pin the embedded dtype explicitly."""
    arr = np.asarray(value) if dtype is None else np.asarray(value, dtype=dtype)
    scalar = dt.from_numpy(arr.dtype)
    if arr.ndim == 0 and isinstance(value, (int, float)) and not isinstance(
        value, bool
    ):
        # plain Python scalars stay weak-typed literals
        val = _Constant(value)
    else:
        val = _Constant(arr)
    node = Node(
        "constant",
        [],
        None,
        name=name or "constant",
        dtype=scalar,
        shape=Shape(arr.shape),
    )
    node.const = val
    return node


def _policy_dtype(dtype):
    """Resolve a constructor's ``dtype=None`` default to the framework
    float policy (:func:`tensorframes_tpu_torch.dtypes.default_float`)."""
    if dtype is not None:
        return dtype
    return dt.default_float().np_dtype


def zeros(shape, dtype=None, name=None) -> Node:
    """≙ dsl/package.scala:60-64; dtype defaults to the framework float
    policy."""
    return constant(np.zeros(shape, dtype=_policy_dtype(dtype)),
                    name=name or "zeros")


def ones(shape, dtype=None, name=None) -> Node:
    """≙ dsl/package.scala:66-70; dtype defaults to the framework float
    policy."""
    return constant(np.ones(shape, dtype=_policy_dtype(dtype)),
                    name=name or "ones")


def fill(shape, value, dtype=None, name=None) -> Node:
    """≙ dsl/package.scala:72-76. Float fills follow the framework float
    policy; int/bool fills keep numpy's inference (int64/bool), matching
    frame inference for those kinds."""
    if dtype is None and isinstance(value, float):
        dtype = dt.default_float().np_dtype
    return constant(np.full(shape, value, dtype=dtype), name=name or "fill")


def unary(op: str, fn: Callable, x: Node, name=None) -> Node:
    return Node(op, [x], fn, name=name)


def binary(op: str, fn: Callable, x: Node, y: Node, name=None) -> Node:
    return Node(op, [x, y], fn, name=name)


# -- op catalog (superset of dsl/package.scala:110-132) ----------------------

def identity(x: Node, name=None) -> Node:
    return unary("identity", lambda v: v, x, name=name)


def add(x: Node, y, name=None) -> Node:
    return binary("add", _binop(operator.add), x, x._lift(y) if not isinstance(y, Node) else y, name=name)


def sub(x: Node, y, name=None) -> Node:
    return binary("sub", _binop(operator.sub), x, x._lift(y) if not isinstance(y, Node) else y, name=name)


def mul(x: Node, y, name=None) -> Node:
    return binary("mul", _binop(operator.mul), x, x._lift(y) if not isinstance(y, Node) else y, name=name)


def div(x: Node, y, name=None) -> Node:
    return binary("div", _true_div, x, x._lift(y) if not isinstance(y, Node) else y, name=name)


def matmul(x: Node, y: Node, name=None) -> Node:
    return binary("matmul", _binop(torch.matmul), x, y, name=name)


def _dims(v: torch.Tensor, ax) -> Tuple[int, ...]:
    return tuple(range(v.dim())) if ax is None else ax


def _sum(v, dims):
    return torch.sum(v, dim=dims)


def _min(v, dims):
    if v.dtype == torch.bool:
        return torch.amin(v.to(torch.uint8), dim=dims)
    return torch.amin(v, dim=dims)


def _max(v, dims):
    if v.dtype == torch.bool:
        return torch.amax(v.to(torch.uint8), dim=dims)
    return torch.amax(v, dim=dims)


def _mean(v, dims):
    if not v.is_floating_point():
        v = v.to(_inexact(v.dtype))
    return torch.mean(v, dim=dims)


def _reducer(op: str, fn: Callable, x: Node, axis, name) -> Node:
    ax = axis
    if isinstance(ax, (list, tuple)):
        ax = tuple(ax)
        single = ax[0] if len(ax) == 1 else None
    else:
        single = ax
        ax = (ax,) if ax is not None else None

    def eval_fn(v):
        # preserve the input dtype: the reduce contract requires fetch and
        # input dtypes to match (Operations.scala:98-108), but torch.sum
        # would promote small ints to int64.
        return fn(v, _dims(v, ax)).to(v.dtype)

    return Node(op, [x], eval_fn, name=name, reduce_axis=single)


def reduce_sum(x: Node, axis=0, name=None) -> Node:
    """≙ dsl/package.scala:122-127 (& build_reducer, DslImpl.scala:175-200)."""
    return _reducer("reduce_sum", _sum, x, axis, name)


def reduce_min(x: Node, axis=0, name=None) -> Node:
    return _reducer("reduce_min", _min, x, axis, name)


def reduce_max(x: Node, axis=0, name=None) -> Node:
    return _reducer("reduce_max", _max, x, axis, name)


def reduce_mean(x: Node, axis=0, name=None) -> Node:
    return _reducer("reduce_mean", _mean, x, axis, name)


def apply_fn(fn: Callable, *xs: Node, name=None) -> Node:
    """Escape hatch: apply an arbitrary torch function to DSL nodes — any
    tensor program can join the graph."""
    return Node(getattr(fn, "__name__", "apply"), list(xs), fn, name=name)


def exp(x: Node, name=None) -> Node:
    return unary("exp", _float_fn(torch.exp), x, name)


def log(x: Node, name=None) -> Node:
    return unary("log", _float_fn(torch.log), x, name)


def tanh(x: Node, name=None) -> Node:
    return unary("tanh", _float_fn(torch.tanh), x, name)


def sqrt(x: Node, name=None) -> Node:
    return unary("sqrt", _float_fn(torch.sqrt), x, name)


def abs_(x: Node, name=None) -> Node:
    return unary("abs", torch.abs, x, name)


def square(x: Node, name=None) -> Node:
    return unary("square", torch.square, x, name)


def sigmoid(x: Node, name=None) -> Node:
    return unary("sigmoid", _float_fn(torch.sigmoid), x, name)


def relu(x: Node, name=None) -> Node:
    return unary("relu", torch.relu, x, name)


# ---------------------------------------------------------------------------
# Compilation: fetches → Program
# ---------------------------------------------------------------------------

def _closure(fetches: Sequence[Node]) -> List[Node]:
    """Transitive closure in topological order, deduped by node identity
    (≙ DslImpl.getClosure, dsl/DslImpl.scala:62-75)."""
    seen: Dict[int, Node] = {}
    order: List[Node] = []

    def visit(n: Node):
        if id(n) in seen:
            return
        seen[id(n)] = n
        for p in n.parents:
            visit(p)
        order.append(n)

    for f in fetches:
        visit(f)
    return order


def compile_fetches(fetches: Union[Node, Sequence[Node]]) -> Program:
    """Compile a fetch list into a Program (≙ DslImpl.buildGraph +
    analyzeGraphTF rolled into one, statically)."""
    if isinstance(fetches, Node):
        fetches = [fetches]
    fetches = list(fetches)
    names = [f.name for f in fetches]
    base = [n.split("/")[-1] for n in names]
    if len(set(base)) != len(base):
        # ≙ core.py:106-108 unique-column-name check
        raise ValueError(
            f"Could not infer a list of unique names for the columns: {names}"
        )
    nodes = _closure(fetches)
    placeholders = [n for n in nodes if n.is_placeholder]
    inputs = [TensorSpec(p.name, p.dtype, p.shape) for p in placeholders]

    def fn(feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        device = next(
            (v.device for v in feeds.values() if torch.is_tensor(v)),
            torch.device("cpu"),
        )
        values: Dict[int, object] = {}
        for n in nodes:
            if n.is_placeholder:
                values[id(n)] = feeds[n.name]
            elif n.op == "constant" and hasattr(n, "const"):
                values[id(n)] = n.const.on(device)
            else:
                args = [values[id(p)] for p in n.parents]
                values[id(n)] = n.eval_fn(*args)
        # column name = last path segment of the fetch name (feed-style
        # qualified names keep scopes; output columns use the base name,
        # ≙ core.py:106 stripping ":0")
        return {f.name.split("/")[-1]: values[id(f)] for f in fetches}

    prog = Program(fn, inputs, fetch_order=[n.split("/")[-1] for n in names])
    return prog


def segment_reduce_info(fetches: Sequence[Node]) -> Optional[List[Tuple[str, str, str]]]:
    """If every fetch is an algebraic reducer over axis 0 applied directly
    to a placeholder, return [(out_name, op, input_placeholder)] — enabling
    `aggregate` to lower to vectorized segment ops instead of generic
    per-group execution. Otherwise None."""
    out = []
    for f in fetches:
        if f.reduce_axis != 0 or len(f.parents) != 1:
            return None
        p = f.parents[0]
        if not p.is_placeholder:
            return None
        out.append((f.name.split("/")[-1], f.op, p.name))
    return out
