"""Foreign TF ``GraphDef`` ingestion: frozen-graph files → :class:`Program`.

The port of ``tensorframes_tpu/graphdef.py``. A clean-room protobuf
wire-format reader (``struct`` and numpy only) decodes the
``GraphDef``/``NodeDef``/``AttrValue``/``TensorProto`` subset frozen
inference graphs use, and each node lowers to a PyTorch expression,
evaluated in a topological order fixed at import. No TensorFlow is
imported, except by :func:`load_saved_model`'s fallback for graphs the
clean-room path cannot resolve.

The ops accepted are the reference's (:data:`SUPPORTED_OPS`, about 140
names): the reference DSL's own surface (Placeholder/Const/Identity/Add/
Div/Sum/Min), the elementwise and reduction neighbours, the
convolutional family of frozen image models over NHWC (Conv2D/
DepthwiseConv2dNative/MaxPool/AvgPool/BiasAdd/ConcatV2/FusedBatchNorm*),
the shape-arithmetic tier (Shape → StridedSlice → Pack → Reshape, run on
the host in numpy), the transformer family (GatherV2, Einsum/
BatchMatMulV2, SelectV2, Erf), the multi-output ops (``:k`` refs) and
``PartitionedCall`` bodies from the graph's function library. Anything
else raises with the op's name.

Execution on the device:

* Layout. Tensors are NHWC, as in the graph. A convolution or pool reads
  its input as a ``channels_last`` NCHW view (the same memory), so cuDNN
  runs its NHWC kernels with no transposes; filters are stored once, at
  import, as ``[cout, cin, kh, kw]`` in ``channels_last`` memory.
* Padding. TF's SAME at any stride pads ``max((ceil(in/s)-1)·s +
  (k-1)·d + 1 - in, 0)`` in all, half before and the odd row or column
  after; an uneven split goes through ``F.pad`` (MaxPool pads with the
  dtype's lowest value), and a SAME AvgPool divides its zero-padded sum
  by ``ops/windows.same_pool_counts``, as the reference does.
* Weights. Every node that depends on no placeholder (Consts, and the
  arithmetic over them such as a decomposed batch-norm's folding) is
  evaluated once at import, with the same expressions, and whatever of
  it a per-call op consumes moves to the device once, already in the
  form and dtype that op reads. A call uploads only its feeds.
* Memory. Each value is dropped after its last consumer has run (the
  consumer counts are fixed at import), so a deep graph holds only the
  activations still to be read.
* Precision. ``compute_dtype="auto"`` is bfloat16 on a CUDA device and
  ``None`` (f32-faithful) on the CPU. Under a compute dtype, MatMul,
  Conv2D, DepthwiseConv2dNative, BatchMatMul and Einsum cast f32
  operands to it and return f32; every other op stays exact. The
  matmul-class ops contract the narrowed values in f32, as XLA's
  ``preferred_element_type=f32`` does. A convolution runs in the compute
  dtype on cuDNN, which rounds its output to that dtype, widened at once:
  one rounding more than XLA's.
* int8 weights (``quantize_weights=True``). A MatMul with an int8 weight
  goes through :func:`~tensorframes_tpu_torch.ops.quantize.matmul`,
  which launches the ``int8_matmul`` kernel on the card (under a compute
  dtype with the narrowed activations in f32: its scalar build, f32
  sums and output). Convolutions cast the int8 filter to the activation
  dtype (exact: ``|q| <= 127``) and multiply the conv's output by the
  per-channel scale.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import dtypes as dt
from .config import resolve_device
from .ops.quantize import QuantizedTensor
from .ops.windows import same_pool_counts
from .program import Program, TensorSpec, analyze_program
from .shape import Shape, Unknown
from .utils import get_logger

logger = get_logger(__name__)


class UnresolvedVariableError(ValueError):
    """A reachable VarHandleOp has no bound value (the checkpoint bundle
    restored fine but the graph references a variable absent from it).
    ``load_saved_model`` falls back to TensorFlow freezing on exactly
    this failure; other lowering ``ValueError``s are genuine import
    errors and stay chained into any final failure."""

# ---------------------------------------------------------------------------
# protobuf wire-format primitives (clean-room; spec: protobuf.dev/encoding)
# ---------------------------------------------------------------------------


class _WireError(ValueError):
    """Byte-level decoding failure (malformed wire format) — distinct
    from semantic ValueErrors (unsupported dtype, string Const, …) so
    :func:`parse_graphdef` can re-label only true corruption."""


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise _WireError("malformed varint")


def _signed(v: int) -> int:
    """Interpret a decoded varint as two's-complement int64 (TF dim sizes
    encode -1 this way, not zigzag)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.
    LEN fields yield their raw bytes; varints yield ints; fixed32/64 yield
    raw 4/8 bytes. Unknown fields pass through for callers to skip."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:
            v, pos = _read_varint(data, pos)
            yield field, wire, v
        elif wire == 1:
            yield field, wire, data[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            yield field, wire, data[pos:pos + ln]
            pos += ln
        elif wire == 5:
            yield field, wire, data[pos:pos + 4]
            pos += 4
        else:
            raise _WireError(f"unsupported wire type {wire}")


# ---------------------------------------------------------------------------
# TF proto subset: TensorShapeProto / TensorProto / AttrValue / NodeDef
# ---------------------------------------------------------------------------

# tensorflow/core/framework/types.proto DataType enum → dtype registry
# (bfloat16 may be absent when ml_dtypes is unavailable — skip None)
_TF_DTYPES = {
    k: v
    for k, v in {
        1: dt.float32,
        2: dt.float64,
        3: dt.int32,
        4: dt.uint8,
        6: dt.int8,
        7: dt.string,
        9: dt.int64,
        10: dt.bool_,
        14: dt.bfloat16,
        19: dt.float16,
    }.items()
    if v is not None
}


def _parse_shape(data: bytes) -> Optional[List[int]]:
    """TensorShapeProto: dims (field 2, Dim.size field 1, -1 = unknown);
    unknown_rank (field 3). Returns None for unknown rank."""
    dims: List[int] = []
    unknown_rank = False
    for field, _, v in _iter_fields(data):
        if field == 2:
            size = 0
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    size = _signed(v2)
            dims.append(size)
        elif field == 3 and v:
            unknown_rank = True
    return None if unknown_rank else dims


class _StringTensor:
    """A parsed DT_STRING TensorProto: inert unless consumed. Dead
    string Consts (SavedModel saver cruft) must not break the import of
    an otherwise-numeric graph."""

    __slots__ = ("values",)

    def __init__(self, values):
        self.values = values

    def __repr__(self):
        return f"_StringTensor({len(self.values)} values)"


def _parse_tensor(data: bytes) -> np.ndarray:
    """TensorProto → numpy. Handles tensor_content (field 4) and the typed
    ``*_val`` repeated fields (packed or not); a single value fills the
    whole declared shape (TF's scalar-broadcast convention)."""
    dtype = dt.float32
    shape: List[int] = []
    content = b""
    vals: List = []
    for field, wire, v in _iter_fields(data):
        if field == 1:
            dtype = _TF_DTYPES.get(v)
            if dtype is None:
                raise ValueError(f"TensorProto: unsupported dtype enum {v}")
        elif field == 2:
            shape = _parse_shape(v) or []
        elif field == 4:
            content = v
        elif field == 5:  # float_val
            if wire == 5:
                vals.append(struct.unpack("<f", v)[0])
            else:
                vals.extend(
                    struct.unpack(f"<{len(v) // 4}f", v)
                )
        elif field == 6:  # double_val
            if wire == 1:
                vals.append(struct.unpack("<d", v)[0])
            else:
                vals.extend(struct.unpack(f"<{len(v) // 8}d", v))
        elif field in (7, 10):  # int_val / int64_val
            if wire == 0:
                vals.append(_signed(v))
            else:
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    vals.append(_signed(x))
        elif field == 11:  # bool_val
            if wire == 0:
                vals.append(bool(v))
            else:
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    vals.append(bool(x))
        elif field == 13:  # half_val: fp16/bf16 bit patterns as int32s
            raw: List[int] = []
            if wire == 0:
                raw.append(v)
            else:
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    raw.append(x)
            vals.extend(("half_bits", x) for x in raw)
        elif field == 8:  # string_val — host-only; see _StringTensor
            vals.append(("string_val", v))
    if dtype is dt.string or any(
        isinstance(x, tuple) and x and x[0] == "string_val" for x in vals
    ):
        # String Consts PARSE (SavedModel graphs carry dead saver/config
        # strings) but are rejected the moment a device program actually
        # CONSUMES one (strings are host-only; ≙ datatypes.scala:577-581)
        return _StringTensor(
            [x[1] for x in vals if isinstance(x, tuple)
             and x and x[0] == "string_val"]
        )
    np_dtype = dtype.np_dtype
    size = int(np.prod(shape)) if shape else 1
    if content:
        arr = np.frombuffer(content, dtype=np_dtype.newbyteorder("<"))
        arr = arr.astype(np_dtype)
    elif vals:
        if vals and isinstance(vals[0], tuple):  # half_val bit patterns
            bits = np.asarray([x for _, x in vals], dtype=np.uint16)
            arr = bits.view(np_dtype)
        else:
            arr = np.asarray(vals, dtype=np_dtype)
        if arr.size == 1 and size > 1:
            arr = np.full(size, arr.reshape(())[()], dtype=np_dtype)
        elif 1 < arr.size < size:
            # TF's partial-fill convention: remaining elements repeat the
            # LAST listed value
            arr = np.concatenate(
                [arr, np.full(size - arr.size, arr.flat[-1], dtype=np_dtype)]
            )
    else:
        arr = np.zeros(size, dtype=np_dtype)
    return arr.reshape(shape)


class _Attr:
    """One decoded AttrValue (attr_value.proto): whichever oneof member
    was present. ``ints``/``floats``/``bools`` carry ListValue members
    (Conv2D strides, pool ksize, Squeeze dims, …)."""

    __slots__ = ("s", "i", "f", "b", "type", "shape", "tensor",
                 "ints", "floats", "bools", "func")

    def __init__(self):
        self.s = self.i = self.f = self.b = None
        self.type = self.shape = self.tensor = None
        self.ints = self.floats = self.bools = None
        self.func = None  # NameAttrList name (PartitionedCall's 'f')


def _parse_list_value(a: _Attr, data: bytes) -> None:
    """AttrValue.ListValue: repeated i (field 3) / f (4) / b (5), packed
    per proto3 (attr_value.proto declares [packed = true]); handle the
    unpacked encoding too."""
    ints: List[int] = []
    floats: List[float] = []
    bools: List[bool] = []
    for field, wire, v in _iter_fields(data):
        if field == 3:
            if wire == 0:
                ints.append(_signed(v))
            else:
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    ints.append(_signed(x))
        elif field == 4:
            if wire == 5:
                floats.append(struct.unpack("<f", v)[0])
            else:
                floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
        elif field == 5:
            if wire == 0:
                bools.append(bool(v))
            else:
                bools.extend(bool(b) for b in v)
    if ints:
        a.ints = ints
    if floats:
        a.floats = floats
    if bools:
        a.bools = bools


def _parse_attr(data: bytes) -> _Attr:
    a = _Attr()
    for field, _, v in _iter_fields(data):
        if field == 1:
            _parse_list_value(a, v)
        elif field == 2:
            a.s = v
        elif field == 3:
            a.i = _signed(v)
        elif field == 4:
            a.f = struct.unpack("<f", v)[0]
        elif field == 5:
            a.b = bool(v)
        elif field == 6:
            a.type = v
        elif field == 7:
            a.shape = _parse_shape(v)
        elif field == 8:
            a.tensor = _parse_tensor(v)
        elif field == 10:  # func: NameAttrList (field 1 = name)
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    a.func = v2.decode("utf-8")
    return a


class GraphNode:
    """One decoded NodeDef (node_def.proto)."""

    __slots__ = ("name", "op", "inputs", "attrs")

    def __init__(self, name: str, op: str, inputs: List[str], attrs: Dict[str, _Attr]):
        self.name = name
        self.op = op
        self.inputs = inputs
        self.attrs = attrs

    def __repr__(self):
        return f"GraphNode({self.name!r}, op={self.op!r}, inputs={self.inputs})"


class FunctionDef:
    """One decoded library function (function.proto): signature arg
    names, body nodes (same :class:`GraphNode` records as the main
    graph), and the ``ret`` map from output-arg name to a body ref in
    the function convention (``node:port:index``)."""

    __slots__ = ("name", "input_args", "output_args", "nodes", "ret")

    def __init__(self, name, input_args, output_args, nodes, ret):
        self.name = name
        self.input_args = input_args
        self.output_args = output_args
        self.nodes = nodes
        self.ret = ret


class GraphNodes(list):
    """The parsed main-graph nodes, plus the function library (name →
    :class:`FunctionDef`) for graphs that keep ``PartitionedCall``
    wrappers (un-frozen ``tf.function`` exports)."""

    def __init__(self, nodes, library=None):
        super().__init__(nodes)
        self.library: Dict[str, FunctionDef] = library or {}


def parse_graphdef(data: bytes) -> "GraphNodes":
    """Decode a serialized ``GraphDef`` (graph.proto: field 1 = repeated
    NodeDef, field 2 = FunctionDefLibrary) into :class:`GraphNode`
    records plus the function library (``.library`` on the returned
    list — PartitionedCall bodies). Unknown fields are skipped — version
    stamps and device placements don't affect the inference subset.
    Malformed bytes raise ``ValueError`` ("not a valid GraphDef"), never
    a bare index/struct error."""
    try:
        return _parse_graphdef_inner(data)
    except (IndexError, struct.error, UnicodeDecodeError, _WireError) as e:
        # only true wire-level corruption re-labels; semantic errors
        # (unsupported dtype enum, string Const) keep their own message
        raise ValueError(
            f"not a valid serialized GraphDef ({type(e).__name__} while "
            f"decoding: {e})"
        ) from e


def _parse_node_def(v: bytes) -> GraphNode:
    name = op = ""
    inputs: List[str] = []
    attrs: Dict[str, _Attr] = {}
    for f2, _, v2 in _iter_fields(v):
        if f2 == 1:
            name = v2.decode("utf-8")
        elif f2 == 2:
            op = v2.decode("utf-8")
        elif f2 == 3:
            inputs.append(v2.decode("utf-8"))
        elif f2 == 5:
            k = av = None
            for f3, _, v3 in _iter_fields(v2):
                if f3 == 1:
                    k = v3.decode("utf-8")
                elif f3 == 2:
                    av = _parse_attr(v3)
            if k is not None and av is not None:
                attrs[k] = av
    return GraphNode(name, op, inputs, attrs)


def _parse_function_def(data: bytes) -> FunctionDef:
    """function.proto FunctionDef: field 1 = OpDef signature (name=1,
    input_arg=2, output_arg=3; ArgDef name=1), field 3 = repeated
    NodeDef, field 4 = ret map (key=1, value=2)."""
    name = ""
    input_args: List[str] = []
    output_args: List[str] = []
    nodes: List[GraphNode] = []
    ret: Dict[str, str] = {}
    for field, _, v in _iter_fields(data):
        if field == 1:  # OpDef
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    name = v2.decode("utf-8")
                elif f2 in (2, 3):  # ArgDef
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            (input_args if f2 == 2 else output_args).append(
                                v3.decode("utf-8")
                            )
        elif field == 3:
            nodes.append(_parse_node_def(v))
        elif field == 4:  # map<string, string> entry
            k = val = None
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    k = v2.decode("utf-8")
                elif f2 == 2:
                    val = v2.decode("utf-8")
            if k is not None and val is not None:
                ret[k] = val
    return FunctionDef(name, input_args, output_args, nodes, ret)


def _parse_graphdef_inner(data: bytes) -> "GraphNodes":
    nodes: List[GraphNode] = []
    library: Dict[str, FunctionDef] = {}
    for field, _, v in _iter_fields(data):
        if field == 1:
            nodes.append(_parse_node_def(v))
        elif field == 2:  # FunctionDefLibrary: field 1 = FunctionDef
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    fd = _parse_function_def(v2)
                    library[fd.name] = fd
    return GraphNodes(nodes, library)



# ---------------------------------------------------------------------------
# lowering: GraphNode list → Program
# ---------------------------------------------------------------------------

def _axes(idx_arr: np.ndarray) -> Tuple[int, ...]:
    return tuple(int(i) for i in np.atleast_1d(np.asarray(idx_arr)))


def _truncate_div(a, b):
    if a.is_floating_point():
        return torch.trunc(a / b).to(a.dtype)
    return torch.div(a, b, rounding_mode="trunc")


# elementwise / binary ops: name → function over torch tensors (numpy
# operands move to the device first, :meth:`_Ctx.tensor`)
_BINARY = {
    "Add": torch.add,
    "AddV2": torch.add,
    "Sub": torch.sub,
    "Mul": torch.mul,
    "Div": torch.true_divide,
    "RealDiv": torch.true_divide,
    "Maximum": torch.maximum,
    "Minimum": torch.minimum,
    "FloorDiv": torch.floor_divide,
    "FloorMod": torch.remainder,
    "Pow": torch.pow,
    "SquaredDifference": lambda a, b: torch.square(a - b),
    "Greater": torch.gt,
    "GreaterEqual": torch.ge,
    "Less": torch.lt,
    "LessEqual": torch.le,
    "Equal": torch.eq,
    "NotEqual": torch.ne,
    "LogicalAnd": torch.logical_and,
    "LogicalOr": torch.logical_or,
    "Atan2": torch.atan2,
    # the 0-input short-circuits TF defines: Xdivy/Xlogy return 0 where
    # x==0 (whatever y), DivNoNan returns 0 where y==0
    "Xdivy": lambda x, y: torch.where(
        x == 0, torch.zeros_like(x / y), x / y
    ),
    "Xlogy": lambda x, y: torch.where(
        x == 0, torch.zeros_like(x * torch.log(y)), x * torch.log(y)
    ),
    "DivNoNan": lambda x, y: torch.where(
        y == 0, torch.zeros_like(x / y), x / y
    ),
    # TF's Mod is C-style TRUNCATED modulo (sign of the dividend)
    "Mod": torch.fmod,
    "TruncateDiv": _truncate_div,
}

# graph plumbing: the value passes through untouched (a numpy operand
# stays on the host). A VarHandleOp resolves to the variable's VALUE at
# import (clean-room bundle restore, bundle.py), so the read is one too.
_PASS_THROUGH = (
    "Identity", "ReadVariableOp", "Snapshot", "PreventGradient",
    "CheckNumerics", "StopGradient",
)
_UNARY = {
    **{name: (lambda x: x) for name in _PASS_THROUGH},
    "LogSoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "L2Loss": lambda x: torch.sum(torch.square(x)) / 2,
    "Neg": torch.neg,
    "Square": torch.square,
    "Abs": torch.abs,
    "Relu": torch.relu,
    "Relu6": lambda x: torch.clamp(x, 0, 6),
    "Exp": torch.exp,
    "Log": torch.log,
    "Sqrt": torch.sqrt,
    "Rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "Tanh": torch.tanh,
    "Sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "Softmax": lambda x: torch.exp(x - x.amax(-1, keepdim=True))
    / torch.exp(x - x.amax(-1, keepdim=True)).sum(-1, keepdim=True),
    "Erf": torch.erf,
    "Erfc": torch.erfc,  # keras gelu lowers through erfc
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Round": torch.round,  # half to even, as TF and jnp.round
    "LogicalNot": torch.logical_not,
    "Elu": F.elu,
    "Selu": torch.selu,
    "Softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "Softsign": lambda x: x / (1 + torch.abs(x)),
    "Sin": torch.sin,
    "Cos": torch.cos,
    "Tan": torch.tan,
    "Atan": torch.atan,
    "Asin": torch.asin,
    "Acos": torch.acos,
    "Sinh": torch.sinh,
    "Cosh": torch.cosh,
    "Asinh": torch.asinh,
    "Acosh": torch.acosh,
    "Atanh": torch.atanh,
    "Log1p": torch.log1p,
    "Expm1": torch.expm1,
    "Reciprocal": lambda x: 1.0 / x,
    "Sign": torch.sign,
    "IsNan": torch.isnan,
    "IsInf": torch.isinf,
    "IsFinite": torch.isfinite,
}


def _reduce(fn_one):
    """A multi-axis reduction built from a one-axis one (``axes`` empty
    reduces nothing, as ``jnp`` with ``axis=()``)."""

    def run(x, axes, keepdims):
        axes = sorted({a % max(x.ndim, 1) for a in axes}, reverse=True)
        for a in axes:
            x = fn_one(x, a, keepdims)
        return x

    return run


def _sum(x, axes, keepdims):
    out = torch.sum(x, dim=tuple(axes), keepdim=keepdims) if axes else x
    # torch widens integer sums to int64; TF and jnp keep the dtype
    return out if x.dtype == torch.bool else out.to(x.dtype)


def _mean(x, axes, keepdims):
    if not x.is_floating_point():  # jnp.mean of an integer is inexact
        x = x.to(torch.float64 if x.dtype == torch.int64 else torch.float32)
    return torch.mean(x, dim=tuple(axes), keepdim=keepdims) if axes else x


# reducers: name → (x, axes, keepdims) → tensor
_REDUCERS = {
    "Sum": _sum,
    "Min": _reduce(lambda x, a, k: torch.amin(x, dim=a, keepdim=k)),
    "Max": _reduce(lambda x, a, k: torch.amax(x, dim=a, keepdim=k)),
    "Mean": _mean,
    "Prod": _reduce(lambda x, a, k: torch.prod(x, dim=a, keepdim=k).to(
        x.dtype if x.dtype != torch.bool else torch.int64)),
    "All": _reduce(lambda x, a, k: torch.all(x.bool(), dim=a, keepdim=k)),
    "Any": _reduce(lambda x, a, k: torch.any(x.bool(), dim=a, keepdim=k)),
}

# the ops with their own case in _eval_node (or in program_from_graphdef)
_STRUCTURAL = (
    "Placeholder", "Const", "Cast", "Reshape", "MatMul", "NoOp",
    "VarHandleOp",
    "Conv2D", "DepthwiseConv2dNative", "MaxPool", "AvgPool",
    "BiasAdd", "ConcatV2", "Concat", "Squeeze", "Pad", "PadV2",
    "FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3",
    # dynamic-shape tier: the TF1 idioms the reference's own snippet
    # graphs use (kmeans.py:28-45); Shape folds to host integers
    "Shape", "Pack", "Tile", "ExpandDims", "StridedSlice",
    "Fill", "Range", "ArgMin", "ArgMax",
    # transformer tier: the op family frozen keras/TF2 attention models
    # emit (Embedding gather, einsum attention, layernorm moments, gelu's
    # Erf, masking selects)
    "GatherV2", "Einsum", "Transpose", "Select", "SelectV2",
    "BatchMatMulV2", "BatchMatMul",
    "LeakyRelu",
    "Slice", "ZerosLike", "OnesLike", "BroadcastTo", "OneHot",
    "Cumsum", "Cumprod", "Rank", "Size",
    # image-serving tier: the ops frozen detection / segmentation /
    # preprocessing graphs lean on
    "AddN", "ReverseV2", "GatherNd", "MirrorPad", "MatrixBandPart",
    "DepthToSpace", "SpaceToDepth",
    "ResizeBilinear", "ResizeNearestNeighbor",
    # multi-output tier: evaluate to tuples; consumers select via :k
    "Split", "SplitV", "Unpack", "TopKV2", "IdentityN",
    # function calls (un-frozen tf.function exports): bodies come from
    # the graph's FunctionDefLibrary and are validated at import
    "PartitionedCall", "StatefulPartitionedCall",
)

#: Every op name the importer accepts (the reference's set).
SUPPORTED_OPS = frozenset(_STRUCTURAL) | frozenset(_BINARY) | frozenset(
    _UNARY) | frozenset(_REDUCERS)


# numpy twins for the shape-arithmetic subgraphs (Shape → Pack → Tile …):
# when EVERY operand of one of these ops is trace-time concrete (a numpy
# value — Const, Shape output, or arithmetic thereof), evaluate in numpy
# so concreteness propagates. That is what makes the reference's TF1
# dynamic-shape idiom (`tile(x, pack([tf.shape(p)[0], 1]))`,
# tensorframes_snippets/kmeans.py:28-45) executable with static shapes:
# `tf.shape` of a tensor is host integers, so the whole multiples chain
# folds to host integers before torch.tile sees it.
_BINARY_NP = {
    "Atan2": np.arctan2,
    "Mod": np.fmod,  # truncated, like lax.rem
    "TruncateDiv": lambda a, b: np.trunc(np.true_divide(a, b)).astype(
        np.asarray(a).dtype
    )
    if np.issubdtype(np.asarray(a).dtype, np.floating)
    else (np.sign(a) * np.sign(b) * (np.abs(a) // np.abs(b))).astype(
        np.asarray(a).dtype
    ),
    "SquaredDifference": lambda a, b: np.square(a - b),
    "Greater": np.greater,
    "GreaterEqual": np.greater_equal,
    "Less": np.less,
    "LessEqual": np.less_equal,
    "Equal": np.equal,
    "NotEqual": np.not_equal,
    "LogicalAnd": np.logical_and,
    "LogicalOr": np.logical_or,
    "Add": np.add,
    "AddV2": np.add,
    "Sub": np.subtract,
    "Mul": np.multiply,
    "Div": np.true_divide,
    "RealDiv": np.true_divide,
    "Maximum": np.maximum,
    "Minimum": np.minimum,
    "FloorDiv": np.floor_divide,
    "FloorMod": np.mod,
    "Pow": np.power,
}
_UNARY_NP = {
    "Neg": np.negative,
    "Square": np.square,
    "Abs": np.abs,
}


def _is_concrete(*vs) -> bool:
    """True when every value is host-resident (numpy / python scalar) —
    i.e. known at trace time, usable for shapes, axes, and multiples."""
    return all(
        isinstance(v, (np.ndarray, np.generic, int, float, bool)) for v in vs
    )


def _concrete_operand(n: "GraphNode", what: str, v) -> np.ndarray:
    if not _is_concrete(v):
        raise ValueError(
            f"{n.op} node {n.name!r}: {what} must be trace-time constant "
            "(a Const, or derived from Shape of a placeholder); got a "
            "traced value"
        )
    return np.asarray(v)


# ops whose evaluation yields a TUPLE of outputs; data refs ``name:k``
# select the k-th element (everything else is single-output)
_MULTI_OUTPUT = (
    "Split", "SplitV", "Unpack", "TopKV2", "IdentityN",
    "PartitionedCall", "StatefulPartitionedCall",
)


def _num_outputs(node, library=None) -> int:
    """Static output arity of a multi-output node (from its attrs —
    or, for function calls, the library signature), so out-of-range
    ``:k`` refs fail at IMPORT time, not first call."""
    if node.op in ("Split", "SplitV"):
        return int(node.attrs["num_split"].i)
    if node.op == "Unpack":
        return int(node.attrs["num"].i)
    if node.op == "TopKV2":
        return 2
    if node.op == "IdentityN":
        return len([r for r in node.inputs if not r.startswith("^")])
    if node.op in ("PartitionedCall", "StatefulPartitionedCall"):
        f = node.attrs.get("f")
        fd = (library or {}).get(f.func if f else None)
        return len(fd.output_args) if fd else 1
    return 1


# list-output ports: the numeric index in a function-body ref
# ``node:port:idx`` selects directly into the tuple; named scalar ports
# map by name
_PORT_MAPS = {"TopKV2": {"values": 0, "indices": 1}}


def _resolve_fn_ref(ref: str, value, op: str):
    """Resolve a FunctionDef-convention data ref (``node:port:index``)
    against an evaluated body-node value."""
    if not isinstance(value, tuple):
        return value
    parts = ref.split(":")
    port = parts[1] if len(parts) >= 2 else ""
    idx = int(parts[2]) if len(parts) >= 3 and parts[2].isdigit() else 0
    pm = _PORT_MAPS.get(op)
    if pm is not None:
        if port not in pm:
            raise ValueError(
                f"function ref {ref!r}: unknown output port {port!r} of "
                f"{op}"
            )
        idx = pm[port]
    if idx >= len(value):
        raise ValueError(
            f"function ref {ref!r} selects output {idx} but the node has "
            f"{len(value)} outputs"
        )
    return value[idx]


def _eval_function(fdef, call_args, library, ctx):
    """Evaluate one library function body (PartitionedCall target):
    bind ``call_args`` to the signature's input args, run the body nodes
    with the same work-stack discipline as the main graph's schedule
    (refs use the FunctionDef ``node:port:index`` convention), and return
    the outputs in ``output_args`` order via the ``ret`` map. Nested
    calls recurse — call DEPTH is bounded by the program's nesting,
    unlike the node-chain depth the iterative evaluator protects
    against."""
    env = dict(zip(fdef.input_args, call_args))
    by_name = {n.name: n for n in fdef.nodes}
    values: Dict[str, object] = {}

    def resolve(ref):
        if ref.startswith("^"):
            return None
        base = ref.split(":")[0]
        if base in env and base not in by_name:
            return env[base]
        return _resolve_fn_ref(ref, values[base], by_name[base].op)

    def materialize(target: str):
        # NOTE: mirrors the main graph's DFS (_schedule): same
        # push/expanded cycle discipline and Const/NoOp cases, with the
        # FUNCTION ref convention — a change to either traversal must be
        # applied to both
        stack = [target]
        expanded = set()
        while stack:
            nm = stack[-1]
            if nm in values or (nm in env and nm not in by_name):
                stack.pop()
                continue
            node = by_name.get(nm)
            if node is None:
                raise ValueError(
                    f"function {fdef.name!r}: ref to unknown node {nm!r}"
                )
            if node.op == "Const":
                values[nm] = node.attrs["value"].tensor
            elif node.op == "NoOp":
                values[nm] = None
            else:
                refs = [r for r in node.inputs if not r.startswith("^")]
                deps = [
                    r.split(":")[0] for r in refs
                    if not (r.split(":")[0] in env
                            and r.split(":")[0] not in by_name)
                ]
                pending = [d for d in deps if d not in values]
                if pending:
                    if nm in expanded:
                        raise ValueError(
                            f"function {fdef.name!r} contains a cycle "
                            f"through {nm!r}"
                        )
                    expanded.add(nm)
                    stack.extend(pending)
                    continue
                if node.op in ("PartitionedCall", "StatefulPartitionedCall"):
                    values[nm] = _eval_call(
                        node, [resolve(r) for r in refs], library, ctx,
                    )
                else:
                    values[nm] = _eval_node(
                        node, [resolve(r) for r in refs], ctx,
                    )
            stack.pop()
        return None

    outs = []
    for out_name in fdef.output_args:
        ref = fdef.ret.get(out_name)
        if ref is None:
            raise ValueError(
                f"function {fdef.name!r}: output {out_name!r} missing "
                "from the ret map"
            )
        base = ref.split(":")[0]
        if not (base in env and base not in by_name):
            materialize(base)
        outs.append(resolve(ref))
    return outs[0] if len(outs) == 1 else tuple(outs)


def _eval_call(node, args, library, ctx):
    """Dispatch a PartitionedCall/StatefulPartitionedCall node to its
    library function."""
    f = node.attrs.get("f")
    fd = library.get(f.func) if f and f.func else None
    if fd is None:
        raise ValueError(
            f"call node {node.name!r}: function "
            f"{(f.func if f else None)!r} not in the graph library"
        )
    if len(args) != len(fd.input_args):
        raise ValueError(
            f"call node {node.name!r}: {len(args)} args for function "
            f"{fd.name!r} expecting {len(fd.input_args)}"
        )
    return _eval_function(fd, args, library, ctx)


def _select_output(v, ref: str):
    """Resolve a data ref against an evaluated node value: multi-output
    tuples select by the ref's ``:k`` suffix (default 0)."""
    if isinstance(v, tuple):
        idx = 0
        if ":" in ref:
            suffix = ref.rsplit(":", 1)[1]
            if suffix.isdigit():
                idx = int(suffix)
        if idx >= len(v):
            raise ValueError(
                f"ref {ref!r} selects output {idx} but the node has "
                f"{len(v)} outputs"
            )
        return v[idx]
    return v


def _base(ref: str) -> str:
    """Strip the ':output-index' suffix and control '^' prefix from a
    NodeDef input reference."""
    ref = ref[1:] if ref.startswith("^") else ref
    return ref.split(":")[0]


def _nhwc(n: "GraphNode") -> None:
    fmt = n.attrs.get("data_format")
    if fmt is not None and fmt.s not in (None, b"NHWC"):
        raise ValueError(
            f"{n.op} node {n.name!r}: only NHWC data_format is supported "
            f"(got {fmt.s!r}) — the importer's layouts are NHWC"
        )


def _pad_str(n: "GraphNode") -> str:
    p = n.attrs.get("padding")
    pad = (p.s or b"VALID").decode() if p else "VALID"
    if pad not in ("SAME", "VALID"):
        raise ValueError(
            f"{n.op} node {n.name!r}: padding {pad!r} unsupported "
            "(SAME/VALID only)"
        )
    return pad



# ---------------------------------------------------------------------------
# device values: the evaluation context
# ---------------------------------------------------------------------------

_COMPUTE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}
# operands whose contraction takes f32 accumulation under a compute dtype
_SMALL_FLOATS = (torch.bfloat16, torch.float16, torch.float32)


def _np_to_torch(a, device) -> torch.Tensor:
    """A host value (numpy array or scalar) as a tensor on ``device``, of
    the same dtype (bfloat16 crosses as its 16-bit pattern)."""
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a)
    if dt.bfloat16 is not None and a.dtype == dt.bfloat16.np_dtype:
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _is_f32(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.dtype == torch.float32
    return np.asarray(v).dtype == np.float32


def _filter(t: torch.Tensor, form: Optional[str]) -> torch.Tensor:
    """A TF filter in the layout ``F.conv2d`` reads: ``"conv"`` HWIO →
    ``[O, I, kh, kw]``, ``"dw"`` depthwise ``[H, W, C, M]`` → ``[C·M, 1,
    kh, kw]``, both in ``channels_last`` memory; ``None`` as it is."""
    if form == "conv":
        return t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    if form == "dw":
        h, w, c, m = t.shape
        return t.reshape(h, w, 1, c * m).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
    return t


class _Ctx:
    """What an imported program evaluates against: its device, its
    compute dtype, and the device copies of the values fixed at import.

    :meth:`hoist` stores a value's device copy in one form — own dtype or
    cast, as is or as a conv filter — keyed by the value's identity;
    :meth:`tensor` returns that copy when the evaluator asks for the
    same value in the same form, and otherwise converts on the spot.
    The values themselves stay referenced (``_keep``), so the keys stay
    valid for the program's life."""

    def __init__(self, device: torch.device, compute: Optional[torch.dtype]):
        self.device = device
        self.compute = compute
        self._hoisted: Dict[tuple, torch.Tensor] = {}
        self._keep: List[object] = []
        self._counts: Dict[tuple, torch.Tensor] = {}

    def tensor(self, v, dtype: Optional[torch.dtype] = None,
               form: Optional[str] = None) -> torch.Tensor:
        hit = self._hoisted.get((id(v), dtype, form))
        if hit is not None:
            return hit
        t = v if isinstance(v, torch.Tensor) else _np_to_torch(v, self.device)
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        return _filter(t, form)

    def mxu_dtype(self, v) -> Optional[torch.dtype]:
        """The serving-precision cast of a MatMul/Conv operand: f32 →
        the compute dtype; anything else keeps its dtype."""
        return self.compute if self.compute is not None and _is_f32(v) else None

    def mxu(self, v, form: Optional[str] = None) -> torch.Tensor:
        return self.tensor(v, self.mxu_dtype(v), form)

    def hoist(self, v, dtype: Optional[torch.dtype] = None,
              form: Optional[str] = None) -> None:
        key = (id(v), dtype, form)
        if key not in self._hoisted:
            self._hoisted[key] = self.tensor(v, dtype, form)
            self._keep.append(v)

    def hoist_for(self, node: "GraphNode", pos: int, v) -> None:
        """Move ``v``, operand ``pos`` of ``node``, to the device once,
        in the form and dtype that node's evaluation reads."""
        if v is None or isinstance(v, (QuantizedTensor, _StringTensor)):
            return
        op = node.op
        if op in ("Conv2D", "DepthwiseConv2dNative"):
            form = None if pos != 1 else ("conv" if op == "Conv2D" else "dw")
            self.hoist(v, self.mxu_dtype(v), form)
        elif op in ("MatMul", "BatchMatMul", "BatchMatMulV2", "Einsum"):
            self.hoist(v, self.mxu_dtype(v))
        elif not isinstance(v, torch.Tensor):
            self.hoist(v)

    def pool_counts(self, h: int, w: int, kh: int, kw: int, sh: int,
                    sw: int) -> torch.Tensor:
        """``same_pool_counts`` as an NCHW ``[1, 1, oh, ow]`` device
        tensor, made once per shape (also when first asked for during
        shape analysis, which runs under ``FakeTensorMode``)."""
        key = (h, w, kh, kw, sh, sw)
        t = self._counts.get(key)
        if t is None:
            from torch._subclasses.fake_tensor import unset_fake_temporarily

            with unset_fake_temporarily(), torch.inference_mode(False):
                counts = np.array(same_pool_counts(h, w, kh, kw, sh, sw))
                t = torch.from_numpy(counts).to(self.device).permute(0, 3, 1, 2)
            self._counts[key] = t
        return t


def _same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """TF's SAME padding of one spatial dim: ``(before, after)``, the odd
    row or column after."""
    total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv(n: "GraphNode", x: torch.Tensor, w: torch.Tensor,
          groups: int = 1) -> torch.Tensor:
    """Conv2D / depthwise conv of NHWC ``x`` by a ``[O, I/groups, kh,
    kw]`` filter: the conv reads ``x`` as a ``channels_last`` NCHW view
    and its output goes back the same way. SAME pads symmetrically in the
    conv where TF's split is even, else through ``F.pad`` first."""
    _nhwc(n)
    strides = tuple((n.attrs["strides"].ints or [1, 1, 1, 1])[1:3])
    dil = n.attrs.get("dilations")
    dilation = tuple((dil.ints or [1, 1, 1, 1])[1:3]) if dil else (1, 1)
    pad = _pad_str(n)
    xc = x.permute(0, 3, 1, 2)
    padding = (0, 0)
    if pad == "SAME":
        top, bottom = _same_pads(int(xc.shape[2]), int(w.shape[2]), strides[0], dilation[0])
        left, right = _same_pads(int(xc.shape[3]), int(w.shape[3]), strides[1], dilation[1])
        if top == bottom and left == right:
            padding = (top, left)
        else:
            xc = F.pad(xc, (left, right, top, bottom))
    y = F.conv2d(xc, w, stride=strides, padding=padding, dilation=dilation,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _strided_slice(n: "GraphNode", x, begin, end, strides):
    """StridedSlice with concrete begin/end/strides, honoring the five
    bit masks. Covers the dominant real-graph shape idiom
    ``tf.shape(x)[0]`` (begin=[0], end=[1], shrink_axis_mask=1) and
    general python-slicing-expressible forms."""
    begin = _concrete_operand(n, "begin", begin).tolist()
    end = _concrete_operand(n, "end", end).tolist()
    strides = _concrete_operand(n, "strides", strides).tolist()

    def mask(key: str) -> int:
        a = n.attrs.get(key)
        return int(a.i) if a and a.i is not None else 0

    bm, em = mask("begin_mask"), mask("end_mask")
    elm, nam, sam = (
        mask("ellipsis_mask"), mask("new_axis_mask"), mask("shrink_axis_mask")
    )
    idx: list = []
    for i in range(len(begin)):
        if (elm >> i) & 1:
            idx.append(Ellipsis)
        elif (nam >> i) & 1:
            idx.append(None)  # np.newaxis
        elif (sam >> i) & 1:
            idx.append(int(begin[i]))
        else:
            b = None if (bm >> i) & 1 else int(begin[i])
            e = None if (em >> i) & 1 else int(end[i])
            idx.append(slice(b, e, int(strides[i])))
    return _index(x, tuple(idx))


def _index(x, idx: tuple):
    """``x[idx]`` with numpy's basic-indexing rules; torch has no
    negative slice steps, so those dims are gathered after a plain
    ``:``."""
    if not isinstance(x, torch.Tensor) or not any(
            isinstance(i, slice) and i.step is not None and i.step < 0 for i in idx):
        return x[idx]
    consumed = sum(1 for i in idx if i is not None and i is not Ellipsis)
    plain, gathers = [], []
    in_dim = out_dim = 0
    for i in idx:
        if i is Ellipsis:
            k = x.ndim - consumed
            in_dim += k
            out_dim += k
        elif i is None:
            out_dim += 1
        elif isinstance(i, slice):
            if i.step is not None and i.step < 0:
                gathers.append((out_dim, list(range(int(x.shape[in_dim])))[i]))
                i = slice(None)
            in_dim += 1
            out_dim += 1
        else:
            in_dim += 1
        plain.append(i)
    y = x[tuple(plain)]
    for d, ids in gathers:
        y = torch.index_select(y, d, torch.as_tensor(ids, dtype=torch.long, device=y.device))
    return y


def _pool(n: "GraphNode", x: torch.Tensor, ctx: _Ctx) -> torch.Tensor:
    """MaxPool / AvgPool over NHWC. SAME pads TF's way; a MaxPool pads
    with the dtype's lowest value, and an AvgPool sums at >= f32 over the
    zero-padded input and divides by the true (edge-clipped) window
    population, ``same_pool_counts``, as TF does."""
    _nhwc(n)
    ksize = tuple(n.attrs["ksize"].ints)
    strides = tuple(n.attrs["strides"].ints)
    pad = _pad_str(n)
    if ksize[0] != 1 or ksize[3] != 1 or strides[0] != 1 or strides[3] != 1:
        raise ValueError(
            f"{n.op} node {n.name!r}: only spatial windows are supported "
            f"(ksize {list(ksize)}, strides {list(strides)})"
        )
    kh, kw, sh, sw = ksize[1], ksize[2], strides[1], strides[2]
    xc = x.permute(0, 3, 1, 2)
    h, w = int(xc.shape[2]), int(xc.shape[3])
    pads = (0, 0, 0, 0)
    if pad == "SAME":
        top, bottom = _same_pads(h, kh, sh)
        left, right = _same_pads(w, kw, sw)
        pads = (left, right, top, bottom)
    if n.op == "MaxPool":
        if any(pads):
            low = (float("-inf") if x.is_floating_point()
                   else torch.iinfo(x.dtype).min)
            xc = F.pad(xc, pads, value=low)
        return F.max_pool2d(xc, (kh, kw), (sh, sw)).permute(0, 2, 3, 1)
    # accumulate at >= f32 precision without truncating f64 graphs
    acc = torch.promote_types(x.dtype, torch.float32)
    xa = xc.to(acc)
    if any(pads):
        xa = F.pad(xa, pads)
    s = F.avg_pool2d(xa, (kh, kw), (sh, sw), divisor_override=1)
    if pad == "VALID":
        s = s / float(kh * kw)
    else:
        s = s / ctx.pool_counts(h, w, kh, kw, sh, sw).to(acc)
    return s.to(x.dtype).permute(0, 2, 3, 1)


def _resolve_compute_dtype(compute_dtype, device: torch.device):
    """Resolve the ``"auto"`` serving-precision default: bfloat16 on a
    CUDA device, f32-faithful (``None``) on the CPU, where the parity
    tests compare against TF and the reference package running the same
    bytes. Pass ``None`` explicitly for f32-faithful serving on any
    device. Returns a torch dtype or None."""
    if compute_dtype == "auto":
        compute_dtype = "bfloat16" if device.type == "cuda" else None
        if compute_dtype == "bfloat16":
            # "auto" silently changing imported-graph numerics against TF
            # is worth one log line per process
            global _auto_bf16_logged
            if not _auto_bf16_logged:
                _auto_bf16_logged = True
                logger.info(
                    "compute_dtype='auto' resolved to bfloat16 on the %s "
                    "device: imported MatMul/Conv ops serve in bf16 with "
                    "f32 accumulation and will not bit-match TF; pass "
                    "compute_dtype=None for f32-faithful serving",
                    device.type,
                )
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    name = str(compute_dtype).removeprefix("torch.")
    if name not in _COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype {compute_dtype!r}: use 'auto', None or one of "
            f"{sorted(_COMPUTE_DTYPES)}"
        )
    return _COMPUTE_DTYPES[name]


_auto_bf16_logged = False

_LEAVES = ("Placeholder", "Const", "VarHandleOp", "NoOp")
_CALLS = ("PartitionedCall", "StatefulPartitionedCall")


def _data_refs(node: "GraphNode") -> List[str]:
    return [r for r in node.inputs if not r.startswith("^")]


def _schedule(by_name: Dict[str, "GraphNode"], targets: Sequence[str]) -> List[str]:
    """The nodes the targets need, each after its data inputs: an
    explicit DFS work stack, not recursion (a frozen graph's longest op
    chain can exceed Python's ~1000-frame limit). Raises the reference's
    ``ValueError`` for a cycle or a ref to a missing node."""
    order: List[str] = []
    done = set()
    for target in targets:
        stack = [target]
        expanded = set()
        while stack:
            nm = stack[-1]
            if nm in done:
                stack.pop()
                continue
            node = by_name.get(nm)
            if node is None:
                raise ValueError(
                    f"graph references node {nm!r} which does not exist"
                )
            if node.op not in _LEAVES:
                pending = [d for d in (_base(r) for r in _data_refs(node))
                           if d not in done]
                if pending:
                    if nm in expanded:
                        # nm's deps were pushed once already; being back
                        # here with deps still missing means a dep chain
                        # loops back through nm
                        raise ValueError(
                            f"GraphDef contains a cycle through {nm!r}"
                        )
                    expanded.add(nm)
                    stack.extend(pending)
                    continue
            done.add(nm)
            order.append(nm)
            stack.pop()
    return order


def program_from_graphdef(
    nodes: Sequence[GraphNode],
    fetches: Optional[Sequence[str]] = None,
    relax_lead_dim: bool = False,
    quantize_weights: bool = False,
    compute_dtype: Optional[str] = "auto",
    variables: Optional[Dict[str, np.ndarray]] = None,
    device=None,
) -> Program:
    """Lower decoded GraphDef nodes to a :class:`Program` on ``device``
    (default ``config.device``, the card).

    ``fetches`` defaults to the graph's sinks (non-Placeholder nodes no
    other node consumes). ``relax_lead_dim=True`` widens each
    placeholder's leading dim to Unknown so fixed-shape frozen graphs run
    over arbitrary block row counts. ``quantize_weights=True`` stores
    float Const filters feeding Conv2D/depthwise/MatMul as symmetric
    per-channel int8 (``ops/quantize.py``; a MatMul then launches the
    ``int8_matmul`` kernel on the card).

    ``compute_dtype`` (e.g. ``"bfloat16"``) is a serving-precision
    policy for the matmul-class ops only: MatMul/Conv2D/depthwise/
    BatchMatMul/Einsum contract in that dtype and return float32; all
    other ops stay exact. The default ``"auto"`` serves bfloat16 on a
    CUDA device and f32-faithful on the CPU; pass ``None`` for
    f32-faithful everywhere (:func:`_resolve_compute_dtype`).

    ``variables`` binds VarHandleOp nodes to concrete values (keyed by
    the op's ``shared_name``, falling back to the node name): the handle
    evaluates to the value and ``ReadVariableOp`` is an identity.
    ``load_saved_model`` fills this from the checkpoint bundle
    (clean-room, ``bundle.py``).

    The nodes that depend on no placeholder are evaluated here, once,
    and what the per-call nodes read of them moves to the device here,
    in the form they read it (module docstring). Errors the reference
    raises when the program runs (a cycle, a missing node, a string
    consumed) are raised when it runs here too.
    """
    device = resolve_device(device)
    ctx = _Ctx(device, _resolve_compute_dtype(compute_dtype, device))
    by_name = {n.name: n for n in nodes}
    library = getattr(nodes, "library", {}) or {}
    consumed = set()
    for n in nodes:
        for ref in n.inputs:
            consumed.add(_base(ref))
    if fetches is None:
        fetches = [
            n.name
            for n in nodes
            if n.name not in consumed and n.op not in ("Placeholder", "NoOp")
        ]
        if not fetches:
            raise ValueError("GraphDef has no sink nodes; pass fetches=")
    missing = [f for f in fetches if _base(f) not in by_name]
    if missing:
        raise ValueError(
            f"fetch(es) {missing} not in graph; nodes: {sorted(by_name)}"
        )
    for f in fetches:
        fnode = by_name[_base(f)]
        if fnode.op == "Const" and isinstance(
            (fnode.attrs.get("value").tensor
             if fnode.attrs.get("value") is not None else None),
            _StringTensor,
        ):
            raise ValueError(
                f"fetch {f!r} is a string Const — string values are not "
                "executable on device (host-only; "
                "≙ datatypes.scala:577-581)"
            )
        # same producer rule as consumer refs: a ':k>0' fetch of a
        # single-output node would silently receive output :0
        if ":" in f:
            suffix = f.rsplit(":", 1)[1]
            if not suffix.isdigit():
                raise ValueError(
                    f"fetch {f!r}: malformed output suffix {suffix!r} "
                    "(expected an integer, e.g. 'split:1')"
                )
            if int(suffix) > 0:
                producer = by_name[_base(f)]
                if producer.op not in _MULTI_OUTPUT:
                    raise ValueError(
                        f"fetch {f!r} selects output {suffix} of "
                        f"single-output op {producer.op!r}; only "
                        f"multi-output ops ({sorted(_MULTI_OUTPUT)}) "
                        "expose outputs past :0"
                    )
                if int(suffix) >= _num_outputs(producer, library):
                    raise ValueError(
                        f"fetch {f!r} selects output {suffix} but "
                        f"{producer.op} node {producer.name!r} has "
                        f"{_num_outputs(producer, library)} outputs"
                    )

    # restrict validation + program inputs to the nodes the evaluator
    # can actually reach from the fetches through DATA refs (the
    # evaluator never follows control deps) — a SavedModel main graph
    # carries a dead saver subgraph (SaveV2/RestoreV2/StringJoin + a
    # string filename Placeholder) that must not poison the import
    reachable = set()
    _stack = [_base(f) for f in fetches]
    while _stack:
        _nm = _stack.pop()
        if _nm in reachable or _nm not in by_name:
            continue
        reachable.add(_nm)
        _stack.extend(_base(r) for r in _data_refs(by_name[_nm]))

    # output :k>0 is legal only for registered MULTI-OUTPUT ops; for any
    # other producer (FusedBatchNorm's batch stats, …) it would silently
    # receive output :0 — reject it up front. Only REACHABLE consumers
    # matter: dead saver subgraphs consume :1 outputs of ops the
    # evaluator never touches
    for n in nodes:
        if n.name not in reachable:
            continue
        for ref in n.inputs:
            if not ref.startswith("^") and ":" in ref:
                idx = ref.rsplit(":", 1)[1]
                if idx.isdigit() and int(idx) > 0:
                    producer = by_name.get(_base(ref))
                    if producer is None or producer.op not in _MULTI_OUTPUT:
                        raise ValueError(
                            f"node {n.name!r} consumes output {ref!r}; "
                            "only multi-output ops "
                            f"({sorted(_MULTI_OUTPUT)}) expose outputs "
                            "past :0"
                        )
                    if int(idx) >= _num_outputs(producer, library):
                        raise ValueError(
                            f"node {n.name!r} consumes output {ref!r} but "
                            f"{producer.op} node {producer.name!r} has "
                            f"{_num_outputs(producer, library)} outputs"
                        )

    # placeholders → program inputs (reachable only: a SavedModel's
    # saver filename placeholder must not become a program input)
    inputs: List[TensorSpec] = []
    consts: Dict[str, object] = {}
    for n in nodes:
        if n.name not in reachable:
            continue
        if n.op == "Placeholder":
            a = n.attrs.get("dtype")
            dtype = _TF_DTYPES.get(a.type if a else 1, dt.float32)
            sh = n.attrs["shape"].shape if "shape" in n.attrs else None
            if sh is None:
                dims: Tuple = (Unknown,)
            else:
                dims = tuple(Unknown if d < 0 else d for d in sh)
            if relax_lead_dim and dims:
                dims = (Unknown,) + tuple(dims[1:])
            inputs.append(TensorSpec(n.name, dtype, Shape(dims)))
        elif n.op == "Const":
            consts[n.name] = n.attrs["value"].tensor
        elif n.op == "VarHandleOp":
            sn = n.attrs.get("shared_name")
            key = (
                sn.s.decode("utf-8") if sn is not None and sn.s else n.name
            )
            if variables is not None and key in variables:
                consts[n.name] = np.asarray(variables[key])
            elif variables is not None and n.name in variables:
                consts[n.name] = np.asarray(variables[n.name])
            else:
                raise UnresolvedVariableError(
                    f"graph contains variable {key!r} (VarHandleOp node "
                    f"{n.name!r}) with no bound value; pass "
                    "variables={name: array} — load_saved_model restores "
                    "them from the checkpoint bundle automatically "
                    "(tensorframes_tpu_torch.bundle)"
                )

    def _walk_function_nodes(seen_fns):
        """Yield every node of every library function reachable from
        the main graph's call nodes (nested calls included) so the
        unsupported-op gate covers function bodies too."""
        pending = []
        for n in nodes:
            if n.name not in reachable:
                continue
            if n.op in _CALLS:
                fattr = n.attrs.get("f")
                if fattr is None or not fattr.func:
                    raise ValueError(
                        f"call node {n.name!r} has no function attr 'f' — "
                        "malformed call structure fails at import, not "
                        "first execution"
                    )
                pending.append(fattr.func)
        while pending:
            fname = pending.pop()
            if fname in seen_fns:
                continue
            seen_fns.add(fname)
            fd = library.get(fname)
            if fd is None:
                raise ValueError(
                    f"call to function {fname!r} but the GraphDef library "
                    f"only defines {sorted(library)}"
                )
            for bn in fd.nodes:
                if bn.op in _CALLS:
                    f2 = bn.attrs.get("f")
                    if f2 is None or not f2.func:
                        raise ValueError(
                            f"call node {bn.name!r} (in function "
                            f"{fname!r}) has no function attr 'f'"
                        )
                    pending.append(f2.func)
                yield bn

    function_nodes = list(_walk_function_nodes(set()))
    unsupported = sorted(
        {
            n.op
            for n in [x for x in nodes if x.name in reachable] + function_nodes
            if n.op not in SUPPORTED_OPS
        }
    )
    if unsupported:
        raise ValueError(
            f"GraphDef contains unsupported op(s) {unsupported}; supported: "
            f"{sorted(_STRUCTURAL)}, "
            f"{sorted(_BINARY)}, {sorted(_UNARY)}, {sorted(_REDUCERS)}"
        )

    if library:
        _check_call_cycles(nodes, reachable, library)

    if quantize_weights:
        if library:
            raise ValueError(
                "quantize_weights=True is not supported for graphs with a "
                "function library (PartitionedCall bodies): the weight "
                "planner only sees main-graph consumers, so quantization "
                "would silently no-op. Freeze/inline the graph first "
                "(convert_variables_to_constants_v2)."
            )
        _quantize_consts(nodes, by_name, consts, device)

    fetch_list = list(fetches)
    try:
        order = _schedule(by_name, [_base(f) for f in fetch_list])
        deferred = None
    except ValueError as e:  # raised when the program runs, as the reference does
        order, deferred = [], e

    # the nodes that depend on no placeholder: evaluated once, here. A
    # node whose evaluation fails is left to the call, which raises.
    static: Dict[str, object] = {}
    with torch.no_grad():
        for nm in order:
            node = by_name[nm]
            if node.op in ("Const", "VarHandleOp"):
                static[nm] = consts[nm]
            elif node.op == "NoOp":
                static[nm] = None
            elif node.op != "Placeholder" and all(
                    _base(r) in static for r in _data_refs(node)):
                args = [_select_output(static[_base(r)], r) for r in _data_refs(node)]
                try:
                    static[nm] = (_eval_call(node, args, library, ctx)
                                  if node.op in _CALLS else _eval_node(node, args, ctx))
                except Exception:  # noqa: BLE001 - re-raised by the call
                    pass
    dynamic = [nm for nm in order if nm not in static]
    refs_of = {nm: _data_refs(by_name[nm]) for nm in dynamic}
    # device copies of what the per-call nodes read of the static values,
    # and a count of each value's readers, so a call drops it after the
    # last one
    uses: Dict[str, int] = {}
    for nm in dynamic:
        for pos, r in enumerate(refs_of[nm]):
            b = _base(r)
            if b in static:
                ctx.hoist_for(by_name[nm], pos, _select_output(static[b], r))
            else:
                uses[b] = uses.get(b, 0) + 1
    for f in fetch_list:
        uses[_base(f)] = uses.get(_base(f), 0) + 1  # fetched: never dropped
    for bn in function_nodes:
        if bn.op == "Const" and isinstance(bn.attrs["value"].tensor, np.ndarray):
            ctx.hoist(bn.attrs["value"].tensor)

    def fn(feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if deferred is not None:
            raise deferred
        values: Dict[str, object] = {}
        left = dict(uses)
        for nm in dynamic:
            node = by_name[nm]
            if node.op == "Placeholder":
                values[nm] = ctx.tensor(feeds[nm])
                continue
            refs = refs_of[nm]
            args = [
                _select_output(values[b] if b in values else static[b], r)
                for r, b in ((r, _base(r)) for r in refs)
            ]
            if node.op in _CALLS:
                values[nm] = _eval_call(node, args, library, ctx)
            else:
                values[nm] = _eval_node(node, args, ctx)
            del args
            for r in refs:
                b = _base(r)
                if b in values:
                    left[b] -= 1
                    if not left[b]:
                        del values[b]

        out = {}
        for f in fetch_list:
            b = _base(f)
            v = _select_output(values[b] if b in values else static[b], f)
            if isinstance(v, _StringTensor):
                raise ValueError(
                    f"fetch {f!r} is a string Const — string values are "
                    "not executable on device (host-only; "
                    "≙ datatypes.scala:577-581)"
                )
            if isinstance(v, QuantizedTensor):  # directly-fetched weight
                v = v.dequantize(torch.float32)
            # shape-arithmetic fetches come back as host numpy
            out[f] = v if isinstance(v, torch.Tensor) else ctx.tensor(v)
        return out

    return Program(fn, inputs, fetch_order=fetch_list)


def _check_call_cycles(nodes, reachable, library) -> None:
    """A (malformed) recursive or mutually-recursive library would
    recurse unboundedly at the first call: raise the module's
    ``ValueError`` at import instead. DFS with an ACTIVE-CHAIN stack,
    rooted at the main graph's call nodes."""

    def _called(fd):
        return [
            bn.attrs["f"].func
            for bn in fd.nodes
            if bn.op in _CALLS
            and bn.attrs.get("f") is not None
            and bn.attrs["f"].func
        ]

    roots = [
        n.attrs["f"].func
        for n in nodes
        if n.name in reachable and n.op in _CALLS
    ]
    state: Dict[str, int] = {}  # 0 = on the active chain, 1 = done
    for root in roots:
        if state.get(root) == 1:
            continue
        chain = [root]
        stack = [(root, iter(_called(library[root])))]
        state[root] = 0
        while stack:
            fname, it = stack[-1]
            for callee in it:
                if callee not in library:
                    continue  # missing fns already raised in the walk
                st = state.get(callee)
                if st == 0:
                    cycle = chain[chain.index(callee):] + [callee]
                    raise ValueError(
                        "GraphDef function library has a call cycle: "
                        + " -> ".join(cycle)
                        + "; recursive tf.functions cannot lower to "
                        "a static XLA graph"
                    )
                if st is None:
                    state[callee] = 0
                    chain.append(callee)
                    stack.append((callee, iter(_called(library[callee]))))
                    break
            else:
                state[fname] = 1
                stack.pop()
                chain.pop()


def _quantize_consts(nodes, by_name, consts, device) -> None:
    """Replace the float Const filters of Conv2D/depthwise/MatMul by
    per-channel int8 :class:`QuantizedTensor` on ``device``, in place.

    Per-consumer channel spec: Conv2D filters [H,W,I,O] keep the output
    axis; depthwise [H,W,C,M] channels span BOTH trailing axes (one
    scale per (channel, multiplier) — axis -1 alone would collapse to
    per-tensor when M==1); MatMul honors transpose_b. Conflicting specs
    for a shared weight skip quantization."""
    from .ops.quantize import quantize

    def resolve_const(name: str) -> Optional[str]:
        """Follow Identity chains (the freezer leaves
        ReadVariableOp→Identity wrappers over each folded Const)."""
        seen = set()
        while name in by_name and name not in seen:
            seen.add(name)
            node = by_name[name]
            if node.op != "Identity":
                break
            refs = _data_refs(node)
            if not refs:
                break
            name = _base(refs[0])
        return name if name in consts else None

    weight_plan: Dict[str, object] = {}
    conflicted = set()
    for n in nodes:
        if n.op in ("Conv2D", "DepthwiseConv2dNative", "MatMul"):
            data_refs = _data_refs(n)
            if len(data_refs) < 2:
                continue
            wn = resolve_const(_base(data_refs[1]))
            if wn is None:
                continue
            w = consts[wn]
            if not isinstance(w, np.ndarray) or w.ndim < 2 or not np.issubdtype(
                    w.dtype, np.floating):
                continue
            if n.op == "DepthwiseConv2dNative":
                spec: object = (2, 3)
            elif n.op == "MatMul":
                tb = n.attrs.get("transpose_b")
                spec = 0 if (tb and tb.b) else -1
            else:
                spec = -1
            if wn in weight_plan and weight_plan[wn] != spec:
                conflicted.add(wn)
            weight_plan[wn] = spec
    for wn, spec in weight_plan.items():
        if wn not in conflicted:
            w = torch.from_numpy(np.array(consts[wn]))
            consts[wn] = quantize(w, channel_axis=spec).to(device)


def _eval_node(n: GraphNode, args: List, ctx: _Ctx):
    """Evaluate one node given its already-evaluated data inputs (numpy
    host values, device tensors, tuples of either for multi-output
    producers). Operands that shape the *program* (reduction axes,
    reshape targets, Tile multiples, pad widths, …) must be host values:
    Consts, or values derived from ``Shape`` of a tensor, whose shape is
    a tuple of Python ints.

    Quantized weights (``QuantizedTensor``) are consumed natively by
    MatMul/Conv2D/DepthwiseConv2dNative — int8 enters the contraction
    and the per-channel scale multiplies the OUTPUT; every other
    consumer dequantizes."""
    name = n.name
    op = n.op
    for a in args:
        if isinstance(a, _StringTensor):
            raise ValueError(
                f"node {name!r} ({op}) consumes a string Const — string "
                "values are not executable on device (host-only; "
                "≙ datatypes.scala:577-581)"
            )
    T = ctx.tensor

    def f32_sums(*ops_) -> bool:
        """f32 accumulation and output under a compute dtype when every
        operand is a <= 32-bit float (the ones ``mxu`` may have
        narrowed); f64/int contractions keep their exact dtype."""
        return ctx.compute is not None and all(o.dtype in _SMALL_FLOATS for o in ops_)

    def widen(y: torch.Tensor, *ops_) -> torch.Tensor:
        """A conv's output in f32 where :func:`f32_sums` holds: cuDNN
        has rounded it to the compute dtype already."""
        return y.float() if f32_sums(*ops_) else y

    def contract(fn, *ops_) -> torch.Tensor:
        """A matmul-class op over the compute-dtype operands with f32
        products, sums and output where :func:`f32_sums` holds: the
        operands' values are the narrowed ones, so each product is exact
        in f32, as XLA's ``preferred_element_type=f32`` computes it."""
        if f32_sums(*ops_):
            return fn(*(o.float() for o in ops_))
        return fn(*ops_)

    if op == "MatMul":
        a, b = args
        ta = n.attrs.get("transpose_a")
        tb = n.attrs.get("transpose_b")
        if isinstance(a, QuantizedTensor):
            a = a.dequantize(torch.float32)
        a = ctx.mxu(a)
        if ta and ta.b:
            a = a.transpose(0, 1)
        if isinstance(b, QuantizedTensor):
            w = QuantizedTensor(b.q.transpose(0, 1), b.scale.transpose(0, 1)) if (
                tb and tb.b) else b
            if f32_sums(a):
                # the narrowed values in f32: the int8 kernel's f32 build
                # returns the f32 sums
                a = a.float()
            if a.dtype in (torch.bfloat16, torch.float32):
                from .ops.quantize import matmul

                return matmul(a, w)
            out = a @ w.q.to(a.dtype)
            return out * w.scale.to(out.dtype)
        b = ctx.mxu(b)
        if tb and tb.b:
            b = b.transpose(0, 1)
        return contract(torch.matmul, a, b)
    if op == "Conv2D" and isinstance(args[1], QuantizedTensor):
        x_, w_ = ctx.mxu(args[0]), args[1]
        w = _filter(w_.q.to(x_.dtype), "conv")
        out = widen(_conv(n, x_, w), x_)
        return out * w_.scale.reshape(1, 1, 1, -1).to(out.dtype)
    if op == "DepthwiseConv2dNative" and isinstance(args[1], QuantizedTensor):
        x_, w_ = ctx.mxu(args[0]), args[1]
        out = widen(
            _conv(n, x_, _filter(w_.q.to(x_.dtype), "dw"), groups=int(w_.q.shape[2])),
            x_,
        )
        return out * w_.scale.reshape(1, 1, 1, -1).to(out.dtype)
    args = [
        a.dequantize(torch.float32) if isinstance(a, QuantizedTensor) else a
        for a in args
    ]
    if op in _PASS_THROUGH:
        return args[0]
    if op in _BINARY:
        if op in _BINARY_NP and _is_concrete(*args):
            return _BINARY_NP[op](*args)
        return _BINARY[op](T(args[0]), T(args[1]))
    if op in _UNARY:
        if op in _UNARY_NP and _is_concrete(args[0]):
            return _UNARY_NP[op](args[0])
        return _UNARY[op](T(args[0]))
    if op in _REDUCERS:
        axes = _axes(_concrete_operand(n, "reduction_indices", args[1]))
        keep = n.attrs.get("keep_dims")
        return _REDUCERS[op](T(args[0]), axes, bool(keep.b) if keep else False)
    if op == "Cast":
        to = _TF_DTYPES.get(n.attrs["DstT"].type)
        if to is None:
            raise ValueError(
                f"Cast node {name!r}: unsupported DstT dtype enum "
                f"{n.attrs['DstT'].type}"
            )
        if _is_concrete(args[0]):
            return np.asarray(args[0]).astype(to.np_dtype)
        return T(args[0]).to(to.torch_dtype)
    if op == "Reshape":
        shp = tuple(
            int(d) for d in _concrete_operand(n, "shape", args[1])
        )
        return args[0].reshape(shp)
    if op == "IdentityN":
        return tuple(args)
    if op == "Split":
        # inputs: (split_dim, value); attr num_split
        ax = int(np.asarray(_concrete_operand(n, "split_dim", args[0])))
        num = int(n.attrs["num_split"].i)
        return tuple(torch.tensor_split(T(args[1]), num, dim=ax))
    if op == "SplitV":
        # inputs: (value, size_splits, split_dim); attr num_split
        sizes = [
            int(s) for s in np.asarray(
                _concrete_operand(n, "size_splits", args[1])
            )
        ]
        ax = int(np.asarray(_concrete_operand(n, "split_dim", args[2])))
        x_ = T(args[0])
        if any(s < 0 for s in sizes):  # one -1 infers its size
            total = int(x_.shape[ax])
            known = sum(s for s in sizes if s >= 0)
            sizes = [s if s >= 0 else total - known for s in sizes]
        return tuple(torch.split(x_, sizes, dim=ax))
    if op == "Unpack":
        ax_attr = n.attrs.get("axis")
        ax = int(ax_attr.i) if ax_attr and ax_attr.i is not None else 0
        return tuple(torch.unbind(T(args[0]), dim=ax))
    if op == "TopKV2":
        kk = int(np.asarray(_concrete_operand(n, "k", args[1])))
        vals_tk, idx_tk = torch.topk(T(args[0]), kk, dim=-1)
        return (vals_tk, idx_tk.to(torch.int32))
    if op == "Slice":
        begin = [int(d) for d in np.asarray(
            _concrete_operand(n, "begin", args[1])
        )]
        size = [int(d) for d in np.asarray(
            _concrete_operand(n, "size", args[2])
        )]
        x_ = args[0]
        lims = []
        for i, (b, s) in enumerate(zip(begin, size)):
            e = b + (s if s >= 0 else int(x_.shape[i]) - b)
            if b < 0 or e > x_.shape[i]:
                raise ValueError(
                    f"Slice node {name!r}: begin+size {b}+{s} out of "
                    f"range for dim {i} of size {x_.shape[i]} (TF "
                    "rejects this; no silent clipping)"
                )
            lims.append(e)
        sl = tuple(slice(b, e) for b, e in zip(begin, lims))
        return x_[sl]
    if op == "ZerosLike":
        if _is_concrete(args[0]):
            return np.zeros_like(args[0])
        return torch.zeros_like(T(args[0]))
    if op == "OnesLike":
        if _is_concrete(args[0]):
            return np.ones_like(args[0])
        return torch.ones_like(T(args[0]))
    if op == "BroadcastTo":
        shp = tuple(
            int(d) for d in np.asarray(
                _concrete_operand(n, "shape", args[1])
            )
        )
        if _is_concrete(args[0]):
            return np.broadcast_to(args[0], shp)
        return torch.broadcast_to(T(args[0]), shp)
    if op == "OneHot":
        depth = int(np.asarray(_concrete_operand(n, "depth", args[1])))
        on_v, off_v = T(args[2]), T(args[3])
        ax_attr = n.attrs.get("axis")
        ax = int(ax_attr.i) if ax_attr is not None and ax_attr.i is not None else -1
        idx = T(args[0])
        out_dt = torch.promote_types(on_v.dtype, off_v.dtype)
        oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)).to(out_dt)
        if ax != -1:
            oh = oh.movedim(-1, ax)
        return (oh * on_v + (1 - oh) * off_v).to(out_dt)
    if op in ("Cumsum", "Cumprod"):
        ax = int(np.asarray(_concrete_operand(n, "axis", args[1])))
        exclusive = n.attrs.get("exclusive")
        reverse = n.attrs.get("reverse")
        if (exclusive and exclusive.b) or (reverse and reverse.b):
            raise ValueError(
                f"{op} node {name!r}: exclusive/reverse modes unsupported"
            )
        if _is_concrete(args[0]):
            # shape-arithmetic chains (cumprod of a Shape = strides)
            # must stay host-concrete
            fn_np = np.cumsum if op == "Cumsum" else np.cumprod
            return fn_np(np.asarray(args[0]), axis=ax)
        x_ = T(args[0])
        fn_ = torch.cumsum if op == "Cumsum" else torch.cumprod
        return fn_(x_, dim=ax).to(x_.dtype)
    if op == "Rank":
        return np.asarray(len(args[0].shape), np.int32)
    if op == "Size":
        ot = n.attrs.get("out_type")
        out_dt_ = _TF_DTYPES.get(ot.type, dt.int32) if ot is not None else dt.int32
        size = 1
        for d in args[0].shape:
            size *= int(d)
        return np.asarray(size, out_dt_.np_dtype)
    if op == "LeakyRelu":
        al = n.attrs.get("alpha")
        if al is None:
            alpha = 0.2  # attr absent entirely: TF's op-def default
        else:
            # proto3 omits 0.0 from the wire, so a PRESENT attr with no
            # f field means an explicit alpha=0.0, not the default
            alpha = float(al.f) if al.f is not None else 0.0
        x_ = T(args[0])
        return torch.where(x_ > 0, x_, x_ * alpha)
    if op == "GatherV2":
        params_, indices, axis = args
        bd = n.attrs.get("batch_dims")
        if bd and bd.i:
            raise ValueError(
                f"GatherV2 node {name!r}: batch_dims != 0 is unsupported"
            )
        ax = int(np.asarray(_concrete_operand(n, "axis", axis)))
        if _is_concrete(params_, indices):
            return np.take(params_, np.asarray(indices), axis=ax)
        p_, i_ = T(params_), T(indices)
        ax %= p_.ndim
        out = torch.index_select(p_, ax, i_.reshape(-1).long())
        return out.reshape(tuple(p_.shape[:ax]) + tuple(i_.shape) + tuple(p_.shape[ax + 1:]))
    if op == "Einsum":
        eq = n.attrs["equation"].s.decode()
        return contract(lambda *o: torch.einsum(eq, *o), *(ctx.mxu(a) for a in args))
    if op == "Transpose":
        perm = tuple(
            int(d) for d in np.asarray(_concrete_operand(n, "perm", args[1]))
        )
        return T(args[0]).permute(perm)
    if op in ("Select", "SelectV2"):
        c, xv, yv = (T(a) for a in args)
        if op == "Select" and c.ndim == 1 and xv.ndim > 1:
            # v1 Select: a vector condition picks whole ROWS of x/y
            c = c.reshape((-1,) + (1,) * (xv.ndim - 1))
        return torch.where(c, xv, yv)
    if op in ("BatchMatMulV2", "BatchMatMul"):
        a, b = (ctx.mxu(v) for v in args)
        adj_x, adj_y = n.attrs.get("adj_x"), n.attrs.get("adj_y")
        if adj_x and adj_x.b:
            a = a.transpose(-1, -2)
        if adj_y and adj_y.b:
            b = b.transpose(-1, -2)
        return contract(torch.matmul, a, b)
    if op == "Conv2D":
        x_, w_ = ctx.mxu(args[0]), ctx.mxu(args[1], "conv")
        return widen(_conv(n, x_, w_), x_, w_)
    if op == "DepthwiseConv2dNative":
        x_, w_ = ctx.mxu(args[0]), ctx.mxu(args[1], "dw")
        return widen(_conv(n, x_, w_, groups=int(args[1].shape[2])), x_, w_)
    if op in ("MaxPool", "AvgPool"):
        return _pool(n, T(args[0]), ctx)
    if op == "BiasAdd":
        _nhwc(n)
        return T(args[0]) + T(args[1])
    if op in ("ConcatV2", "Concat"):
        # axis is a DATA input: LAST for ConcatV2, FIRST for the v1 form
        ax_val = args[-1] if op == "ConcatV2" else args[0]
        ax = int(_concrete_operand(n, "axis", ax_val))
        vals_cat = args[:-1] if op == "ConcatV2" else args[1:]
        return torch.cat([T(v) for v in vals_cat], dim=ax)
    if op == "Squeeze":
        dims_a = n.attrs.get("squeeze_dims") or n.attrs.get("axis")
        dims = tuple(dims_a.ints) if dims_a and dims_a.ints else None
        if _is_concrete(args[0]):
            return np.squeeze(args[0], axis=dims)
        x_ = T(args[0])
        return x_.squeeze() if dims is None else x_.squeeze(dims)
    if op in ("Pad", "PadV2"):
        pads = [
            tuple(int(x) for x in row)
            for row in _concrete_operand(n, "paddings", args[1])
        ]
        cval = 0.0
        if op == "PadV2":
            cval = float(_concrete_operand(n, "pad value", args[2]))
        flat: List[int] = []
        for before, after in reversed(pads):
            flat += [before, after]
        return F.pad(T(args[0]), flat, value=cval)
    if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
        # inference form (TF1-era frozen graphs keep the op
        # un-decomposed): y = (x - mean) * rsqrt(var + eps) * scale
        # + offset over NHWC channels. Output :0 only — consumers of
        # :1/:2 are rejected at import. The op's is_training DEFAULT is
        # true, so a missing attr (strip_default_attrs) means training.
        tr = n.attrs.get("is_training")
        if tr is None or tr.b:
            raise ValueError(
                f"{op} node {name!r}: is_training=true (explicit or by "
                "TF default) is not executable in a frozen graph"
            )
        _nhwc(n)
        eps_a = n.attrs.get("epsilon")
        eps = eps_a.f if eps_a and eps_a.f is not None else 1e-4
        xb, scale, offset, mean, var = (T(a) for a in args[:5])
        inv = scale * (1.0 / torch.sqrt(var + eps))
        return (xb - mean) * inv + offset
    # ---- dynamic-shape tier (TF1 idioms; kmeans.py:28-45) ----
    if op == "Shape":
        out_a = n.attrs.get("out_type")
        out_dt = _TF_DTYPES.get(out_a.type if out_a else 3, dt.int32)
        # a tensor's shape is host integers: this folds the dynamic-Tile
        # idiom into a static program
        return np.asarray([int(d) for d in args[0].shape], out_dt.np_dtype)
    if op == "Pack":
        ax_a = n.attrs.get("axis")
        ax = int(ax_a.i) if ax_a and ax_a.i is not None else 0
        if _is_concrete(*args):
            return np.stack([np.asarray(a) for a in args], axis=ax)
        return torch.stack([T(a) for a in args], dim=ax)
    if op == "ExpandDims":
        ax = int(_concrete_operand(n, "dim", args[1]))
        if _is_concrete(args[0]):
            return np.expand_dims(args[0], ax)
        x_ = T(args[0])
        return x_.unsqueeze(ax if ax >= 0 else x_.ndim + 1 + ax)
    if op == "Tile":
        mult = tuple(
            int(m) for m in _concrete_operand(n, "multiples", args[1])
        )
        if _is_concrete(args[0]):
            return np.tile(args[0], mult)
        return torch.tile(T(args[0]), mult)
    if op == "StridedSlice":
        return _strided_slice(n, *args[:4])
    if op == "Fill":
        dims = tuple(int(d) for d in _concrete_operand(n, "dims", args[0]))
        if _is_concrete(args[1]):
            return np.full(dims, np.asarray(args[1]))
        return T(args[1]).reshape(()).expand(dims).clone()
    if op == "Range":
        start = _concrete_operand(n, "start", args[0])
        limit = _concrete_operand(n, "limit", args[1])
        delta = _concrete_operand(n, "delta", args[2])
        return np.arange(
            start[()] if start.ndim == 0 else start,
            limit[()] if limit.ndim == 0 else limit,
            delta[()] if delta.ndim == 0 else delta,
        )
    if op in ("ArgMin", "ArgMax"):
        ax = int(_concrete_operand(n, "dimension", args[1])) if len(args) > 1 else 0
        out_a = n.attrs.get("output_type")
        out_dt = _TF_DTYPES.get(out_a.type if out_a else 9, dt.int64)
        if _is_concrete(args[0]):
            red = np.argmin if op == "ArgMin" else np.argmax
            return red(args[0], axis=ax).astype(out_dt.np_dtype)
        red_t = torch.argmin if op == "ArgMin" else torch.argmax
        return red_t(T(args[0]), dim=ax).to(out_dt.torch_dtype)
    if op == "AddN":
        if not _is_concrete(*args):
            args = [T(a) for a in args]
        total = args[0]
        for a in args[1:]:
            total = total + a
        return total
    if op == "ReverseV2":
        axes = _axes(_concrete_operand(n, "axis", args[1]))
        return torch.flip(T(args[0]), dims=axes)
    if op == "GatherNd":
        # index tuples along the last dim select slices of x
        x_, idx = T(args[0]), T(args[1]).long()
        return x_[tuple(idx.movedim(-1, 0))]
    if op == "MirrorPad":
        pads = np.asarray(_concrete_operand(n, "paddings", args[1]))
        mode_a = n.attrs.get("mode")
        mode = (mode_a.s or b"REFLECT").decode("utf-8") if mode_a else "REFLECT"
        x_ = T(args[0])
        for d, (before, after) in enumerate(pads.tolist()):
            if before or after:
                ids = _mirror_indices(int(x_.shape[d]), int(before), int(after),
                                      mode == "REFLECT")
                x_ = torch.index_select(x_, d, torch.as_tensor(ids, device=x_.device))
        return x_
    if op == "MatrixBandPart":
        x_ = T(args[0])
        lower = int(_concrete_operand(n, "num_lower", args[1]))
        upper = int(_concrete_operand(n, "num_upper", args[2]))
        m, k = int(x_.shape[-2]), int(x_.shape[-1])
        i = torch.arange(m, device=x_.device)[:, None]
        j = torch.arange(k, device=x_.device)[None, :]
        keep = torch.ones((m, k), dtype=torch.bool, device=x_.device)
        if lower >= 0:
            keep = keep & (i - j <= lower)
        if upper >= 0:
            keep = keep & (j - i <= upper)
        return torch.where(keep, x_, torch.zeros((), dtype=x_.dtype, device=x_.device))
    if op in ("DepthToSpace", "SpaceToDepth"):
        bs = int(n.attrs["block_size"].i)
        fmt_a = n.attrs.get("data_format")
        if fmt_a and fmt_a.s and fmt_a.s != b"NHWC":
            raise ValueError(
                f"{op} node {name!r}: only NHWC is supported "
                f"(got {fmt_a.s.decode('utf-8')})"
            )
        x_ = T(args[0])
        b, h, w, c = (int(d) for d in x_.shape)
        if op == "DepthToSpace":
            x_ = x_.reshape(b, h, w, bs, bs, c // (bs * bs))
            x_ = x_.permute(0, 1, 3, 2, 4, 5)
            return x_.reshape(b, h * bs, w * bs, c // (bs * bs))
        x_ = x_.reshape(b, h // bs, bs, w // bs, bs, c)
        x_ = x_.permute(0, 1, 3, 2, 4, 5)
        return x_.reshape(b, h // bs, w // bs, c * bs * bs)
    if op in ("ResizeBilinear", "ResizeNearestNeighbor"):
        size = np.asarray(_concrete_operand(n, "size", args[1]))
        ac_a = n.attrs.get("align_corners")
        hp_a = n.attrs.get("half_pixel_centers")
        return _tf_resize(
            T(args[0]), int(size[0]), int(size[1]),
            bilinear=(op == "ResizeBilinear"),
            align=bool(ac_a.b) if ac_a else False,
            half_pixel=bool(hp_a.b) if hp_a else False,
        )
    raise ValueError(f"unsupported op {op}")  # pragma: no cover — gated


def _mirror_indices(n: int, before: int, after: int, reflect: bool) -> np.ndarray:
    """Source indices of a MirrorPad along one dim of size ``n``: REFLECT
    mirrors without the edge element, SYMMETRIC with it."""
    if reflect:
        head = np.arange(before, 0, -1)
        tail = n - 2 - np.arange(after)
    else:
        head = np.arange(before - 1, -1, -1)
        tail = n - 1 - np.arange(after)
    return np.concatenate([head, np.arange(n), tail]).astype(np.int64)


def _tf_resize(x: torch.Tensor, nh: int, nw: int, bilinear: bool, align: bool,
               half_pixel: bool) -> torch.Tensor:
    """TF's legacy image resize, exactly (resize_bilinear_op.cc /
    resize_nearest_neighbor_op.cc semantics for every align_corners /
    half_pixel_centers combination). NHWC; source coordinates are host
    numpy (the size operand is a host value), so only gathers and lerps
    run on the device. ResizeBilinear always outputs f32, matching TF's
    kernel signature."""
    h, w = int(x.shape[1]), int(x.shape[2])

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=x.device)

    def scale_for(out_n, in_n):
        if align and out_n > 1:
            return (in_n - 1) / (out_n - 1)
        return in_n / out_n

    def src_coords(out_n, in_n):
        i = np.arange(out_n, dtype=np.float64)
        sc = scale_for(out_n, in_n)
        if half_pixel and not align:
            return (i + 0.5) * sc - 0.5
        return i * sc

    if bilinear:
        def interp_axis(out_n, in_n):
            src = src_coords(out_n, in_n)
            lower = np.maximum(np.floor(src), 0).astype(np.int64)
            upper = np.minimum(np.ceil(src), in_n - 1).astype(np.int64)
            lerp = (src - np.floor(src)).astype(np.float32)
            return lower, upper, torch.as_tensor(lerp, device=x.device)

        ly, uy, ty = interp_axis(nh, h)
        lx, ux, tx = interp_axis(nw, w)
        xf = x.float()
        top = torch.index_select(xf, 1, idx(ly))
        bot = torch.index_select(xf, 1, idx(uy))

        def horiz(img):
            left = torch.index_select(img, 2, idx(lx))
            right = torch.index_select(img, 2, idx(ux))
            return left + (right - left) * tx[None, None, :, None]

        t = horiz(top)
        bm = horiz(bot)
        return t + (bm - t) * ty[None, :, None, None]

    def nn_index(out_n, in_n):
        i = np.arange(out_n, dtype=np.float64)
        sc = scale_for(out_n, in_n)
        if half_pixel and not align:
            # NN's half-pixel scaler is (i + 0.5) * scale with NO -0.5
            # (TF's HalfPixelScalerForNN), then floor
            ix = np.floor((i + 0.5) * sc).astype(np.int64)
        elif align:
            # TF rounds half AWAY from zero (roundf), not half-to-even
            ix = np.floor(i * sc + 0.5).astype(np.int64)
        else:
            ix = np.floor(i * sc).astype(np.int64)
        return np.clip(ix, 0, in_n - 1)

    return torch.index_select(
        torch.index_select(x, 1, idx(nn_index(nh, h))), 2, idx(nn_index(nw, w))
    )


def load_graphdef(
    path: str,
    fetches: Optional[Sequence[str]] = None,
    relax_lead_dim: bool = False,
    quantize_weights: bool = False,
    compute_dtype: Optional[str] = "auto",
    device=None,
) -> Program:
    """Load a frozen TF ``GraphDef`` file as an analyzed Program on
    ``device`` (default ``config.device``, the card) (≙ ``graphFromFile``,
    PythonInterface.scala:115-118 — but static: shapes come from probing
    the lowered program, not from importing into a live TF runtime)."""
    with open(path, "rb") as f:
        data = f.read()
    device = resolve_device(device)
    program = program_from_graphdef(
        parse_graphdef(data),
        fetches=fetches,
        relax_lead_dim=relax_lead_dim,
        quantize_weights=quantize_weights,
        compute_dtype=compute_dtype,
        device=device,
    )
    return analyze_program(program, device=device)



def _parse_meta_graphs_raw(data: bytes):
    """Decode every MetaGraphDef's envelope — ``(graphdef_bytes,
    signatures, tags)`` per meta graph, in file order — WITHOUT parsing
    the graphs themselves.  Selection (which meta graph serves the
    requested signature) needs only signatures and tags; a train+serve
    SavedModel's train graph (optimizer ops, gradient subgraphs) can
    dwarf the serve graph, so the full node decode waits until one meta
    graph is picked. Wire path: SavedModel.meta_graphs (field 2) →
    MetaGraphDef.meta_info_def.tags (fields 1.4) + graph_def (field 2)
    + signature_def map (field 5)."""
    metas = []
    try:
        for field, _, v in _iter_fields(data):
            if field != 2:
                continue
            graph_bytes = None
            signatures: Dict[str, Dict[str, Dict[str, str]]] = {}
            tags: List[str] = []
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:  # MetaInfoDef
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 4 and isinstance(v3, bytes):
                            tags.append(v3.decode("utf-8"))
                elif f2 == 2:
                    graph_bytes = v2
                elif f2 == 5:  # map<string, SignatureDef> entry
                    key = None
                    sig = {"inputs": {}, "outputs": {}}
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            key = v3.decode("utf-8")
                        elif f3 == 2:  # SignatureDef
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 in (1, 2):  # inputs/outputs map
                                    io_name = ref = None
                                    for f5, _, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            io_name = v5.decode("utf-8")
                                        elif f5 == 2:  # TensorInfo
                                            for f6, _, v6 in _iter_fields(v5):
                                                if f6 == 1:
                                                    ref = v6.decode("utf-8")
                                    if io_name is not None and ref:
                                        side = (
                                            "inputs" if f4 == 1 else "outputs"
                                        )
                                        sig[side][io_name] = ref
                    if key is not None:
                        signatures[key] = sig
            if graph_bytes is not None:
                metas.append((graph_bytes, signatures, tags))
    except (
        IndexError, TypeError, AttributeError, struct.error,
        UnicodeDecodeError, _WireError,
    ) as e:
        raise ValueError(
            f"not a valid serialized SavedModel ({type(e).__name__} while "
            f"decoding: {e})"
        ) from e
    if not metas:
        raise ValueError("SavedModel contains no MetaGraphDef graph")
    return metas


def parse_saved_model_meta_graphs(data: bytes):
    """Decode EVERY MetaGraphDef in ``saved_model.pb`` (saved_model.proto)
    without TensorFlow: returns a list of ``(GraphNodes, signatures,
    tags)`` triples, one per meta graph, in file order. ``signatures``
    maps each signature key to ``{"inputs": {arg: tensor_ref},
    "outputs": {...}}`` (TensorInfo names like
    ``"StatefulPartitionedCall:0"``); ``tags`` is the meta graph's
    tag-set (e.g. ``["serve"]``, ``["train"]``).

    A SavedModel may carry several meta graphs (e.g. train+serve);
    ``load_saved_model`` picks the one holding the requested signature
    rather than assuming it lives in the first.
    """
    return [
        (parse_graphdef(gb), signatures, tags)
        for gb, signatures, tags in _parse_meta_graphs_raw(data)
    ]


def parse_saved_model(data: bytes):
    """Decode ``saved_model.pb`` and return ``(GraphNodes, signatures)``
    for the SERVING meta graph: the one tagged ``serve`` when several
    meta graphs are present (train+serve exports), else the first. Only
    the selected meta graph's nodes are decoded. See
    :func:`parse_saved_model_meta_graphs` for the full list."""
    metas = _parse_meta_graphs_raw(data)
    for gb, signatures, tags in metas:
        if "serve" in tags:
            return parse_graphdef(gb), signatures
    return parse_graphdef(metas[0][0]), metas[0][1]



def load_saved_model(
    path: str,
    signature: str = "serving_default",
    fetches: Optional[Sequence[str]] = None,
    relax_lead_dim: bool = False,
    quantize_weights: bool = False,
    compute_dtype: Optional[str] = "auto",
    device=None,
) -> Program:
    """Import a TF SavedModel signature as an analyzed Program on
    ``device`` (default ``config.device``, the card) — with NO
    TensorFlow at all where the clean-room path resolves the model.

    The clean-room parser reads ``saved_model.pb`` directly (MetaGraph
    selection, signature map, function library for PartitionedCall
    bodies), and VARIABLE-BEARING models restore their weights straight
    from the checkpoint bundle (``bundle.py`` reads
    ``variables/variables.index`` + data shards; VarHandleOp binds to
    the value, ReadVariableOp is an identity). TensorFlow is imported
    only as a FALLBACK for models the clean-room path cannot resolve
    (legacy ``VariableV2`` graphs, unresolvable handles, or
    ``quantize_weights=True``, whose weight planner needs an inlined
    graph) — those freeze via ``convert_variables_to_constants_v2``.
    Without TensorFlow that fallback raises ``ImportError`` naming the
    clean-room failure; it never changes the result silently.
    """
    import os as _os

    device = resolve_device(device)
    pb = _os.path.join(path, "saved_model.pb")
    tf_free_error = None
    if _os.path.exists(pb):
        with open(pb, "rb") as fh:
            metas = _parse_meta_graphs_raw(fh.read())
        # Pick the meta graph HOLDING the requested signature (prefer a
        # serve-tagged one on ties): multi-meta-graph SavedModels
        # (e.g. train+serve tag-sets) may keep the serving signature in
        # a later entry, where first-only decoding would miss it. Only
        # the picked graph's nodes decode — the others stay raw bytes.
        holders = [m for m in metas if signature in m[1]]
        pool = holders or metas
        tagged = [m for m in pool if "serve" in m[2]]
        graph_bytes, signatures, _tags = (tagged or pool)[0]
        nodes = parse_graphdef(graph_bytes)
        has_vars = any(
            n.op in ("VarHandleOp", "VariableV2", "ReadVariableOp")
            for n in nodes
        )
        variables = None
        if has_vars and signatures and not quantize_weights:
            # clean-room variable restore: read the checkpoint bundle
            # directly so variable-bearing SavedModels import with NO
            # TensorFlow even at conversion time. Any malformed or
            # unsupported bundle falls back to TF freezing. quantize_weights
            # still routes through TF freezing: the weight planner needs an
            # inlined (library-free) graph.
            try:
                from .bundle import restore_variables

                variables = restore_variables(
                    _os.path.join(path, "variables")
                )
            except Exception as e:
                logger.warning(
                    "clean-room variable restore failed (%s); falling "
                    "back to TensorFlow freezing", e,
                )
                variables = None
        if signatures and (not has_vars or variables is not None):
            if signature not in signatures:
                every = sorted({s for _, sigs, _ in metas for s in sigs})
                raise KeyError(
                    f"SavedModel has no signature {signature!r} in any "
                    f"of its {len(metas)} meta graph(s); available: "
                    f"{every}"
                )

            def _tf_free_import():
                sig = signatures[signature]
                sig_fetches = fetches
                rename = None
                if sig_fetches is None:
                    # fetch the signature's output tensors, then rename the
                    # result columns to the signature's output-arg names —
                    # several output names may ALIAS one tensor, so the map
                    # is fetch → [names]
                    sig_fetches = []
                    rename = {}
                    for out_name, ref in sorted(sig["outputs"].items()):
                        f = ref[:-2] if ref.endswith(":0") else ref
                        if f not in rename:
                            sig_fetches.append(f)
                            rename[f] = []
                        rename[f].append(out_name)
                program = program_from_graphdef(
                    nodes,
                    fetches=sig_fetches,
                    relax_lead_dim=relax_lead_dim,
                    quantize_weights=quantize_weights,
                    compute_dtype=compute_dtype,
                    variables=variables,
                    device=device,
                )
                if rename:
                    inner = program.fn
                    rmap = dict(rename)

                    def renamed(feeds, _inner=inner, _rmap=rmap):
                        out = {}
                        for k, v in _inner(feeds).items():
                            for nm2 in _rmap.get(k, [k]):
                                out[nm2] = v
                        return out

                    program = Program(
                        renamed,
                        program.inputs,
                        fetch_order=[
                            nm2
                            for f in program.fetch_order
                            for nm2 in rmap.get(f, [f])
                        ],
                    )
                # inputs follow the signature's declared arg names too (the
                # TF-freeze path exposes these; graph placeholders carry
                # mangled 'serving_default_*' names)
                in_rename = {}
                for arg_name, ref in sig["inputs"].items():
                    ph = ref[:-2] if ref.endswith(":0") else ref
                    if ph != arg_name and ph in [
                        i.name for i in program.inputs
                    ]:
                        in_rename[ph] = arg_name
                if in_rename:
                    program = program.rename_inputs(in_rename)
                return analyze_program(program, device=device)

            if not has_vars:
                return _tf_free_import()
            try:
                return _tf_free_import()
            except UnresolvedVariableError as e:
                # a resolvable BUNDLE does not guarantee a resolvable
                # GRAPH: a reachable VarHandleOp whose shared_name is
                # absent from the restored map keeps the TF-freezing
                # behavior below
                tf_free_error = e
                logger.warning(
                    "TF-free variable import failed (%s); falling "
                    "back to TensorFlow freezing", e,
                )
            except ValueError as e:
                # a GENUINE lowering failure (e.g. unsupported op —
                # legacy VariableV2 lands here). TF re-tracing during
                # freezing can still produce a lowerable graph, so fall
                # back — but keep the root cause chained so a
                # missing-tensorflow environment surfaces it instead of
                # only the generic 'tensorflow required'
                tf_free_error = e
                logger.warning(
                    "TF-free import hit a lowering error (%s); "
                    "retrying via TensorFlow freezing", e,
                )
    try:
        import tensorflow as tf
        from tensorflow.python.framework.convert_to_constants import (
            convert_variables_to_constants_v2,
        )
    except ImportError as e:
        msg = (
            "this SavedModel holds variables, and freezing them needs "
            "tensorflow; freeze offline (convert_variables_to_constants_v2) "
            "and use load_graphdef on the result instead (variable-FREE "
            "SavedModels load without tensorflow)"
        )
        if tf_free_error is not None:
            msg += (
                f"; note the TF-free import path failed first with: "
                f"{tf_free_error}"
            )
        # chain `e`, not tf_free_error: a BROKEN tensorflow install
        # (numpy ABI mismatch etc.) must stay visible — tf_free_error
        # is already embedded in the message above
        raise ImportError(msg) from e
    m = tf.saved_model.load(path)
    if signature not in m.signatures:
        raise KeyError(
            f"SavedModel has no signature {signature!r}; available: "
            f"{sorted(m.signatures)}"
        )
    frozen = convert_variables_to_constants_v2(m.signatures[signature])
    data = frozen.graph.as_graph_def().SerializeToString()
    program = program_from_graphdef(
        parse_graphdef(data),
        fetches=fetches,
        relax_lead_dim=relax_lead_dim,
        quantize_weights=quantize_weights,
        compute_dtype=compute_dtype,
        device=device,
    )
    return analyze_program(program, device=device)
