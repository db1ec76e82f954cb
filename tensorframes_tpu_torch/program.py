"""Program capture and static analysis.

The reference ingests user programs as TF graphs and re-imports them into
the TF runtime to discover inputs/outputs/dtypes/shapes (``analyzeGraphTF``,
TensorFlowOps.scala:101-141). Here a program is a Python function over
torch tensors — written by hand, or compiled from a DSL expression graph
(:mod:`tensorframes_tpu_torch.dsl`).

Analysis is *static*: the program runs once on meta-device storage (torch's
``FakeTensorMode``, which also lets the function read real tensors it
captured, such as model weights on the GPU) — no data moves and no kernel
runs. Unknown (batch) dimensions are discovered by probing two distinct
batch sizes and marking every output dim that co-varies with the probe —
this replaces the reference's shape-hints workaround for dims the graph
pruned (ShapeDescription.scala:12-19). Explicit user hints still override
(the hint-override rule, TensorFlowOps.scala:126-133).

Weights are runtime tensors: a function that closes over model weights
reads those device tensors on every call; nothing copies them into a
per-shape artifact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import dtypes as dt
from .shape import Shape, Unknown

# Probe batch sizes used to discover batch-covariant output dims. Coprime and
# unequal so a dim matching both probes by accident is effectively impossible.
_PROBE_A = 3
_PROBE_B = 7


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Name + dtype + (partial) shape of one program input or output.

    ≙ ``GraphNodeSummary`` (TensorFlowOps.scala:163-169).
    """

    name: str
    dtype: dt.ScalarType
    shape: Shape  # may contain Unknown dims

    def pretty(self) -> str:
        return f"{self.name}: {self.dtype.name}{self.shape}"


class Program:
    """A user program: named inputs → named outputs.

    ``fn`` maps a dict of tensors (keyed by input name) to a dict of tensors
    (keyed by output name). ``inputs`` carries the declared dtype/shape of
    each input (shapes may have Unknown dims); ``outputs`` is filled in by
    :func:`analyze_program`.
    """

    def __init__(
        self,
        fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
        inputs: Sequence[TensorSpec],
        outputs: Optional[Sequence[TensorSpec]] = None,
        fetch_order: Optional[Sequence[str]] = None,
    ):
        self.fn = fn
        self.inputs: List[TensorSpec] = list(inputs)
        self.outputs: List[TensorSpec] = list(outputs) if outputs else []
        # order in which the user listed fetches (defines result ordering for
        # reduce verbs returning numpy arrays)
        self.fetch_order: List[str] = (
            list(fetch_order) if fetch_order else [o.name for o in self.outputs]
        )
        self._compiled = None  # memoized CompiledProgram (ops/executor.py)
        # the device analyze_program probed on (tensors the function
        # captured live there); cost_analysis probes on it too
        self.device = None

    def compiled(self):
        """Memoized executor entrypoints (per-feed-shape dispatch
        bookkeeping survives across verb calls that reuse the Program)."""
        if self._compiled is None:
            from .ops.executor import CompiledProgram

            self._compiled = CompiledProgram(self)
        return self._compiled

    @property
    def input_names(self) -> List[str]:
        return [s.name for s in self.inputs]

    @property
    def output_names(self) -> List[str]:
        return [s.name for s in self.outputs]

    def input(self, name: str) -> TensorSpec:
        for s in self.inputs:
            if s.name == name:
                return s
        raise KeyError(
            f"Program has no input {name!r}; inputs: {self.input_names}"
        )

    def output(self, name: str) -> TensorSpec:
        for s in self.outputs:
            if s.name == name:
                return s
        raise KeyError(
            f"Program has no output {name!r}; outputs: {self.output_names}"
        )

    def rename_inputs(self, mapping: Dict[str, str]) -> "Program":
        """Rename inputs (placeholder → column feed_dict remapping,
        ≙ core.py:128-142). ``mapping`` maps old input name → new name."""
        new_inputs = [
            TensorSpec(mapping.get(s.name, s.name), s.dtype, s.shape)
            for s in self.inputs
        ]
        inner = self.fn
        inv = {mapping.get(s.name, s.name): s.name for s in self.inputs}

        def fn(feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            return inner({inv.get(k, k): v for k, v in feeds.items()})

        renamed = Program(fn, new_inputs, self.outputs, self.fetch_order)
        renamed.device = self.device
        # carry the segment-lowering info (input names remapped) so the
        # aggregate fast path survives feed_dict renames
        seg = getattr(self, "seg_info", None)
        if seg is not None:
            renamed.seg_info = [
                (out, op, mapping.get(inp, inp)) for (out, op, inp) in seg
            ]
        return renamed

    def cost_analysis(self, probe: int = 8) -> Dict[str, float]:
        """The program's cost at ``probe`` rows for every Unknown dim:
        ``flops`` as ``torch.utils.flop_counter.FlopCounterMode`` counts
        them (matmul-class ops only: a [m, k] @ [k, n] reads 2·m·k·n) and
        ``bytes accessed`` as the bytes of the input and output specs,
        each read or written once. The program runs under
        ``FakeTensorMode``: no data moves, no kernel runs. Memoized per
        probe."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode

        cache = self.__dict__.setdefault("_cost_cache", {})
        if probe in cache:
            return dict(cache[probe])
        device = torch.device(self.device if self.device is not None else "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
            feeds = _probe_inputs(self.inputs, probe, device)
            with FlopCounterMode(display=False) as counter:
                outs = self.fn(feeds)
            nbytes = sum(v.numel() * v.element_size() for v in feeds.values())
            nbytes += sum(v.numel() * v.element_size() for v in outs.values())
        cache[probe] = {"flops": float(counter.get_total_flops()),
                        "bytes accessed": float(nbytes)}
        return dict(cache[probe])

    def flops_per_row(self, probe: int = 8) -> float:
        """Marginal flops per input row, from :meth:`cost_analysis` at two
        probe sizes (the difference removes batch-independent work).
        Memoized."""
        cached = self.__dict__.get("_flops_per_row")
        if cached is not None:
            return cached
        f1 = float(self.cost_analysis(probe).get("flops", 0.0))
        f2 = float(self.cost_analysis(2 * probe).get("flops", 0.0))
        self._flops_per_row = max(0.0, (f2 - f1) / probe)
        return self._flops_per_row

    def bytes_per_row(self, probe: int = 8) -> float:
        """Marginal bytes accessed per input row (the two-probe scheme of
        :meth:`flops_per_row`). Memoized."""
        cached = self.__dict__.get("_bytes_per_row")
        if cached is not None:
            return cached
        b1 = float(self.cost_analysis(probe).get("bytes accessed", 0.0))
        b2 = float(self.cost_analysis(2 * probe).get("bytes accessed", 0.0))
        self._bytes_per_row = max(0.0, (b2 - b1) / probe)
        return self._bytes_per_row

    def explain(self) -> str:
        ins = ", ".join(s.pretty() for s in self.inputs)
        outs = ", ".join(s.pretty() for s in self.outputs)
        extra = ""
        if self._compiled is not None:
            sizes = self._compiled.cache_sizes()
            extra = (
                f", compiled_shapes={{block: {sizes['block']}, "
                f"vmap: {sizes['vmap']}}}"
            )
        return f"Program(inputs=[{ins}], outputs=[{outs}]{extra})"


def _probe_inputs(
    inputs: Sequence[TensorSpec], probe: int, device
) -> Dict[str, torch.Tensor]:
    out = {}
    for s in inputs:
        dims = tuple(probe if d == Unknown else d for d in s.shape.dims)
        out[s.name] = torch.empty(dims, dtype=s.dtype.torch_dtype, device=device)
    return out


def analyze_program(
    program: Program,
    hints: Optional[Dict[str, Shape]] = None,
    device=None,
) -> Program:
    """Static shape/dtype analysis of a Program (≙ ``analyzeGraphTF``).

    Runs the program on meta-device storage with two different probe
    values substituted for Unknown input dims; output dims that differ
    between the probes are marked Unknown (batch-covariant). ``hints``
    (output name → Shape) override discovered shapes wherever the hint dim
    is known — the reference's hint-override rule
    (TensorFlowOps.scala:126-133). ``device`` is the device the program
    will run on (tensors the function captured must live there).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    hints = hints or {}
    device = torch.device(device if device is not None else "cpu")

    def run(probe: int):
        with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
            res = program.fn(_probe_inputs(program.inputs, probe, device))
            if not isinstance(res, dict):
                raise TypeError(
                    "Program function must return a dict of named outputs; got "
                    f"{type(res).__name__}"
                )
            return {k: (tuple(v.shape), v.dtype) for k, v in res.items()}

    res_a = run(_PROBE_A)
    if any(s.shape.has_unknown for s in program.inputs):
        res_b = run(_PROBE_B)
    else:
        res_b = res_a

    outputs: List[TensorSpec] = []
    order = program.fetch_order or list(res_a.keys())
    for name in res_a:
        (sa, dtype), (sb, _) = res_a[name], res_b[name]
        dims = []
        for da, db in zip(sa, sb):
            # a dim that co-varied with the probe is batch-dependent
            dims.append(da if da == db else Unknown)
        shape = Shape(dims)
        if name in hints:
            shape = shape.refine(Shape.from_any(hints[name]))
        outputs.append(TensorSpec(name, dt.from_torch(dtype), shape))
    # keep fetch order where given
    by_name = {o.name: o for o in outputs}
    ordered = [by_name[n] for n in order if n in by_name] + [
        o for o in outputs if o.name not in order
    ]
    analyzed = Program(program.fn, program.inputs, ordered, order)
    analyzed.device = device
    return analyzed


def program_from_function(
    fn: Callable,
    input_specs: Dict[str, TensorSpec],
    output_names: Optional[Sequence[str]] = None,
) -> Program:
    """Wrap a Python function whose positional args are column names.

    The function receives one tensor per parameter (parameter name = input
    name) and returns either a dict name→tensor or a single tensor / tuple —
    singles are named after ``output_names`` (or the function's name).
    Captured tensors (model weights) are read at every call, playing the
    role of the reference's frozen variables (core.py:42-56).
    """
    import inspect

    sig = inspect.signature(fn)
    params = [p.name for p in sig.parameters.values()
              if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]
    missing = [p for p in params if p not in input_specs]
    if missing:
        raise ValueError(
            f"Function parameter(s) {missing} do not match any known input; "
            f"available: {sorted(input_specs)}"
        )
    inputs = [input_specs[p] for p in params]

    def wrapped(feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        res = fn(*[feeds[p] for p in params])
        if isinstance(res, dict):
            return res
        if isinstance(res, (tuple, list)):
            names = output_names or [f"{fn.__name__}_{i}" for i in range(len(res))]
            if len(names) != len(res):
                raise ValueError(
                    f"Function returned {len(res)} outputs but "
                    f"{len(names)} output names were given"
                )
            return dict(zip(names, res))
        name = (output_names or [fn.__name__])[0]
        return {name: res}

    return Program(wrapped, inputs, fetch_order=list(output_names or []))


# ---------------------------------------------------------------------------
# Serialized programs (torch.export artifacts)
# ---------------------------------------------------------------------------

class _Positional(torch.nn.Module):
    """A Program's function as a module over its feed dict (what
    ``torch.export`` traces)."""

    def __init__(self, fn, names: Sequence[str]):
        super().__init__()
        self._fn = fn
        self._names = list(names)

    def forward(self, feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self._fn({n: feeds[n] for n in self._names})


def save_program(program: Program, path: str, batch: int = 8, device=None) -> None:
    """Serialize a Program to a ``torch.export`` artifact on disk
    (≙ writing ``proto.pb``, core.py:58-69).

    Every Unknown input dim is a ``torch.export.Dim`` — the dims at one
    position share one symbol, ``b{i}``, as the reference's symbolic
    shapes do — so the artifact stays batch-polymorphic. The program is
    traced on ``device`` (default ``config.device``; the tensors it
    captured must live there) with ``batch`` rows for each Unknown dim.
    The file is an 8-byte little-endian header length, a JSON header of
    the input specs and ``fetch_order``, then ``torch.export.save``'s
    bytes.

    A program whose host shape arithmetic pins an Unknown dim (reads a
    batch size into a Python int) cannot stay polymorphic: this raises
    ``ValueError`` naming the dim instead of saving a program fixed at
    ``batch`` rows."""
    import io
    import json
    import re

    from .config import resolve_device

    device = resolve_device(device)
    names = [s.name for s in program.inputs]
    symbols: Dict[int, object] = {}
    shapes: Dict[str, Dict[int, object]] = {}
    example: Dict[str, torch.Tensor] = {}
    for s in program.inputs:
        dims = []
        shapes[s.name] = {}
        for i, d in enumerate(s.shape.dims):
            if d == Unknown:
                if i not in symbols:
                    symbols[i] = torch.export.Dim(f"b{i}")
                shapes[s.name][i] = symbols[i]
                dims.append(batch)
            else:
                dims.append(d)
        example[s.name] = torch.zeros(dims, dtype=s.dtype.torch_dtype, device=device)
    try:
        with torch.no_grad():
            exported = torch.export.export(
                _Positional(program.fn, names), (example,),
                dynamic_shapes={"feeds": {n: shapes[n] or None for n in names}},
                strict=False,
            )
    except torch._dynamo.exc.UserError as e:
        # "Constraints violated (b0)! ... specialized it to be a constant"
        pinned = [f"b{i}" for i in sorted(symbols) if re.search(rf"\bb{i}\b", str(e))]
        if not str(e).startswith("Constraints violated") or not pinned:
            raise
        raise ValueError(
            f"save_program: the program pins the batch dim(s) {pinned} (its shape "
            f"arithmetic reads them as Python ints), so it cannot stay "
            f"batch-polymorphic; refusing to save a program fixed at {batch} rows"
        ) from e
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    meta = {
        "inputs": [(s.name, s.dtype.name, list(s.shape.dims)) for s in program.inputs],
        "fetch_order": program.fetch_order,
    }
    header = json.dumps(meta).encode("utf-8")
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(buf.getvalue())


def load_program(path: str) -> Program:
    """Load a serialized Program (≙ ``graphFromFile``,
    PythonInterface.scala:115-118). Importing the port's kernels first
    registers the custom ops (``tftpu::int8_matmul``,
    ``tftpu::flash_attention``) an artifact may call."""
    import io
    import json

    from . import kernels  # noqa: F401
    from .kernels import flash_attention  # noqa: F401
    from .ops import quantize  # noqa: F401

    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode("utf-8"))
        blob = f.read()
    module = torch.export.load(io.BytesIO(blob)).module()
    names = [n for (n, _, _) in meta["inputs"]]
    inputs = [
        TensorSpec(n, dt.by_name(t), Shape(dims)) for (n, t, dims) in meta["inputs"]
    ]

    def fn(feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return module({n: feeds[n] for n in names})

    return Program(fn, inputs, fetch_order=meta.get("fetch_order"))
