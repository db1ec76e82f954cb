"""tensorframes_tpu_torch — the columnar-frame compute framework on PyTorch
and CUDA.

The port of ``tensorframes_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100: attach numeric programs to the columns of a block-partitioned frame
through five verbs — ``map_rows``, ``map_blocks`` (± trimmed),
``reduce_rows``, ``reduce_blocks``, keyed ``aggregate`` — plus schema
tooling (``analyze``, ``append_shape``, ``print_schema``), and serve a
causal transformer through a decode server (:class:`Server`,
:class:`DecodeEngine`: continuous batching over a paged int8 KV pool),
and train it straight off a frame (:func:`training.train_on_frame` over
:func:`models.transformer.make_train_step`, batches staged by
:mod:`.io`). Frozen TF graphs and SavedModels import as programs
(:func:`load_graphdef`, :func:`load_saved_model`, :mod:`.graphdef`,
with no TensorFlow), and programs serialize through ``torch.export``
(:func:`save_program`, :func:`load_program`).

Frames are host-resident; verbs run each block on one device, the GPU
unless the caller asks for the CPU (``device="cpu"`` on a verb, or
``configure(device="cpu")``). The keyed segment reductions and the ragged
row gather, the paged decode attention, the int8-weight matmul and flash
attention (forward, dK/dV and dQ) run as hand-written CUDA kernels
(:mod:`.kernels`). This
package imports nothing of ``tensorframes_tpu`` and no JAX.
"""

from __future__ import annotations

from .config import configure, get_config  # noqa: F401
from . import dtypes  # noqa: F401
from .shape import Shape, Unknown  # noqa: F401
from .schema import ColumnInfo, Schema  # noqa: F401
from .frame import (  # noqa: F401
    TensorFrame,
    describe,
    frame_from_arrays,
    frame_from_pandas,
    frame_from_rows,
)
from .frame import analyze, append_shape, print_schema, explain  # noqa: F401
from .dsl import (  # noqa: F401
    Node,
    abs_,
    add,
    apply_fn,
    block,
    constant,
    div,
    exp,
    fill,
    identity,
    log,
    matmul,
    mul,
    ones,
    placeholder,
    reduce_max,
    reduce_mean,
    reduce_min,
    reduce_sum,
    relu,
    row,
    scope,
    sigmoid,
    sqrt,
    square,
    sub,
    tanh,
    with_graph,
    zeros,
)
from .program import (  # noqa: F401
    Program,
    TensorSpec,
    load_program,
    program_from_function,
    save_program,
)
from .validation import ValidationError  # noqa: F401
from . import kernels  # noqa: F401  (registers tftpu_kernels_* metrics)
from .ops.verbs import (  # noqa: F401
    aggregate,
    compile_program,
    map_blocks,
    map_rows,
    reduce_blocks,
    reduce_rows,
)
from .utils import profiling  # noqa: F401
from . import observability  # noqa: F401
from .serving import DecodeConfig, DecodeEngine, Server, ServingConfig  # noqa: F401
from . import io, training  # noqa: F401
from .graphdef import (  # noqa: F401
    load_graphdef,
    load_saved_model,
    parse_graphdef,
    parse_saved_model,
    parse_saved_model_meta_graphs,
    program_from_graphdef,
)
from .bundle import restore_variables  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "TensorFrame",
    "frame_from_arrays",
    "frame_from_rows",
    "frame_from_pandas",
    "describe",
    "Shape",
    "Unknown",
    "ColumnInfo",
    "Schema",
    "dtypes",
    "configure",
    "get_config",
    # verbs (≙ reference __init__.py:15-21 public surface)
    "map_rows",
    "map_blocks",
    "reduce_rows",
    "reduce_blocks",
    "aggregate",
    "compile_program",
    "analyze",
    "append_shape",
    "print_schema",
    "explain",
    "kernels",
    "profiling",
    "observability",
    "io",
    "training",
    # serving
    "Server",
    "ServingConfig",
    "DecodeConfig",
    "DecodeEngine",
    # dsl / placeholder helpers
    "Node",
    "block",
    "row",
    "placeholder",
    "constant",
    "zeros",
    "ones",
    "fill",
    "with_graph",
    "scope",
    # op catalog
    "identity",
    "add",
    "sub",
    "mul",
    "div",
    "matmul",
    "reduce_sum",
    "reduce_min",
    "reduce_max",
    "reduce_mean",
    "exp",
    "log",
    "tanh",
    "sqrt",
    "abs_",
    "square",
    "sigmoid",
    "relu",
    "apply_fn",
    # programs
    "Program",
    "TensorSpec",
    "program_from_function",
    "save_program",
    "load_program",
    # foreign graphs
    "load_graphdef",
    "load_saved_model",
    "parse_graphdef",
    "parse_saved_model",
    "parse_saved_model_meta_graphs",
    "program_from_graphdef",
    "restore_variables",
    "ValidationError",
]
