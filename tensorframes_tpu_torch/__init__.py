"""tensorframes_tpu_torch — the columnar-frame compute framework on PyTorch
and CUDA.

The port of ``tensorframes_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100: attach numeric programs to the columns of a block-partitioned frame
through five verbs — ``map_rows``, ``map_blocks`` (± trimmed),
``reduce_rows``, ``reduce_blocks``, keyed ``aggregate`` — plus schema
tooling (``analyze``, ``append_shape``, ``print_schema``), and serve a
causal transformer through a decode server (:class:`Server`,
:class:`DecodeEngine`: continuous batching over a paged int8 KV pool,
with a prefix cache and KV swap over :class:`BlockStore`) and any
row program through a flush endpoint (``Server.register``, over HTTP with
:func:`serve_http`, and as a supervised fleet of replica processes
behind one :class:`Router` ingress: :class:`ServingFleet`) and a relational pipeline over a growing CSV or
Parquet directory as a registered query (``Server.register_query``:
cached results, per-chunk partial folds),
and train it straight off a frame (:func:`training.train_on_frame` over
:func:`models.transformer.make_train_step`, batches staged by
:mod:`.io`), resumably: verified checkpoints (:class:`Checkpointer`,
the JAX package's npz format), :func:`run_resumable`, step guards,
retries and fault sites (:mod:`.resilience`), step telemetry and a
flight recorder (:mod:`.observability`). Frozen TF graphs and SavedModels import as programs
(:func:`load_graphdef`, :func:`load_saved_model`, :mod:`.graphdef`,
with no TensorFlow), and programs serialize through ``torch.export``
(:func:`save_program`, :func:`load_program`). A numpy function becomes a block stage with
:func:`numpy_udf`: lifted into a torch program when it verifies bit for
bit on the device, a counted host stage otherwise. A static analyzer lints
programs and plans before they run (:func:`lint_program`,
:func:`analyze_frame`, :func:`lint_plan`, the verbs' ``strict=``), and
:func:`warmup` dispatches the expected shapes ahead of traffic, recorded
in a persistent store when ``compilation_cache_dir`` is set
(:mod:`.compilecache`). The data plane reads and
writes CSV, Parquet and Arrow (:func:`read_csv`, :func:`scan_csv`, ...),
persists frames (:func:`save_frame`, :func:`load_frame`), and streams a
chain over data larger than memory (:func:`stream_chain`, spilling to a
:class:`BlockStore`); row ⇄ column passes run in C++ (:mod:`.native`).

Frames are host-resident; verbs run each block on one device, the GPU
unless the caller asks for the CPU (``device="cpu"`` on a verb, or
``configure(device="cpu")``). A frame can also be sharded over the ranks
of a ``torch.distributed`` process group, one device a rank
(:meth:`TensorFrame.to_device`, :func:`parallel.frame_from_process_local`):
its verbs then run on each rank's rows and cross ranks through NCCL or
gloo collectives (:mod:`.parallel`, ``ops/device_agg.py``,
``ops/exchange.py``, the file shuffle in :mod:`.blockstore`). The keyed segment reductions and the ragged
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
from .validation import StaticAnalysisError, ValidationError  # noqa: F401
from . import analysis  # noqa: F401  (registers tftpu_analysis_* metrics)
from .analysis import analyze_frame, lint_plan, lint_program  # noqa: F401
from . import kernels  # noqa: F401  (registers tftpu_kernels_* metrics)
from .ops.verbs import (  # noqa: F401
    NumpyUDF,
    aggregate,
    compile_program,
    map_blocks,
    map_rows,
    numpy_udf,
    reduce_blocks,
    reduce_rows,
)
from .utils import profiling  # noqa: F401
from . import observability  # noqa: F401
from .plan import explain_plan  # noqa: F401  (registers tftpu_plan_* metrics)
from .serving import (  # noqa: F401
    DecodeConfig,
    DecodeEngine,
    FleetDegradedError,
    QuerySource,
    Router,
    RouterConfig,
    Server,
    ServingConfig,
    ServingFleet,
    serve_http,
    serve_replica,
)
from .blockstore import (  # noqa: F401
    BlockCorruptionError,
    BlockStore,
    ResultStore,
    SpilledFrame,
    stream_chain,
)
from . import io, native, training  # noqa: F401
from .io import (  # noqa: F401
    frame_from_arrow,
    frame_to_arrow,
    load_frame,
    read_csv,
    read_parquet,
    save_frame,
    scan_csv,
    scan_parquet,
    write_csv,
    write_parquet,
)
from .graphdef import (  # noqa: F401
    load_graphdef,
    load_saved_model,
    parse_graphdef,
    parse_saved_model,
    parse_saved_model_meta_graphs,
    program_from_graphdef,
)
from .bundle import restore_variables  # noqa: F401
from .checkpoint import CheckpointCorruptionError, Checkpointer  # noqa: F401
from . import resilience  # noqa: F401
from . import parallel  # noqa: F401  (the process group, meshes, collectives)
from .resilience import RetryPolicy, StepGuard  # noqa: F401
from .observability import StepTelemetry  # noqa: F401
from .training import run_resumable  # noqa: F401
from . import compilecache  # noqa: F401  (registers tftpu_compilecache_* metrics)
from .compilecache import WarmupReport, warmup  # noqa: F401

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
    # verified UDF lifting
    "numpy_udf",
    "NumpyUDF",
    "analyze",
    "append_shape",
    "print_schema",
    "explain",
    "explain_plan",
    "kernels",
    "profiling",
    "observability",
    "io",
    "native",
    "training",
    # resumable training
    "Checkpointer",
    "CheckpointCorruptionError",
    "run_resumable",
    "resilience",
    "RetryPolicy",
    "StepGuard",
    "StepTelemetry",
    # serving
    "Server",
    "ServingConfig",
    "DecodeConfig",
    "DecodeEngine",
    "serve_http",
    "QuerySource",
    "ServingFleet",
    "FleetDegradedError",
    "serve_replica",
    "Router",
    "RouterConfig",
    # out-of-core data plane
    "BlockStore",
    "BlockCorruptionError",
    "ResultStore",
    "SpilledFrame",
    "stream_chain",
    "read_csv",
    "write_csv",
    "scan_csv",
    "read_parquet",
    "write_parquet",
    "scan_parquet",
    "frame_from_arrow",
    "frame_to_arrow",
    "save_frame",
    "load_frame",
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
    # static analysis and warmup
    "StaticAnalysisError",
    "analysis",
    "analyze_frame",
    "lint_plan",
    "lint_program",
    "compilecache",
    "WarmupReport",
    "warmup",
]
