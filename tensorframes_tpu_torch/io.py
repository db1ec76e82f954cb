"""Data loading and the data plane's readers and writers.

The reference package's ``io.py``:

* :func:`iterate_batches` walks a frame's columns in minibatches on the
  host, and :func:`prefetch_to_device` stages the next batches on the GPU
  from a worker thread, so the next batch's host → device copy overlaps
  the current step's compute. On the card each batch goes into pinned
  host memory and is copied on a side CUDA stream; the consumer's stream
  waits on an event recorded after the copy, and each handed-over tensor
  is marked as used by the consumer's stream (``record_stream``), so the
  allocator does not reuse its memory while the step still reads it.
  Both ride :func:`pipeline_iter`, the generic double-buffered worker
  pipeline the streaming partitioner also reads its chunks through.
* Frame persistence: :func:`save_frame`/:func:`load_frame` write and read
  the reference's directory format (``frame.json``, ``columns.npz``,
  ``host_columns.pkl``; atomic swap with an ``.old`` self-heal), so a
  directory written by either package loads in the other.
* CSV: :func:`read_csv` (unquoted files in one native pass,
  ``native.parse_csv``; quoted files through the csv module),
  :func:`write_csv`, the chunked :func:`scan_csv` over a directory of
  parts, and the registered query's per-part helpers
  :func:`part_manifest`/:func:`part_frame`. A directory or part list
  ingests through a spillable
  :class:`~tensorframes_tpu_torch.blockstore.BlockStore`.
* Arrow and Parquet: :func:`frame_from_arrow`, :func:`frame_to_arrow`,
  :func:`read_parquet`, :func:`write_parquet`, :func:`scan_parquet`,
  through pyarrow, imported only when one of them is called (the port
  imports without it).

Each staging copy runs under an optional retry policy, with the
``io.prefetch.device_put`` fault site inside the retry scope, and
``io.save_frame``/``io.load_frame`` sites, as in the reference. A sharded
frame persists rank by rank: :func:`save_frame_sharded` writes each rank's
rows to ``part-<rank>`` beside a ``parts.json``, and
:func:`load_frame_sharded` reassembles the sharded frame on the same
number of ranks (the reference's layout).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtypes as dt
from .config import resolve_device
from .observability.metrics import counter as _counter
from .observability.metrics import gauge as _gauge
from .observability.metrics import histogram as _histogram
from .resilience.faults import fault_point
from .resilience.retry import RetryPolicy, retry_call
from .utils import get_logger
from .utils.npz import decode_array, encode_array

logger = get_logger(__name__)

# Prefetch pipeline telemetry, under the reference's names. The two wait
# histograms are the overlap diagnostic: a consumer that never waits is
# compute-bound; a producer that never waits means the buffer is too
# small or the loader too slow.
_PREFETCH_DEPTH = _gauge(
    "tftpu_prefetch_queue_depth",
    "Batches currently staged in the prefetch buffer",
)
_PREFETCH_BATCHES = _counter(
    "tftpu_prefetch_batches_total",
    "Batches delivered to the consumer by prefetch_to_device",
)
_PRODUCER_WAIT = _histogram(
    "tftpu_prefetch_producer_wait_seconds",
    "Time the prefetch worker blocked waiting for buffer space",
)
_CONSUMER_WAIT = _histogram(
    "tftpu_prefetch_consumer_wait_seconds",
    "Time the consumer blocked waiting for a staged batch",
)


def iterate_batches(
    frame,
    columns: Optional[Sequence[str]] = None,
    batch_size: int = 256,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield ``{col: array[batch, ...]}`` minibatches from a frame's dense
    columns (host-side). ``shuffle`` permutes the rows with
    ``np.random.default_rng(seed)``, as the reference does, so both
    packages yield the same rows in the same order."""
    if columns is None:
        columns = [c.name for c in frame.schema.device_columns]
    else:
        columns = list(columns)
    if not columns:
        raise ValueError(
            "iterate_batches: no columns to batch (frame has no dense "
            "device columns, or an empty selection was passed)"
        )
    cols = {c: np.asarray(frame.column_values(c)) for c in columns}
    n = len(next(iter(cols.values())))
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = n - (n % batch_size) if drop_remainder else n
    for lo in range(0, stop, batch_size):
        idx = order[lo : lo + batch_size]
        yield {c: v[idx] for c, v in cols.items()}


_SENTINEL = object()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """One batch as tensors on ``device``, copied synchronously (the
    unprefetched path)."""
    return {k: dt.host_tensor(v).to(device) for k, v in batch.items()}


def prefetch_to_device(
    batches: Iterable[Dict[str, np.ndarray]],
    size: int = 2,
    device=None,
    join_timeout: float = 5.0,
    retry: Optional[RetryPolicy] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a batch iterator with background staging on ``device``
    (default ``config.device``): a worker thread keeps up to ``size``
    batches staged ahead of the consumer.

    On a CUDA device the worker copies each array into pinned host memory
    and then to the card on a side stream, and records an event; the
    consumer's current stream waits on that event before the batch is
    handed over, and every tensor handed over is ``record_stream``-ed on
    the consumer's stream. On the CPU the worker stages without streams.

    Failure semantics are the reference's: a worker exception is parked
    beside the data queue and re-raised by the consumer's next
    ``__next__`` once the already-staged batches are used; the consumer
    polls the worker's liveness, so a worker that died without a word
    ends the stream instead of hanging it; ``close()`` (or leaving the
    loop) stops the worker, drops staged batches and joins the worker
    with ``join_timeout``. ``retry`` (a
    :class:`~.resilience.RetryPolicy`) retries a failed staging copy,
    absorbing transient faults; ``None`` makes one attempt."""
    device = resolve_device(device)
    if size < 1:
        raise ValueError(f"prefetch_to_device: size must be >= 1, got {size}")
    return _staged(batches, size, device, join_timeout, retry)


def _staged(batches, size: int, device: torch.device, join_timeout: float,
            retry: Optional[RetryPolicy]):
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        fault_point("io.prefetch.device_put")
        if side is None:
            return to_device(batch, device), None
        pinned = {k: dt.host_tensor(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(side):
            staged = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return staged, ready

    def stage(batch):
        return retry_call(put, batch, policy=retry, describe="prefetch.device_put")

    items = pipeline_iter(batches, stage=stage, size=size, join_timeout=join_timeout,
                          observe=True, thread_name="tftorch-prefetch")
    try:
        for staged, ready in items:
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for tensor in staged.values():
                    tensor.record_stream(consumer)
            yield staged
    finally:
        items.close()


def pipeline_iter(
    items: Iterable,
    stage=None,
    size: int = 2,
    join_timeout: float = 5.0,
    observe: bool = False,
    thread_name: str = "tftorch-pipeline",
) -> Iterator:
    """The double-buffered worker pipeline under
    :func:`prefetch_to_device`: a worker thread pulls ``items``, applies
    ``stage`` (identity by default — pure read-ahead) and keeps up to
    ``size`` results staged for the consumer. The streaming partitioner
    (``blockstore.stream_chain``) reads its chunks through it, so the next
    chunk's disk read and parse overlap the current chunk's compute.

    Failure semantics are the reference's: a worker exception is parked
    beside the data queue and re-raised by the consumer's next
    ``__next__`` once the already-staged items are used; the consumer
    polls the worker's liveness, so a worker that died without a word ends
    the stream instead of hanging it; leaving the loop (or ``close()``)
    stops the worker, drops staged items and joins the worker with
    ``join_timeout``. ``observe=True`` feeds the prefetch telemetry
    (``prefetch_to_device`` only)."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = threading.Event()
    err: List[Optional[BaseException]] = [None]
    if stage is None:
        stage = lambda item: item  # noqa: E731 - identity read-ahead

    def enqueue(item) -> bool:
        # a bounded put that gives up when the consumer is gone, so an
        # abandoned iterator cannot pin the worker (and its staged
        # buffers) forever
        t0 = time.perf_counter()
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                if item is not _SENTINEL and observe:
                    _PRODUCER_WAIT.observe(time.perf_counter() - t0)
                    _PREFETCH_DEPTH.set(q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if stop.is_set() or not enqueue(stage(item)):
                    return
        except BaseException as e:  # parked for the consumer: a worker that
            # dies must surface as an error, not as a clean end of data
            err[0] = e
        finally:
            done.set()
            enqueue(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True, name=thread_name)
    t.start()
    try:
        wait_t0 = time.perf_counter()
        while True:
            try:
                item = q.get(timeout=0.2)
            except queue.Empty:
                if done.is_set() or not t.is_alive():
                    try:
                        item = q.get_nowait()  # racing final enqueue
                    except queue.Empty:
                        if err[0] is not None:
                            raise err[0]
                        return
                else:
                    continue
            if item is _SENTINEL:
                if err[0] is not None:
                    raise err[0]
                return
            if observe:
                _CONSUMER_WAIT.observe(time.perf_counter() - wait_t0)
                _PREFETCH_DEPTH.set(q.qsize())
                _PREFETCH_BATCHES.inc()
            yield item
            wait_t0 = time.perf_counter()
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        if observe:
            _PREFETCH_DEPTH.set(0)
        t.join(timeout=join_timeout)
        if t.is_alive():  # pragma: no cover - needs a wedged stage
            logger.warning(
                "%s: worker still running %.1fs after shutdown; leaving the "
                "daemon thread behind", thread_name, join_timeout,
            )


# ---------------------------------------------------------------------------
# Frame persistence
# ---------------------------------------------------------------------------
#
# The reference's directory format: a JSON schema manifest, one compressed
# npz for the dense columns and (only when present) a pickle for host
# columns (strings, binaries, ragged cells). Dense arrays are stored as raw
# bytes keyed c0, c1, ... with the numpy dtype and shape in the manifest
# (utils/npz's codec, as checkpoint.py uses), so bfloat16 round-trips and a
# column called "file" cannot collide with savez's own parameters.

_MANIFEST = "frame.json"
_DENSE = "columns.npz"
_HOST = "host_columns.pkl"
_FORMAT_VERSION = 1


def _host_array(v) -> np.ndarray:
    """A column block as a host numpy array (a tensor, on any device,
    comes back through ``dtypes.to_numpy``)."""
    return dt.to_numpy(v) if torch.is_tensor(v) else np.asarray(v)


def save_frame_sharded(frame, path: str) -> str:
    """Multi-rank frame persistence: every rank writes ITS OWN rows.

    A sharded frame spans ranks, so no rank can materialize it
    (``save_frame`` refuses). Instead each rank writes its rows (a
    sharded frame's main block, and the host tail on rank 0) to
    ``path/part-<rank>`` through :func:`save_frame` (atomic per part), and
    every rank writes the same ``parts.json`` (``{"num_parts": world}``),
    so a reload on another rank count fails loudly instead of dropping
    parts. A frame on one rank makes one part. Returns this rank's part
    directory. Every rank calls it in lockstep; ``path`` is shared
    storage."""
    import json

    from .frame import TensorFrame
    from .ops.device_agg import local_blocks
    from .parallel.distributed import process_count, process_index

    pid = process_index()
    blocks = local_blocks(frame)
    local_block: Dict[str, object] = {}
    for info in frame.schema:
        parts = [b[info.name] for b in blocks]
        if any(isinstance(p, list) for p in parts):
            flat: list = []
            for p in parts:
                flat.extend(list(p))
            local_block[info.name] = flat
        else:
            local_block[info.name] = np.concatenate([_host_array(p) for p in parts], axis=0)
    part = os.path.join(path, f"part-{pid}")
    os.makedirs(path, exist_ok=True)
    save_frame(TensorFrame([local_block], frame.schema), part)
    meta = os.path.join(path, "parts.json")
    tmp = f"{meta}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"num_parts": process_count()}, f)
    os.replace(tmp, meta)
    return part


def load_frame_sharded(path: str, mesh=None, axis: Optional[str] = None):
    """Load this rank's ``part-<rank>`` written by :func:`save_frame_sharded`
    and reassemble the sharded frame
    (:func:`~tensorframes_tpu_torch.parallel.frame_from_process_local`).
    The part count must equal the world size. Host-only columns are not
    supported across ranks, as in the reference."""
    import json

    from .parallel.distributed import frame_from_process_local, process_count, process_index

    meta_path = os.path.join(path, "parts.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            num_parts = json.load(f)["num_parts"]
        if num_parts != process_count():
            raise ValueError(
                f"load_frame_sharded: saved with {num_parts} process(es) "
                f"but loading with {process_count()}; part counts must "
                "match (repartition via a single-process load_frame of "
                "each part instead)"
            )
    local = load_frame(os.path.join(path, f"part-{process_index()}"), num_blocks=1)
    [block] = local.blocks()
    data = {}
    for info in local.schema:
        v = block[info.name]
        if isinstance(v, list):
            raise TypeError(
                f"Column {info.name!r}: host-only columns cannot span "
                "processes; drop them before save_frame_sharded or load "
                "the part directly with load_frame"
            )
        data[info.name] = v
    return frame_from_process_local(data, mesh=mesh, axis=axis)


def save_frame(frame, path: str) -> None:
    """Write a frame to ``path`` (a directory, created if needed).

    Device columns are materialized to host numpy; block structure is not
    kept (reload with any ``num_blocks``). The whole directory is built
    aside and swapped in, so a crash never pairs a new manifest with old
    columns, and the previous frame stays on disk under ``<path>.old``
    until the swap is complete (a later save or load heals a crash inside
    the swap)."""
    import json
    import pickle
    import shutil

    fault_point("io.save_frame")
    check = getattr(frame, "_check_global", None)
    for name in frame.schema.names if check is not None else ():
        check(name)  # a frame across ranks: save_frame_sharded
    dense: Dict[str, np.ndarray] = {}
    host: Dict[str, list] = {}
    cols = []
    blocks = frame.blocks()
    for i, info in enumerate(frame.schema):
        vals = [b[info.name] for b in blocks]
        is_list = any(isinstance(v, list) for v in vals)
        col = {
            "name": info.name,
            "dtype": info.dtype.name,
            "block_shape": list(info.block_shape.dims),
        }
        if info.is_device and not is_list:
            arr = np.concatenate([_host_array(v) for v in vals], axis=0)
            dense[f"c{i}"], entry = encode_array(arr)
            col["np_dtype"] = entry["dtype"]
            col["np_shape"] = entry["shape"]
        else:
            flat: list = []
            for v in vals:
                flat.extend(list(v))
            host[info.name] = flat
        cols.append(col)
    manifest = {
        "format_version": _FORMAT_VERSION,
        "num_rows": frame.num_rows,
        "columns": cols,
    }
    # normpath first: with a trailing slash the temporary directory would
    # land inside the target and be deleted with it
    path = os.path.normpath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        os.makedirs(tmp)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        np.savez_compressed(os.path.join(tmp, _DENSE), **dense)
        if host:
            with open(os.path.join(tmp, _HOST), "wb") as f:
                pickle.dump(host, f)
        # a recoverable frame on disk at every instant: the old directory
        # moves aside under a fixed name, the new one moves in, and only
        # then is the old one deleted
        old = f"{path}.old"
        if os.path.isdir(old) and not os.path.isdir(path):
            os.rename(old, path)  # heal an earlier save's crashed swap
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    logger.info(
        "save_frame: %d rows, %d dense + %d host columns -> %s",
        manifest["num_rows"], len(dense), len(host), path,
    )


def load_frame(path: str, num_blocks: Optional[int] = None):
    """Load a frame written by :func:`save_frame` (of either package)."""
    import json
    import pickle

    from .config import get_config
    from .frame import TensorFrame, _partition_bounds
    from .schema import ColumnInfo, Schema
    from .shape import Shape

    fault_point("io.load_frame")
    path = os.path.normpath(path)
    if not os.path.isdir(path) and os.path.isdir(f"{path}.old"):
        # a save crashed inside its swap: the previous frame is intact
        # under the fixed aside name
        path = f"{path}.old"
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format_version", 0) > _FORMAT_VERSION:
        raise ValueError(
            f"frame at {path} has format_version "
            f"{manifest['format_version']}; this build reads <= {_FORMAT_VERSION}"
        )
    raw = {}
    npz = os.path.join(path, _DENSE)
    if os.path.exists(npz):
        with np.load(npz, allow_pickle=False) as z:
            raw = {k: z[k] for k in z.files}
    host = {}
    pkl = os.path.join(path, _HOST)
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            host = pickle.load(f)

    infos = []
    data: Dict[str, object] = {}
    for i, c in enumerate(manifest["columns"]):
        infos.append(
            ColumnInfo(c["name"], dt.by_name(c["dtype"]), Shape(c["block_shape"]))
        )
        if f"c{i}" in raw:  # dense: bytes -> the manifest's dtype and shape
            data[c["name"]] = dt.to_numpy(decode_array(
                raw[f"c{i}"], {"dtype": c["np_dtype"], "shape": c["np_shape"]}
            ))
        else:
            data[c["name"]] = host[c["name"]]

    n = manifest["num_rows"]
    k = num_blocks or min(get_config().default_num_blocks, max(1, n))
    blocks = []
    for lo, hi in _partition_bounds(n, k):
        blocks.append({name: v[lo:hi] for name, v in data.items()})
    return TensorFrame(blocks, Schema(infos))


# ---------------------------------------------------------------------------
# CSV ingestion
# ---------------------------------------------------------------------------

def _infer_csv_types(sample_rows, ncols):
    """Per-column type lattice over sample fields: int ⊂ float ⊂ str;
    empty fields promote numeric columns to float (missing → NaN)."""
    kinds = ["int"] * ncols
    for fields in sample_rows:
        for j in range(ncols):
            f = fields[j] if j < len(fields) else ""
            k = kinds[j]
            if k == "str":
                continue
            if f == "":
                if k == "int":
                    kinds[j] = "float"
                continue
            try:
                int(f)
                continue
            except ValueError:
                pass
            try:
                float(f)
                kinds[j] = "float"
            except ValueError:
                kinds[j] = "str"
    return kinds


def read_csv(
    path,
    delimiter: str = ",",
    dtypes: Optional[Dict[str, str]] = None,
    num_blocks: Optional[int] = None,
    rows_per_chunk: int = 262_144,
):
    """Read a header-ed CSV into a frame: int64/float64 columns for
    numeric data (types inferred from a sample; empty numeric fields →
    NaN through float promotion), string columns host-resident.

    Unquoted files with a one-byte delimiter parse in one native C++ pass
    (``native.parse_csv``); quoted files, longer delimiters and
    ``TFS_TPU_DISABLE_NATIVE=1`` take the csv-module path, with the same
    semantics. ``dtypes`` ({column: "int64"|"float64"|"string"}) overrides
    inference per column.

    ``path`` may also be a directory or a list of part files (each with
    its own header). Parts then ingest chunk by chunk through a spillable
    :class:`~tensorframes_tpu_torch.blockstore.BlockStore` (budget
    ``TFTPU_BLOCK_BUDGET_MB``): peak ingest memory is bounded by the
    largest part plus the budget, and the frame's dense blocks are
    ``np.memmap`` views over the spilled segments. Column types are
    inferred from the first part with rows and pinned for the rest.
    ``num_blocks`` is honored by an explicit (materializing)
    ``repartition``. For frames that must never materialize, walk
    :func:`scan_csv` with ``blockstore.stream_chain``."""
    if isinstance(path, (list, tuple)) or os.path.isdir(path):
        frame = _frame_via_store(
            scan_csv(
                path, delimiter=delimiter, dtypes=dtypes,
                rows_per_chunk=rows_per_chunk,
            ),
            what=f"read_csv({path!r})",
        )
        if frame is None:
            # every part was header-only: the single-file path builds the
            # typed zero-row frame
            [first, *_] = _part_files(path, PART_EXTS["csv"])
            return _read_csv_single(
                first, delimiter=delimiter, dtypes=dtypes,
                num_blocks=num_blocks,
            )
        return frame.repartition(num_blocks) if num_blocks else frame
    return _read_csv_single(
        path, delimiter=delimiter, dtypes=dtypes, num_blocks=num_blocks
    )


def _read_csv_single(
    path: str,
    delimiter: str = ",",
    dtypes: Optional[Dict[str, str]] = None,
    num_blocks: Optional[int] = None,
):
    """One CSV file → frame."""
    import csv as _csv
    import re

    from . import native
    from .frame import frame_from_arrays

    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"\n")
    quoted = b'"' in data
    head_text = head.decode("utf-8").rstrip("\r")
    if quoted:
        # quoted files get real csv parsing everywhere, header included
        names = next(_csv.reader([head_text], delimiter=delimiter))
        names = [h.strip() for h in names]
    else:
        names = [h.strip() for h in head_text.split(delimiter)]
    ncols = len(names)

    _KIND_FOR = {"int64": "int", "float64": "float", "string": "str"}

    def apply_overrides(kinds):
        for j, n in enumerate(names):
            want = (dtypes or {}).get(n)
            if want is not None:
                if want not in _KIND_FOR:
                    raise ValueError(
                        f"read_csv: unsupported dtype {want!r} for column "
                        f"{n!r}; supported: {sorted(_KIND_FOR)}"
                    )
                kinds[j] = _KIND_FOR[want]
        return kinds

    if re.search(rb"\S", body) is None:
        # no rows: build the typed empty frame from explicit column infos
        from .frame import TensorFrame
        from .schema import ColumnInfo, Schema
        from .shape import Shape, Unknown

        kinds = apply_overrides(["float"] * ncols)
        kind_dt = {"int": "int64", "float": "float64", "str": "string"}
        infos, block = [], {}
        for n, k in zip(names, kinds):
            scalar = dt.by_name(kind_dt[k])
            infos.append(ColumnInfo(n, scalar, Shape((Unknown,))))
            block[n] = (
                [] if k == "str" else np.empty((0,), scalar.np_dtype)
            )
        return TensorFrame([block], Schema(infos))

    # inference over a bounded prefix (the first 100 lines of the first
    # MiB), then the per-column overrides
    prefix = body[: 1 << 20]
    lines = prefix.split(b"\n")
    if len(body) > len(prefix):
        lines = lines[:-1]  # the last line may be cut mid-field
    sample_text = [
        line.decode("utf-8", "replace").rstrip("\r")
        for line in lines[:100]
        if line.strip()
    ]
    if quoted:
        sample = list(_csv.reader(sample_text, delimiter=delimiter))
    else:
        sample = [t.split(delimiter) for t in sample_text]
    kinds = apply_overrides(_infer_csv_types(sample, ncols))

    cols: Dict[str, object] = {}
    out = None
    if not quoted and len(delimiter) == 1:
        codes = [{"int": 3, "float": 0, "str": 4}[k] for k in kinds]
        out = native.parse_csv(body, delimiter, codes)
    if out is not None:
        for j, n in enumerate(names):
            if kinds[j] == "str":
                cols[n] = out[j]
            else:
                npdt = np.int64 if kinds[j] == "int" else np.float64
                cols[n] = np.frombuffer(out[j], dtype=npdt)
        logger.debug("read_csv: native parse of %d rows", out[-1])
    else:
        text = body.decode("utf-8", "replace").splitlines()
        reader = _csv.reader(text, delimiter=delimiter)
        raw: List[List[str]] = [r for r in reader if r]
        for j, n in enumerate(names):
            vals = [r[j] if j < len(r) else "" for r in raw]
            if kinds[j] == "int":
                cols[n] = np.asarray([int(v) for v in vals], np.int64)
            elif kinds[j] == "float":
                cols[n] = np.asarray(
                    [float(v) if v != "" else np.nan for v in vals], np.float64
                )
            else:
                cols[n] = vals
    return frame_from_arrays(cols, num_blocks=num_blocks)


# ---------------------------------------------------------------------------
# Chunked multi-part ingest through the block store
# ---------------------------------------------------------------------------

#: Part-file extensions per scan kind.
PART_EXTS: Dict[str, tuple] = {
    "csv": (".csv", ".tsv", ".txt"),
    "parquet": (".parquet", ".pq"),
}


def _part_files(paths, exts) -> List[str]:
    """Resolve a directory (sorted, extension-filtered) or an explicit
    list (its order kept: it is the row order) to part files."""
    if isinstance(paths, (list, tuple)):
        out = [os.fspath(p) for p in paths]
        missing = [p for p in out if not os.path.isfile(p)]
        if missing:
            raise FileNotFoundError(f"part file(s) not found: {missing}")
        if not out:
            raise ValueError("empty part-file list")
        return out
    out = []
    for name in sorted(os.listdir(paths)):
        full = os.path.join(paths, name)
        if name.startswith((".", "_")) or not os.path.isfile(full):
            continue
        if os.path.splitext(name)[1].lower() in exts:
            out.append(full)
    if not out:
        raise ValueError(
            f"no part files matching {sorted(exts)} under {paths!r}"
        )
    return out


def part_manifest(paths, kind: str = "csv") -> List[Tuple[str, str]]:
    """Chunk-arrival manifest of a growing directory (or explicit part
    list): ``[(path, signature), ...]`` in scan order, the signature being
    :func:`compilecache.fingerprint.part_signature` (basename, size,
    mtime_ns: O(#files) stat calls, no content read). An appended part
    shows up as a new row, a rewritten part keeps its path and moves its
    signature, a removed part drops its row."""
    from .compilecache.fingerprint import part_signature

    try:
        exts = PART_EXTS[kind]
    except KeyError:
        raise ValueError(
            f"part_manifest kind must be one of {sorted(PART_EXTS)}, "
            f"got {kind!r}"
        ) from None
    return [(p, part_signature(p)) for p in _part_files(paths, exts)]


def part_frame(path: str, kind: str = "csv", delimiter: str = ",",
               dtypes: Optional[Dict[str, str]] = None):
    """One part file → one frame (zero-row for a header-only CSV part):
    the registered query's per-chunk read. ``dtypes`` pins CSV column
    types as :func:`scan_csv`'s first-part pinning does."""
    if kind == "csv":
        return _read_csv_single(
            path, delimiter=delimiter, dtypes=(dtypes or None),
            num_blocks=1,
        )
    if kind == "parquet":
        _require_pyarrow()
        import pyarrow.parquet as pq

        return frame_from_arrow(pq.read_table(path), num_blocks=1)
    raise ValueError(
        f"part_frame kind must be one of {sorted(PART_EXTS)}, got {kind!r}"
    )


def _iter_row_chunks(block: Dict[str, object], rows_per_chunk: int):
    n = 0
    for v in block.values():
        n = len(v)
        break
    for lo in range(0, n, max(1, rows_per_chunk)):
        hi = min(n, lo + rows_per_chunk)
        yield {k: v[lo:hi] for k, v in block.items()}


def scan_csv(
    paths,
    delimiter: str = ",",
    dtypes: Optional[Dict[str, str]] = None,
    rows_per_chunk: int = 262_144,
) -> Iterator[Dict[str, object]]:
    """Chunked CSV scan: yield ``{column: array|list}`` blocks of at most
    ``rows_per_chunk`` rows from a directory or list of part files, one
    part in memory at a time — the block source of
    ``blockstore.stream_chain``. Types are inferred from the first part
    with rows and pinned for the rest (or pass ``dtypes``); a part that
    does not parse under the pinned types raises. Only non-empty blocks
    are yielded."""
    overrides: Dict[str, str] = dict(dtypes or {})
    pinned = False
    for part in _part_files(paths, PART_EXTS["csv"]):
        f = _read_csv_single(
            part, delimiter=delimiter,
            dtypes=(overrides or None), num_blocks=1,
        )
        if not pinned and f.num_rows > 0:
            # pin from the first part with rows: a header-only part
            # infers float64 everywhere
            for info in f.schema:
                overrides.setdefault(info.name, info.dtype.name)
            pinned = True
        if f.num_rows == 0:
            continue
        [block] = f.blocks()
        yield from _iter_row_chunks(block, rows_per_chunk)


def scan_parquet(
    paths, rows_per_chunk: int = 262_144
) -> Iterator[Dict[str, object]]:
    """Chunked Parquet scan (pyarrow's batch reader): yield blocks of at
    most ``rows_per_chunk`` rows from a directory or list of part files
    without materializing a whole table."""
    pa = _require_pyarrow()
    import pyarrow.parquet as pq

    for part in _part_files(paths, PART_EXTS["parquet"]):
        pf = pq.ParquetFile(part)
        for batch in pf.iter_batches(batch_size=max(1, rows_per_chunk)):
            if batch.num_rows == 0:
                continue
            f = frame_from_arrow(
                pa.Table.from_batches([batch]), num_blocks=1
            )
            [block] = f.blocks()
            yield block


def _frame_via_store(blocks_iter, what: str):
    """Ingest a block stream through a spillable BlockStore and rebuild a
    frame over memmap views of the spilled segments; the store lives as
    long as the frame. None when the stream yielded no block."""
    import weakref

    from .blockstore import BlockStore
    from .blockstore.partitioner import SpilledFrame
    from .frame import frame_from_arrays

    store = BlockStore()
    refs, schema, sig = [], None, None
    try:
        for block in blocks_iter:
            f = frame_from_arrays(block, num_blocks=1)
            fsig = [(i.name, i.dtype.name) for i in f.schema]
            if schema is None:
                schema, sig = f.schema, fsig
            elif fsig != sig:
                raise ValueError(
                    f"{what}: part schema drifted — first part "
                    f"{sig}, this chunk {fsig}; pass dtypes= to pin "
                    "column types across parts"
                )
            [b] = f.blocks()
            refs.append(store.put(b))
    except BaseException:
        store.close()
        raise
    if schema is None:
        store.close()
        return None
    spilled = SpilledFrame(store, refs, schema, owns_store=True)
    frame = spilled.to_frame(mmap=True)
    # the spill segments live as long as the frame (on Linux open memmaps
    # stay valid over the unlink)
    frame._data_plane = spilled
    weakref.finalize(frame, spilled.drop)
    logger.info(
        "%s: ingested %d chunk(s), %d rows via block store "
        "(resident=%d spilled=%d)",
        what, len(refs), spilled.num_rows, store.resident_bytes,
        store.spilled_bytes,
    )
    return frame


def write_csv(frame, path: str, delimiter: str = ",") -> None:
    """Write a frame to a header-ed CSV (the inverse of :func:`read_csv`).
    Vector cells are refused: CSV holds scalar columns only."""
    import csv as _csv

    cols = {}
    for info in frame.schema:
        if info.cell_shape.rank > 0:
            raise ValueError(
                f"write_csv: column {info.name!r} has cell shape "
                f"{info.cell_shape}; CSV holds scalar columns only"
            )
        cols[info.name] = frame.column_values(info.name)
    names = list(cols)
    n = len(next(iter(cols.values()))) if names else 0
    with open(path, "w", newline="") as f:
        w = _csv.writer(f, delimiter=delimiter)
        w.writerow(names)
        for i in range(n):
            w.writerow([cols[c][i] for c in names])


# ---------------------------------------------------------------------------
# Arrow / Parquet interop (pyarrow, imported when called)
# ---------------------------------------------------------------------------

def _require_pyarrow():
    try:
        import pyarrow  # noqa: F401

        return pyarrow
    except ImportError as e:
        raise ImportError(
            "pyarrow is required for arrow/parquet interop "
            "(pip install pyarrow)"
        ) from e


def frame_from_arrow(table, num_blocks: Optional[int] = None):
    """Build a frame from a pyarrow Table (numeric columns without nulls
    without a copy). Strings become host columns; list-typed columns
    per-row cells (dense if uniform, ragged otherwise)."""
    pa = _require_pyarrow()
    from .frame import frame_from_arrays

    data: Dict[str, object] = {}
    for name in table.column_names:
        col = table.column(name)
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        t = col.type
        if pa.types.is_integer(t) or pa.types.is_floating(t):
            if col.null_count:
                if pa.types.is_integer(t):
                    raise ValueError(
                        f"Column {name!r} has nulls; integer columns cannot "
                        "represent missing values (cast to float upstream)"
                    )
                data[name] = col.to_numpy(zero_copy_only=False)
            else:
                data[name] = col.to_numpy(zero_copy_only=True)
        elif pa.types.is_boolean(t):
            data[name] = col.to_numpy(zero_copy_only=False)
        elif pa.types.is_string(t) or pa.types.is_large_string(t):
            data[name] = col.to_pylist()
        elif pa.types.is_binary(t) or pa.types.is_large_binary(t):
            data[name] = col.to_pylist()
        elif pa.types.is_list(t) or pa.types.is_large_list(t) or (
            pa.types.is_fixed_size_list(t)
        ):
            data[name] = [
                np.asarray(cell) if cell is not None else None
                for cell in col.to_pylist()
            ]
        else:
            raise TypeError(f"Column {name!r}: unsupported arrow type {t}")
    return frame_from_arrays(data, num_blocks=num_blocks)


def frame_to_arrow(frame):
    """Frame → pyarrow Table. Scalar numeric columns without a copy;
    vector cells become arrow lists; host columns pass through."""
    pa = _require_pyarrow()

    arrays = {}
    for info in frame.schema:
        v = frame.column_values(info.name)
        if isinstance(v, np.ndarray) and v.dtype != object and v.ndim == 1:
            arrays[info.name] = pa.array(v)
        elif isinstance(v, np.ndarray) and v.dtype != object:
            arrays[info.name] = pa.array([row.tolist() for row in v])
        else:
            arrays[info.name] = pa.array(list(v))
    return pa.table(arrays)


def read_parquet(
    path, num_blocks: Optional[int] = None, rows_per_chunk: int = 262_144
):
    """Read a parquet file into a frame (pyarrow). A directory or a list
    of part files ingests batch by batch through a spillable block store,
    as the multi-part :func:`read_csv` does."""
    _require_pyarrow()
    import pyarrow.parquet as pq

    if isinstance(path, (list, tuple)) or os.path.isdir(path):
        frame = _frame_via_store(
            scan_parquet(path, rows_per_chunk=rows_per_chunk),
            what=f"read_parquet({path!r})",
        )
        if frame is None:  # every part empty: the single-file path
            [first, *_] = _part_files(path, PART_EXTS["parquet"])
            return frame_from_arrow(
                pq.read_table(first), num_blocks=num_blocks
            )
        return frame.repartition(num_blocks) if num_blocks else frame
    return frame_from_arrow(pq.read_table(path), num_blocks=num_blocks)


def write_parquet(frame, path: str) -> None:
    """Write a frame to a parquet file (pyarrow)."""
    _require_pyarrow()
    import pyarrow.parquet as pq

    pq.write_table(frame_to_arrow(frame), path)
