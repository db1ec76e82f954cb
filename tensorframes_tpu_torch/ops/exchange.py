"""Hash/range-partitioned exchange between ranks — the counterpart of
Catalyst's shuffle exchange (``DebugRowOps.scala:583``: Spark
hash-partitions both sides of a join/sort across executors so no
executor holds the global frame).

The multi-rank relational verbs replicate their inputs (allgather sort,
broadcast join) under ``config.relational_broadcast_bytes``; past it they
shuffle through this module:

* :func:`partition_by_hash` — content-stable row hashes (identical on
  every process for the same values, unlike ``ops.keys.group_ids``
  codes, which depend on local data order) → ``hash % P``.
* :func:`partition_by_range` — sampled splitters (identical on every
  process: the sample is allgathered, tiny) → partition p holds the
  p-th key range, so concatenating per-process results in process
  order IS the global sort order.
* :func:`exchange_rows` — the data plane: per-destination pickled
  payloads ride padded ``uint8`` rounds of ``dist.all_to_all_single``
  (NCCL between CUDA ranks, gloo between CPU ranks;
  :func:`..parallel.collectives.all_to_all_bytes`), so each rank
  receives only its partition.

Memory per process: O(global/P) for balanced keys (max payload over
(src, dst) pairs × P), vs O(global) for the replicating plans. The
replicating plans remain the small-frame fast path behind
``config.relational_broadcast_bytes``. :func:`content_hash64`,
:func:`partition_by_hash` and :func:`partition_by_range` are the JAX
package's, bit for bit (numpy).
"""

from __future__ import annotations

import pickle
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

# splitmix64 constants — a well-mixed 64-bit finalizer (public domain
# constant set; avalanches every input bit across the output)
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)

from ..observability.metrics import counter as _counter

# observability for tests and debugging: per-call accounting of the
# last exchange on THIS rank
# ({"sent": [P], "received": [P], "rounds": n, "chunk": bytes, ...})
last_exchange_stats: Optional[Dict[str, object]] = None

EXCHANGE_WIRE_BYTES = _counter(
    "tftpu_exchange_wire_bytes_total",
    "Padded bytes this rank sent through all_to_all_single in row "
    "exchanges (each round's [world, slot] buffer)",
)
EXCHANGE_PAYLOAD_BYTES = _counter(
    "tftpu_exchange_payload_bytes_total",
    "Pickled row bytes this rank addressed to its peers (itself included) "
    "in row exchanges",
)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array (vectorized)."""
    x = x + _SM_GAMMA
    x = (x ^ (x >> np.uint64(30))) * _SM_M1
    x = (x ^ (x >> np.uint64(27))) * _SM_M2
    return x ^ (x >> np.uint64(31))


def _cell_bytes(v) -> bytes:
    if isinstance(v, str):
        return v.encode("utf-8", "surrogatepass")
    if isinstance(v, bytes):
        return v
    if isinstance(v, np.ndarray):
        return v.tobytes()
    # None and anything else with a stable repr; repr is deterministic
    # across processes for the primitive cell types host columns hold
    # (PYTHONHASHSEED salts hash(), so hash() is NOT usable)
    return repr(v).encode("utf-8")


def _f64_bits(f: np.ndarray) -> np.ndarray:
    """Canonical float64 bit patterns: one NaN, -0.0 == +0.0."""
    f = f.astype(np.float64, copy=True)
    f[np.isnan(f)] = np.nan
    f[f == 0.0] = 0.0
    return f.view(np.uint64)


_NUMERIC_CELL = (bool, int, float, np.integer, np.floating, np.bool_)


def content_hash64(arrs: Sequence) -> np.ndarray:
    """Per-row uint64 hashes that are IDENTICAL on every process for
    identical key values — the property partition assignment needs and
    dictionary codes don't have.

    EVERY numeric value (bool/int/uint/float, array or object cell)
    hashes through its canonical float64 bit pattern: the join's
    broadcast path compares key unions after numpy promotion
    (``np.concatenate([int_col, float_col])`` → f64), so 5 must hash
    like 5.0 or a size-triggered switch to the hash exchange would
    silently drop cross-dtype matches. Distinct huge ints that collide
    in f64 merely COLOCATE (a harmless partition collision — they
    compare equal in the promoted join too). String/bytes/other cells
    hash their bytes (crc32 + length, mixed to 64 bits)."""
    np_err = np.seterr(over="ignore")  # uint64 mixing wraps by design
    try:
        combined = None
        for a in arrs:
            if isinstance(a, list):
                a = np.asarray(a, dtype=object)
            a = np.asarray(a)
            if a.dtype == object or a.dtype.kind in ("U", "S"):
                cells = a.tolist()
                h = np.empty(len(cells), np.uint64)
                for i, v in enumerate(cells):
                    if isinstance(v, _NUMERIC_CELL):
                        h[i] = _f64_bits(np.asarray([v]))[0]
                    else:
                        b = _cell_bytes(v)
                        h[i] = np.uint64(
                            zlib.crc32(b) ^ (len(b) << 32)
                        )
            else:  # every numeric family → canonical f64 bits
                h = _f64_bits(a)
            h = _mix64(h)
            combined = h if combined is None else _mix64(combined ^ h)
        return combined
    finally:
        np.seterr(**np_err)


def partition_by_hash(key_cols: Sequence, num_parts: int) -> np.ndarray:
    """Destination partition per local row: ``content_hash64 % P``."""
    return (content_hash64(key_cols) % np.uint64(num_parts)).astype(np.int64)


def _lex_geq(row_cols, split_tuple, asc) -> np.ndarray:
    """Vectorized ``row >= splitter`` under lexicographic multi-key
    order with per-key ascending flags. ``row_cols`` holds per-key
    int64 code arrays, ``split_tuple`` the splitter's codes. Rows fully
    equal to the splitter compare >= (ties land in the higher
    partition, matching the splitter-count assignment)."""
    n = len(row_cols[0])
    geq = np.ones(n, bool)  # fully-equal default
    decided = np.zeros(n, bool)
    for col, sv, a in zip(row_cols, split_tuple, asc):
        gt = (col > sv) if a else (col < sv)
        lt = (col < sv) if a else (col > sv)
        geq = np.where(~decided & gt, True, geq)
        geq = np.where(~decided & lt, False, geq)
        decided = decided | gt | lt
    return geq


def partition_by_range(
    key_cols: Sequence,
    num_parts: int,
    ascending: Sequence[bool],
    sample_per_process: int = 2048,
) -> np.ndarray:
    """Range partitioning for the distributed sort: every process
    allgathers a small deterministic SAMPLE of its key rows, computes
    identical splitters from the union, and assigns each local row to
    ``#{splitters lexicographically <= row}``. Concatenating partitions
    0..P-1 in order then yields the global sort order (each partition is
    sorted locally afterwards). The sample is the only replicated data —
    O(P * sample) rows, independent of frame size."""
    from .device_agg import _allgather_dicts
    from .keys import _unique_inverse

    local = [
        np.asarray(a, dtype=object) if isinstance(a, list) else np.asarray(a)
        for a in key_cols
    ]
    n = len(local[0])
    # deterministic evenly-spaced sample (no RNG: every process must be
    # reproducible, and order bias is broken by the global union)
    take = min(n, sample_per_process)
    idx = (
        np.linspace(0, n - 1, take).astype(np.int64)
        if take
        else np.zeros(0, np.int64)
    )
    sample = [a[idx] for a in local]
    union, _ = _allgather_dicts(sample)

    # codes must be computed over sample∪local TOGETHER: _unique_inverse
    # codes are only comparable within one encode pass. The comparison
    # RESULTS are value-determined, hence identical across processes
    # even though the codes differ.
    m = len(union[0])
    codes = []
    for u_col, l_col in zip(union, local):
        if u_col.dtype == object or l_col.dtype == object:
            both = np.empty(m + n, dtype=object)
            both[:m] = list(u_col)
            both[m:] = list(l_col)
        else:
            both = np.concatenate([u_col, l_col])
        codes.append(_unique_inverse(both)[1].astype(np.int64))
    samp_codes = [c[:m] for c in codes]
    row_codes = [c[m:] for c in codes]

    # identical splitters everywhere: lexsort the union sample (which is
    # identical on every process) and read P-1 quantile rows
    order = np.lexsort(
        [
            c if a else -c
            for c, a in zip(reversed(samp_codes), reversed(ascending))
        ]
    )
    if m == 0 or num_parts == 1:
        return np.zeros(n, np.int64)
    q = [
        order[min(m - 1, (m * (i + 1)) // num_parts)]
        for i in range(num_parts - 1)
    ]
    part = np.zeros(n, np.int64)
    for s_idx in q:
        split = tuple(c[s_idx] for c in samp_codes)
        part += _lex_geq(row_codes, split, ascending).astype(np.int64)
    return part


# per-round budget for the padded all_to_all buffers (send and receive
# buffers are each [P, round_width] — bounded by this regardless of skew)
_EXCHANGE_ROUND_BYTES = 64 << 20


def _exchange_bytes(parts: List[bytes]) -> List[bytes]:
    """All-to-all of arbitrary byte payloads between ranks: entry
    ``parts[dst]`` is sent from this rank to ``dst``; returns
    ``recv[src]`` = the payload ``src`` addressed to this rank.

    One size allgather (tiny) + CHUNKED padded uint8 ``all_to_all_single``
    rounds: padding every slot to the global max payload would cost
    P × max bytes per rank — O(global) again under a hot-key skew.
    Chunking bounds the in-flight buffers to ``_EXCHANGE_ROUND_BYTES``
    per direction per round; only the hot partition's owner accumulates
    its (genuinely large) partition."""
    global last_exchange_stats
    from ..parallel.collectives import all_to_all_bytes

    recv, stats = all_to_all_bytes(parts, _EXCHANGE_ROUND_BYTES)
    EXCHANGE_WIRE_BYTES.inc(float(stats["wire_bytes"]))
    EXCHANGE_PAYLOAD_BYTES.inc(float(sum(stats["sent"])))
    last_exchange_stats = {**stats, "transport": "all_to_all_single"}
    return recv


def _file_shuffle_ctx():
    """The file-transport shuffle context (blockstore.shuffle), or None
    when no shuffle dir is armed — the exchange then rides the
    collective. A context whose world disagrees with an initialized
    multi-rank process group is IGNORED (callers partition rows by the
    process count, and a smaller file world would silently drop the
    excess partitions). Lazy import: the exchange must not pull the
    blockstore package into processes that never shuffle."""
    from ..blockstore import shuffle as _fs
    from ..parallel.distributed import process_count

    ctx = _fs.context() if _fs.enabled() else None
    if ctx is not None and process_count() > 1 and ctx.nprocs != process_count():
        return None
    return ctx


def _exchange_bytes_files(parts: List[bytes], ctx) -> List[bytes]:
    """File-transport twin of :func:`_exchange_bytes`: per-rank spill
    files in the shared shuffle dir (blockstore.shuffle.exchange) —
    CRC-framed, deadline-bounded, no collective involved, so it works
    between plain OS processes. Keeps ``last_exchange_stats`` populated
    for the same observability."""
    global last_exchange_stats
    from ..blockstore import shuffle as _fs

    recv = _fs.exchange(parts, name="exchange_rows", ctx=ctx)
    last_exchange_stats = {
        "sent": [len(p) for p in parts],
        "received": [len(b) for b in recv],
        "rounds": 1,
        "chunk": max((len(p) for p in parts), default=0),
        "transport": "files",
    }
    return recv


def exchange_rows(
    cols: Dict[str, object], part: np.ndarray
) -> Dict[str, object]:
    """Shuffle this rank's rows to their partition owners and return the
    rows every rank sent HERE (source-rank order, then local row order —
    deterministic). ``cols`` maps names to rank-local numpy arrays or
    cell lists; ``part`` holds each row's destination rank. Everything
    serializes through pickle so string/object and multi-dim columns
    exchange the same way.

    Transport: the chunked ``all_to_all_single`` collective by default;
    per-rank spill files (:mod:`tensorframes_tpu_torch.blockstore.shuffle`)
    when a shuffle dir is armed (``TFTPU_SHUFFLE_DIR``, or
    ``TFTPU_SHUFFLE_TRANSPORT=files`` on a rendezvous-dir fleet) — rank
    and world then come from the shuffle context, so processes without a
    process group exchange the same way."""
    from ..parallel.distributed import process_count

    fctx = _file_shuffle_ctx()
    procs = fctx.nprocs if fctx is not None else process_count()
    names = list(cols)
    as_arr = {
        n: (
            np.asarray(v, dtype=object)
            if isinstance(v, list)
            else np.asarray(v)
        )
        for n, v in cols.items()
    }
    payloads = []
    for dst in range(procs):
        sel = np.flatnonzero(part == dst)
        sub = [as_arr[n][sel] for n in names]
        payloads.append(
            pickle.dumps(sub, protocol=pickle.HIGHEST_PROTOCOL)
        )
    received = (
        _exchange_bytes_files(payloads, fctx)
        if fctx is not None
        else _exchange_bytes(payloads)
    )
    chunks = [pickle.loads(b) for b in received]
    out: Dict[str, object] = {}
    for i, n in enumerate(names):
        pieces = [c[i] for c in chunks]
        if as_arr[n].dtype == object:
            merged: List[object] = []
            for p in pieces:
                merged.extend(list(p))
            out[n] = merged
        else:
            out[n] = np.concatenate(pieces) if pieces else as_arr[n][:0]
    return out


def global_frame_bytes(local_cols: Dict[str, object]) -> int:
    """Total bytes of the GLOBAL frame (sum over ranks of this rank's
    estimate) — the quantity the broadcast-vs-exchange budget gates on.
    One tiny all-reduce."""
    import torch

    from ..parallel.collectives import all_reduce

    local = 0
    for v in local_cols.values():
        if isinstance(v, np.ndarray) and v.dtype != object:
            local += int(v.nbytes)
        else:
            cells = v if isinstance(v, list) else list(v)
            for c in cells:
                local += (
                    int(np.asarray(c).nbytes)
                    if isinstance(c, np.ndarray)
                    else len(_cell_bytes(c))
                )
    return int(all_reduce(torch.tensor([local], dtype=torch.int64), "sum")[0])
