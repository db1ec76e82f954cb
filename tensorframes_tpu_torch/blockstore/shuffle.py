"""Distributed shuffle over per-rank spill files: the data-plane
exchange that replaces host-gathered partial tables.

The multi-rank generic aggregate merges its per-rank partial tables by
**allgathering** them — every rank receives every rank's partials
(O(global) per rank). This module is the file-transport alternative:
ranks hash-partition their rows, write one CRC-framed payload file per
destination into a shared shuffle directory (by default
``<rendezvous dir>/shuffle``, the fleet's dir), publish a done-marker,
and read back only the payloads addressed to them. No collective is
involved, so the exchange works between plain OS processes enrolled via
``TFTPU_SHUFFLE_RANK`` / ``TFTPU_SHUFFLE_NPROCS`` (the test-fleet and
external-launcher path) as well as between the ranks of a process group.
File names, frames and JSON are the JAX package's, byte for byte.

Resilience contract:

* payload files publish atomically (write-temp → fsync → rename) and
  carry a length + CRC32 frame; torn/corrupt reads are **retried**
  (``RetryPolicy``), then **quarantined** and raised — never silently
  served;
* waiting for peers is **deadline-bounded**: a rank that dies
  mid-shuffle (kill -9) leaves its done-marker missing, and the wait
  raises :class:`~tensorframes_tpu_torch.resilience.fleet.HungDispatchError`
  **naming the missing ranks** after a flight-recorder postmortem
  (``shuffle.hang``) — the watchdog semantics applied to the data
  plane;
* the ``shuffle.exchange`` fault site (+ delay semantics) rides the
  resilience registry, so drills can fail or stall an exchange
  deterministically.

Transport consumers: ``ops.exchange.exchange_rows`` (joins / sorts /
repartitions pick this transport automatically when a shuffle dir is
armed), the multi-rank aggregate's partial-table merge (ops/verbs.py),
and the high-level :func:`distributed_aggregate` /
:func:`distributed_join` helpers used by external process fleets.
"""

from __future__ import annotations

import os
import pickle
import shutil
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..observability import flight as _flight
from ..observability.metrics import counter as _counter
from ..observability.metrics import histogram as _histogram
from ..resilience.faults import delay_point, fault_point, register_site
from ..resilience.retry import RetryPolicy, retry_call
from ..utils import get_logger

logger = get_logger(__name__)

SHUFFLE_BYTES = _counter(
    "tftpu_blockstore_shuffle_bytes_total",
    "Bytes published to peers through the file-based shuffle exchange",
)
EXCHANGE_SECONDS = _histogram(
    "tftpu_blockstore_shuffle_exchange_seconds",
    "Wall-clock of one full shuffle exchange (publish + barrier + read)",
)

_HDR = struct.Struct("<QI")  # payload length, crc32

register_site(
    "shuffle.exchange",
    "blockstore/shuffle.py exchange/allshare entry and every framed payload "
    "read — an injected Delay stalls this rank's exchange so peers' deadline "
    "waits (and the hung-shuffle postmortem naming this rank) are drillable; "
    "an injected transient OSError exercises the CRC-framed read's retry "
    "policy; a persistent one quarantines the payload and raises "
    "ShuffleCorruptionError",
)


class ShuffleCorruptionError(RuntimeError):
    """A peer's payload file failed its CRC frame after retries; the
    file has been quarantined."""


@dataclass
class ShuffleContext:
    """This process's identity in a file-shuffle fleet. ``root`` is the
    shared shuffle directory; ``rank``/``nprocs`` index this process.
    ``rounds`` counts completed exchanges — every rank calls every
    exchange in lockstep (the SPMD contract all verbs already assume),
    so the local counter agrees fleet-wide and names each round's
    subdirectory without any coordination."""

    root: str
    rank: int
    nprocs: int
    rounds: int = 0


_CTX: Optional[ShuffleContext] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def shuffle_dir() -> Optional[str]:
    """The shared shuffle directory: ``TFTPU_SHUFFLE_DIR``, else — only
    when ``TFTPU_SHUFFLE_TRANSPORT=files`` opts the fleet in — the
    ``shuffle/`` subdirectory of the rendezvous dir
    (``TFTPU_FLEET_DIR``). None = file transport disabled (supervised
    fleets keep their XLA-collective exchange unless they opt in; the
    file transport's lockstep round counter must not be imposed on
    fleets that never call it)."""
    d = os.environ.get("TFTPU_SHUFFLE_DIR")
    if d:
        return d
    if os.environ.get("TFTPU_SHUFFLE_TRANSPORT", "").lower() != "files":
        return None
    from ..resilience.fleet import rendezvous_dir

    rd = rendezvous_dir()
    return os.path.join(rd, "shuffle") if rd else None


def context() -> Optional[ShuffleContext]:
    """Resolve (and cache) this process's shuffle context, or None when
    no shuffle dir is armed. Rank/world come from
    ``TFTPU_SHUFFLE_RANK``/``TFTPU_SHUFFLE_NPROCS`` when set (external
    launchers, subprocess fleets), else from an initialized process
    group, else a single-rank context."""
    global _CTX
    root = shuffle_dir()
    if root is None:
        return None
    rank, nprocs = _env_int("TFTPU_SHUFFLE_RANK"), _env_int("TFTPU_SHUFFLE_NPROCS")
    if rank is None or nprocs is None:
        from ..parallel.distributed import process_count, process_index

        rank, nprocs = process_index(), process_count()
    if (
        _CTX is None
        or _CTX.root != root
        or _CTX.rank != rank
        or _CTX.nprocs != nprocs
    ):
        _CTX = ShuffleContext(root=root, rank=int(rank), nprocs=int(nprocs))
    return _CTX


def enabled() -> bool:
    """True when the file transport should carry exchanges (a shuffle
    dir is armed)."""
    return shuffle_dir() is not None


def _reset_for_tests() -> None:
    global _CTX
    _CTX = None


def _deadline_s(timeout: Optional[float]) -> float:
    if timeout is not None:
        return float(timeout)
    from ..resilience.fleet import dispatch_deadline_s

    d = dispatch_deadline_s()
    return d if d and d > 0 else 120.0


# ---------------------------------------------------------------------------
# framed payload files
# ---------------------------------------------------------------------------

def _publish(path: str, payload: bytes) -> None:
    """Atomic CRC-framed write: temp → fsync → rename (the compile
    store's publish discipline — a reader can never observe a torn
    live file)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


_READ_RETRY = RetryPolicy(max_attempts=3, backoff=0.05, backoff_max=0.5)


def _read_framed(path: str, describe: str) -> bytes:
    """Read + verify one framed payload, retrying transient defects
    (the file is renamed in whole, but NFS-style caches can serve short
    reads); a persistent CRC failure quarantines the file and raises."""

    def attempt() -> bytes:
        fault_point("shuffle.exchange")
        with open(path, "rb") as f:
            hdr = f.read(_HDR.size)
            if len(hdr) != _HDR.size:
                raise OSError(f"short header in {path}")
            n, crc = _HDR.unpack(hdr)
            # validate the framed length against the file BEFORE
            # allocating: a corrupt header must raise (→ retry →
            # quarantine), not drive f.read into a petabyte MemoryError
            size = os.fstat(f.fileno()).st_size
            if n != size - _HDR.size:
                raise OSError(
                    f"framed length {n} != file payload "
                    f"{size - _HDR.size} in {path}"
                )
            payload = f.read(n)
        if len(payload) != n:
            raise OSError(f"payload length mismatch in {path}")
        if zlib.crc32(payload) != crc:
            raise OSError(f"payload CRC mismatch in {path}")
        return payload

    from ..resilience.retry import RetryError

    try:
        return retry_call(attempt, policy=_READ_RETRY, describe=describe)
    except (OSError, RetryError) as err:
        aside = f"{path}.quarantine.{os.getpid()}"
        try:
            os.replace(path, aside)
        except OSError:  # pragma: no cover - raced/remote
            pass
        _flight.record(
            "shuffle.quarantine", file=os.path.basename(path),
            error=type(err).__name__, message=str(err)[:200],
        )
        from .store import QUARANTINES

        QUARANTINES.inc()
        raise ShuffleCorruptionError(
            f"shuffle payload {path} failed verification after "
            f"{_READ_RETRY.max_attempts} attempts: {err}"
        ) from err


def _await_files(
    round_dir: str,
    want: Dict[int, str],
    deadline_s: float,
    what: str,
) -> None:
    """Block until every ``{rank: filename}`` exists, polling with a
    hard deadline. Expiry dumps a ``shuffle.hang`` postmortem and
    raises HungDispatchError NAMING the missing ranks — a SIGKILLed
    peer becomes a bounded, diagnosable abort instead of a wedged
    exchange (the watchdog contract)."""
    t0 = time.monotonic()
    pending = dict(want)
    while pending:
        for rank, fn in list(pending.items()):
            if os.path.exists(os.path.join(round_dir, fn)):
                del pending[rank]
        if not pending:
            return
        if time.monotonic() - t0 > deadline_s:
            from ..resilience.fleet import HungDispatchError

            missing = sorted(pending)
            _flight.record(
                "shuffle.hang", what=what, missing_ranks=missing,
                waited_s=round(time.monotonic() - t0, 3),
                round_dir=round_dir,
            )
            _flight.dump(reason=f"shuffle.hang:{what}")
            raise HungDispatchError(
                f"shuffle {what}: no data from rank(s) {missing} after "
                f"{deadline_s:.1f}s (dead or wedged peer; round dir "
                f"{round_dir})"
            )
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# collective exchanges
# ---------------------------------------------------------------------------

def _round_dir(ctx: ShuffleContext, name: str) -> str:
    d = os.path.join(ctx.root, f"round-{ctx.rounds:06d}-{name}")
    os.makedirs(d, exist_ok=True)
    return d


def _finish_round(ctx: ShuffleContext, round_dir: str) -> None:
    """Mark this rank done reading and best-effort GC old rounds (only
    rounds every rank has marked fully read — a slow peer still reading
    must never lose its files)."""
    _publish(os.path.join(round_dir, f"read-{ctx.rank:05d}.done"), b"")
    ctx.rounds += 1
    if ctx.rank != 0:
        return
    try:
        for entry in os.listdir(ctx.root):
            if not entry.startswith("round-"):
                continue
            n = int(entry.split("-")[1])
            if n >= ctx.rounds - 2:
                continue
            old = os.path.join(ctx.root, entry)
            done = sum(
                os.path.exists(os.path.join(old, f"read-{r:05d}.done"))
                for r in range(ctx.nprocs)
            )
            if done == ctx.nprocs:
                shutil.rmtree(old, ignore_errors=True)
    except (OSError, ValueError):  # pragma: no cover - GC is best-effort
        pass


def exchange(
    payloads: Sequence[bytes],
    name: str = "exchange",
    timeout: Optional[float] = None,
    ctx: Optional[ShuffleContext] = None,
) -> List[bytes]:
    """All-to-all of byte payloads through per-rank spill files:
    ``payloads[dst]`` is sent from this rank to ``dst``; returns
    ``recv[src]`` — the payload each rank addressed to this one. Every
    rank must call in lockstep with the same ``name``."""
    ctx = ctx or context()
    if ctx is None:
        raise RuntimeError(
            "shuffle.exchange: no shuffle directory armed (set "
            "TFTPU_SHUFFLE_DIR, or TFTPU_FLEET_DIR for the rendezvous "
            "default)"
        )
    if len(payloads) != ctx.nprocs:
        raise ValueError(
            f"exchange needs one payload per rank ({ctx.nprocs}), "
            f"got {len(payloads)}"
        )
    t0 = time.perf_counter()
    delay_point("shuffle.exchange")
    fault_point("shuffle.exchange")
    rd = _round_dir(ctx, name)
    for dst, payload in enumerate(payloads):
        if dst == ctx.rank:
            continue  # the self-partition never touches the filesystem
        _publish(
            os.path.join(rd, f"s{ctx.rank:05d}-d{dst:05d}.part"), payload
        )
        SHUFFLE_BYTES.inc(len(payload))
    # the done marker publishes AFTER every part file: a reader that
    # sees it can trust all of this rank's parts are live
    _publish(os.path.join(rd, f"src-{ctx.rank:05d}.done"), b"")
    try:
        _await_files(
            rd,
            {r: f"src-{r:05d}.done" for r in range(ctx.nprocs)},
            _deadline_s(timeout),
            f"exchange[{name}]",
        )
        recv = [
            payloads[src]
            if src == ctx.rank
            else _read_framed(
                os.path.join(rd, f"s{src:05d}-d{ctx.rank:05d}.part"),
                describe=f"shuffle.read[{name}]",
            )
            for src in range(ctx.nprocs)
        ]
    except BaseException:
        # once OUR done marker is live, peers can complete this round —
        # a deadline expiry or failed read here must still advance the
        # local round counter, else a caller that survives the error
        # would publish into round N while peers are in N+1 and every
        # later exchange dies at the deadline blaming LIVE ranks (the
        # read-done marker stays unpublished, so the round dir is kept
        # for diagnosis)
        ctx.rounds += 1
        raise
    _finish_round(ctx, rd)
    EXCHANGE_SECONDS.observe(time.perf_counter() - t0)
    _flight.record(
        "shuffle.exchange", name=name, rank=ctx.rank, nprocs=ctx.nprocs,
        sent_bytes=[len(p) for p in payloads],
        recv_bytes=[len(b) for b in recv],
    )
    return recv


def allshare(
    payload: bytes,
    name: str = "allshare",
    timeout: Optional[float] = None,
    ctx: Optional[ShuffleContext] = None,
) -> List[bytes]:
    """Allgather of one payload per rank (each rank publishes once,
    reads all) — the final-result share that replaces the collective
    allgather for small replicated tables."""
    ctx = ctx or context()
    if ctx is None:
        raise RuntimeError("shuffle.allshare: no shuffle directory armed")
    t0 = time.perf_counter()
    delay_point("shuffle.exchange")
    fault_point("shuffle.exchange")
    rd = _round_dir(ctx, name)
    _publish(os.path.join(rd, f"all-{ctx.rank:05d}.part"), payload)
    SHUFFLE_BYTES.inc(len(payload))
    try:
        _await_files(
            rd,
            {r: f"all-{r:05d}.part" for r in range(ctx.nprocs)},
            _deadline_s(timeout),
            f"allshare[{name}]",
        )
        out = [
            payload
            if r == ctx.rank
            else _read_framed(
                os.path.join(rd, f"all-{r:05d}.part"),
                describe=f"shuffle.allshare[{name}]",
            )
            for r in range(ctx.nprocs)
        ]
    except BaseException:
        ctx.rounds += 1  # stay in lockstep with peers (see exchange)
        raise
    _finish_round(ctx, rd)
    EXCHANGE_SECONDS.observe(time.perf_counter() - t0)
    return out


def vote_all(ok: bool, name: str = "vote", timeout: Optional[float] = None) -> bool:
    """File-based uniform eligibility vote (the collective-free
    ``uniform_ok``): True only when EVERY rank voted True — all ranks
    take the same branch before any further exchange."""
    flags = allshare(b"\x01" if ok else b"\x00", name=name, timeout=timeout)
    return all(b == b"\x01" for b in flags)


def barrier(name: str = "barrier", timeout: Optional[float] = None) -> None:
    """File-based fleet barrier with the shuffle deadline semantics."""
    allshare(b"", name=name, timeout=timeout)


# ---------------------------------------------------------------------------
# table-level helpers
# ---------------------------------------------------------------------------

def _pack_table(cols: Dict[str, object], sel: Optional[np.ndarray]) -> bytes:
    sub = {}
    for n, v in cols.items():
        if isinstance(v, list):
            a = np.asarray(v, dtype=object)
            sub[n] = list(a[sel]) if sel is not None else list(a)
        else:
            a = np.asarray(v)
            sub[n] = a[sel] if sel is not None else a
    return pickle.dumps(sub, protocol=pickle.HIGHEST_PROTOCOL)


def _concat_tables(tables: List[Dict[str, object]]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    if not tables:
        return out
    for n in tables[0]:
        pieces = [t[n] for t in tables]
        if isinstance(pieces[0], list):
            merged: List[object] = []
            for p in pieces:
                merged.extend(p)
            out[n] = merged
        else:
            out[n] = np.concatenate([np.asarray(p) for p in pieces]) \
                if pieces else pieces
    return out


def shuffle_rows(
    cols: Dict[str, object],
    part: np.ndarray,
    name: str = "rows",
    timeout: Optional[float] = None,
) -> Dict[str, object]:
    """Hash/range-partitioned row exchange through spill files: row i
    of ``cols`` travels to rank ``part[i]``; returns the rows every
    rank sent HERE, in (source rank, local row order) — the same
    deterministic contract as ``ops.exchange.exchange_rows``."""
    ctx = context()
    if ctx is None:
        raise RuntimeError("shuffle.shuffle_rows: no shuffle directory armed")
    part = np.asarray(part)
    payloads = [
        _pack_table(cols, np.flatnonzero(part == dst))
        for dst in range(ctx.nprocs)
    ]
    received = exchange(payloads, name=name, timeout=timeout)
    return _concat_tables([pickle.loads(b) for b in received])


def allshare_table(
    cols: Dict[str, object],
    name: str = "table",
    timeout: Optional[float] = None,
) -> Dict[str, object]:
    """Share one small table per rank with every rank; returns the
    concatenation in rank order (replicated everywhere)."""
    shares = allshare(_pack_table(cols, None), name=name, timeout=timeout)
    return _concat_tables([pickle.loads(b) for b in shares])


# ---------------------------------------------------------------------------
# distributed relational verbs over process-local frames
# ---------------------------------------------------------------------------

def _frame_cols(frame) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for info in frame.schema:
        v = frame.column_values(info.name)
        out[info.name] = list(v) if v.dtype == object else v
    return out


def distributed_aggregate(
    local_frame,
    keys: Sequence[str],
    agg_fn,
    name: str = "agg",
    timeout: Optional[float] = None,
):
    """Shuffled keyed aggregation across a file-shuffle fleet — zero
    host-gathered partial tables.

    Each rank holds ``local_frame`` (its rows of the global frame) and
    an ``agg_fn(frame) -> frame`` building the aggregate through the
    normal verb engine (any fused map/filter chain upstream included).
    Per rank: local partials → hash-partition by group key → spill-file
    exchange → re-apply ``agg_fn`` to the received partials (the UDAF
    merge contract: fetches must be algebraic — sum/min/max/count; a
    mean must be composed from sum+count) → allshare the small finals →
    groups ordered lexicographically (the single-process host path's
    ordering). Every rank returns the identical replicated result."""
    from ..frame import frame_from_arrays
    from ..ops.exchange import partition_by_hash
    from ..ops.keys import group_ids

    ctx = context()
    if ctx is None:
        raise RuntimeError(
            "distributed_aggregate: no shuffle directory armed"
        )
    partial = agg_fn(local_frame)
    pcols = _frame_cols(partial)
    key_arrays = [
        np.asarray(pcols[k], dtype=object)
        if isinstance(pcols[k], list) else np.asarray(pcols[k])
        for k in keys
    ]
    part = partition_by_hash(key_arrays, ctx.nprocs)
    mine = shuffle_rows(pcols, part, name=f"{name}.partials", timeout=timeout)
    n_mine = len(next(iter(mine.values()))) if mine else 0
    if n_mine:
        merged_frame = agg_fn(frame_from_arrays(mine, num_blocks=1))
        merged = _frame_cols(merged_frame)
    else:
        merged = {n: (v[:0] if not isinstance(v, list) else [])
                  for n, v in pcols.items()}
    union = allshare_table(merged, name=f"{name}.finals", timeout=timeout)
    ukeys = [
        np.asarray(union[k], dtype=object)
        if isinstance(union[k], list) else np.asarray(union[k])
        for k in keys
    ]
    if not len(ukeys[0]):
        return frame_from_arrays(union, num_blocks=1)
    # partitions are key-disjoint: exactly one row per group survives;
    # group_ids orders groups lexicographically — the oracle's layout
    ids, _, num_groups = group_ids(ukeys)
    perm = np.empty(num_groups, np.int64)
    perm[ids] = np.arange(len(ids))
    ordered = {
        n: ([v[i] for i in perm] if isinstance(v, list)
            else np.asarray(v)[perm])
        for n, v in union.items()
    }
    return frame_from_arrays(ordered, num_blocks=1)


def distributed_join(
    left_frame,
    right_frame,
    on,
    name: str = "join",
    how: str = "inner",
    timeout: Optional[float] = None,
):
    """Shuffled hash join across a file-shuffle fleet: both sides'
    process-local rows hash-partition on the join key, exchange through
    spill files, and each rank joins only its key partition through the
    normal ``TensorFrame.join``. Returns the replicated union of every
    rank's partition as a ``{column: array|list}`` table in (rank,
    local join order) — canonicalize by sorting when comparing against
    a single-process oracle, whose row order differs."""
    from ..frame import frame_from_arrays

    on = [on] if isinstance(on, str) else list(on)
    if how != "inner":
        # a rank whose opposite-side partition is empty would have to
        # emit fill-extended rows to honor left/right/outer — that
        # needs the fill_value plumbing TensorFrame.join requires for
        # those hows; refusing beats silently dropping the unmatched
        # rows of empty-partition ranks
        raise ValueError(
            f"distributed_join supports how='inner' only (got {how!r}); "
            "outer joins across the shuffle need fill-value plumbing — "
            "run the replicated TensorFrame.join for those"
        )
    ctx = context()
    if ctx is None:
        raise RuntimeError("distributed_join: no shuffle directory armed")
    from ..ops.exchange import partition_by_hash

    sides = {}
    for tag, f in (("L", left_frame), ("R", right_frame)):
        cols = _frame_cols(f)
        key_arrays = [
            np.asarray(cols[k], dtype=object)
            if isinstance(cols[k], list) else np.asarray(cols[k])
            for k in on
        ]
        part = partition_by_hash(key_arrays, ctx.nprocs)
        sides[tag] = shuffle_rows(
            cols, part, name=f"{name}.{tag}", timeout=timeout
        )

    def rows_of(t):
        return len(next(iter(t.values()))) if t else 0

    if rows_of(sides["L"]) and rows_of(sides["R"]):
        local = frame_from_arrays(sides["L"], num_blocks=1).join(
            frame_from_arrays(sides["R"], num_blocks=1), on=on, how=how
        )
        lcols = _frame_cols(local)
    else:
        # a rank can hold keys on only one side — its inner partition
        # is empty; share zero rows under the joined schema (left
        # columns then right non-key columns, dtypes preserved by the
        # shuffled empties so peers' concat stays typed)
        lcols = {}
        for src in (sides["L"], sides["R"]):
            for n, v in src.items():
                if n not in lcols:
                    lcols[n] = (
                        [] if isinstance(v, list) else np.asarray(v)[:0]
                    )
    return allshare_table(lcols, name=f"{name}.union", timeout=timeout)


__all__ = [
    "ShuffleContext", "ShuffleCorruptionError", "context", "enabled",
    "shuffle_dir", "exchange", "allshare", "vote_all", "barrier",
    "shuffle_rows", "allshare_table", "distributed_aggregate",
    "distributed_join",
]
