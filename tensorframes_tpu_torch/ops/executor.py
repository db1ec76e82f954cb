"""Block execution engine: marshalling + per-feed-shape dispatch.

This layer replaces the reference's per-partition worker kernels
(``DebugRowOpsImpl``, impl/DebugRowOps.scala:704-980) and its Row⇄Tensor
marshalling stack (``TFDataOps``/``DataOps``/``datatypes``). A block's
numpy feeds move to the verb's device as torch tensors, the program runs
eagerly there (``torch.func.vmap`` over the rows for ``map_rows``), and
results come back to the host.

PyTorch compiles nothing per shape, but the dispatch bookkeeping keeps the
reference's shape accounting: :class:`CompiledProgram` records every
distinct (entry, feed shapes/dtypes) key it has dispatched, so
``cache_sizes`` drives ``map_rows``' adaptive lead-dim bucketing exactly
as in the reference, and the hit/miss counters keep their names. With
``compilation_cache_dir`` set, a first-seen key is also looked up in the
persistent store (:mod:`..compilecache.store`), or recorded there with a
manifest row that ``warmup`` replays in a later process. Each
dispatch passes the reference's fault sites (``executor.run_block`` /
``executor.run_rows``, and the ``executor.dispatch`` delay site around
the call) and leaves a ``dispatch`` or ``dispatch.error`` flight record.
Row counts still bucket to powers of two (:func:`bucket_rows`), so padded
rows match the reference row for row.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..config import get_config
from ..observability import events as _events
from ..observability import flight as _flight
from ..observability import latency as _latency
from ..observability.metrics import counter as _counter
from ..program import Program
from ..resilience.faults import delay_point, fault_point, register_site
from ..utils import get_logger

logger = get_logger(__name__)

register_site(
    "executor.dispatch",
    "CompiledProgram._run dispatch body, inside the deadline-watchdog "
    "scope — an injected Delay simulates a hung collective (the "
    "dispatch stalls instead of failing) so the watchdog is drillable",
)

_JIT_HITS = _counter(
    "tftpu_executor_jit_cache_hits_total",
    "Dispatches whose feed-shape key was already dispatched",
)
_JIT_MISSES = _counter(
    "tftpu_executor_jit_cache_misses_total",
    "Dispatches at a feed-shape key seen for the first time",
)
_PADDING_WASTE = _counter(
    "tftpu_executor_padding_waste_rows_total",
    "Rows added by bucket padding of the vmapped lead dim",
)
_GATHER_BYTES = _counter(
    "tftpu_executor_gather_bytes_total",
    "Bytes of feed columns gathered for program dispatch",
)


def bucket_rows(n: int) -> int:
    """Round a row count up to the next power-of-two bucket:
    ``min_bucket * 2**k`` for the smallest k that fits, bounded by
    ``max_bucket_doublings`` (config). Beyond the largest bucket the
    exact count is returned — an honest exact shape instead of
    unbounded padding.

    Padding the *vmapped lead dim* keeps the per-shape cache O(log n)
    over arbitrary block sizes. Only row-independent (map_rows)
    semantics may use it — padded rows are sliced off after execution.
    """
    cfg = get_config()
    b = max(1, int(cfg.min_bucket))
    if n <= b:
        return b
    for _ in range(max(0, int(cfg.max_bucket_doublings))):
        b *= 2
        if b >= n:
            return b
    return n


def bucket_table() -> List[int]:
    """The lead-dim bucket ladder :func:`bucket_rows` rounds into under
    the current config: ``[min_bucket, min_bucket*2, …]``, one entry per
    allowed doubling."""
    cfg = get_config()
    b = max(1, int(cfg.min_bucket))
    out = [b]
    for _ in range(max(0, int(cfg.max_bucket_doublings))):
        b *= 2
        out.append(b)
    return out


def pad_lead_dim(
    feeds: Dict[str, np.ndarray], n: int, target: int
) -> Dict[str, np.ndarray]:
    """Pad every feed's leading dim from ``n`` to ``target`` rows by
    replicating the last row (replication keeps padded rows numerically
    tame — no 0-divides or log(0) from zero fill; results are sliced back
    to ``n`` rows by the caller)."""
    if target == n:
        return feeds
    _PADDING_WASTE.inc(target - n)
    out = {}
    for k, v in feeds.items():
        v = np.asarray(v)
        pad = np.broadcast_to(v[-1:], (target - n,) + v.shape[1:])
        out[k] = np.concatenate([v, pad])
    return out


class CompiledProgram:
    """A Program plus its dispatch entrypoints (block and per-row)."""

    def __init__(self, program: Program):
        self.program = program
        # vmapped form: maps the program over the leading axis of every
        # input — the replacement for the reference's row loop
        # (performMapRows, DebugRowOps.scala:826-864).
        self._vmapped = torch.func.vmap(program.fn)
        # feed-shape keys already dispatched, per entry kind
        self._dispatched: set = set()

    @staticmethod
    def _feeds_key(kind: str, feeds) -> Tuple:
        return (kind,) + tuple(
            sorted(
                (k, tuple(int(d) for d in v.shape), str(v.dtype))
                for k, v in feeds.items()
            )
        )

    def _note_dispatch(self, key: Tuple, device=None) -> None:
        if key in self._dispatched:
            _JIT_HITS.inc()
        else:
            self._dispatched.add(key)
            _JIT_MISSES.inc()
            self._consult_store(key, device)

    def _consult_store(self, key: Tuple, device) -> Optional[str]:
        """Look a first-seen dispatch key up in the persistent store
        (``<compilation_cache_dir>/aot``, :mod:`..compilecache.store`):
        ``"disk"`` when a process recorded it before, ``"compiled"`` when
        it is recorded now (its feed shapes also go to the store's
        manifest, which ``warmup(manifest=True)`` replays); None with no
        store or when the program cannot be fingerprinted. A store
        problem is counted and never fails the dispatch."""
        from ..compilecache import store as cc_store
        from ..compilecache.fingerprint import dispatch_fingerprint

        store = cc_store.active_store()
        if store is None:
            return None
        kind = key[0]
        inputs = [(n, list(s), d.replace("torch.", "")) for (n, s, d) in key[1:]]
        try:
            res = dispatch_fingerprint(self.program, kind, inputs, device)
        except Exception as e:
            logger.debug("dispatch fingerprint failed: %s", e)
            res = None
        if res is None:
            cc_store.note_unfingerprintable()
            return None
        fp, comps, env = res
        if store.get(fp) is not None:
            return "disk"
        store.record_miss(kind, inputs)
        store.put(fp, {"inputs": inputs, "components": comps,
                       "outputs": list(self.program.fetch_order), **env})
        return "compiled"

    def warm(self, kind: str, feeds: Dict[str, object], device) -> str:
        """Dispatch the program once at one feed-shape key, on
        zero-filled feeds on ``device`` (``feeds`` maps input names to
        anything with ``shape`` and ``dtype``, e.g. meta tensors), and
        mark the key dispatched without counting it, so the first real
        dispatch at that shape is a hit. What it pays for ahead of the
        traffic: the kernel library's load, the cuBLAS/cuDNN handles and
        the allocator's growth. Returns
        ``"cached"`` (key already dispatched in this process), ``"disk"``
        (the persistent store had recorded it), ``"compiled"`` (new) or
        ``"failed"``."""
        device = torch.device(device)
        tensors = {
            n: torch.zeros(tuple(int(d) for d in v.shape), dtype=v.dtype, device=device)
            for n, v in feeds.items()
        }
        key = self._feeds_key(kind, tensors)
        if key in self._dispatched:
            return "cached"
        fn = self.program.fn if kind == "block" else self._vmapped
        try:
            with torch.inference_mode():
                fn(tensors)
        except Exception as e:
            logger.warning("warmup dispatch at %s failed: %s", key, e)
            return "failed"
        self._dispatched.add(key)
        return self._consult_store(key, device) or "compiled"

    def _run(self, kind: str, fn: Callable, feeds, device, to_numpy: bool):
        site = f"executor.run_{'block' if kind == 'block' else 'rows'}"
        # the flight record's identity of this dispatch, taken before
        # anything can fail: a postmortem must name the dispatch in flight
        summary = {
            "entry": kind,
            "outputs": ",".join(self.program.fetch_order[:6]),
            "shapes": {k: list(v.shape) if hasattr(v, "shape") else [len(v)]
                       for k, v in list(feeds.items())[:6]},
        }
        try:
            fault_point(site)
            device = torch.device(device)
            # host arrays are copied to the device; tensors already there
            # (a prefetched block, a device-side gather) are used as they are
            tensors = {
                k: (v if v.device == device else v.to(device)) if torch.is_tensor(v)
                else dt.to_torch(v, device)
                for k, v in feeds.items()
            }
            key = self._feeds_key(kind, tensors)
            fresh = key not in self._dispatched
            self._note_dispatch(key, device)
            t0 = time.perf_counter()
            delay_point("executor.dispatch")
            with torch.inference_mode():
                out = fn(tensors)
            wall = time.perf_counter() - t0
        except BaseException as e:
            _flight.record("dispatch.error", error=type(e).__name__, message=str(e), **summary)
            raise
        # host time of the dispatch (the device runs on asynchronously)
        _latency.dispatch_histogram(kind).observe(wall)
        _flight.record("dispatch", seconds=round(wall, 6), compiled=fresh, **summary)
        if _events.TRACER.enabled:
            _events.TRACER.emit_complete(site, t0, wall, args={"compiled": fresh},
                                         cat="executor")
        if not to_numpy:
            return out
        return {k: dt.to_numpy(v) for k, v in out.items()}

    def run_block(self, feeds: Dict[str, np.ndarray], device,
                  to_numpy: bool = True) -> Dict[str, np.ndarray]:
        """One block through the program. ``to_numpy=False`` returns the
        outputs as tensors on ``device`` without waiting for the device
        (hand them to :class:`Readback`)."""
        return self._run("block", self.program.fn, feeds, device, to_numpy)

    def run_rows(self, feeds: Dict[str, np.ndarray], device,
                 to_numpy: bool = True) -> Dict[str, np.ndarray]:
        """The program vmapped over the feeds' lead dim; ``to_numpy`` as
        in :meth:`run_block`."""
        return self._run("vmap", self._vmapped, feeds, device, to_numpy)

    def run_rows_bucketed(self, feeds: Dict[str, np.ndarray], device,
                          to_numpy: bool = True) -> Dict[str, np.ndarray]:
        """The serving layer's coalesced dispatch: pad the shared lead dim
        up the power-of-two ladder (:func:`bucket_rows`, the ladder the
        server warms), run the vmapped program on ``device``, slice back
        to the true row count. Unlike ``map_rows``' adaptive bucketing
        this always buckets, so a server warmed over the ladder dispatches
        any admissible row count at a key it has seen — and a row's result
        does not depend on how it was coalesced (vmap is row-independent;
        padding replicates the last row and is sliced off here)."""
        sizes = {k: int(np.shape(v)[0]) for k, v in feeds.items()}
        ns = set(sizes.values())
        if len(ns) != 1:
            raise ValueError(f"run_rows_bucketed: feeds disagree on the lead dim: {sizes}")
        n = ns.pop()
        if n == 0:
            raise ValueError("run_rows_bucketed: zero-row dispatch")
        feeds = pad_lead_dim(feeds, n, bucket_rows(n))
        outs = self._run("vmap", self._vmapped, feeds, device, to_numpy=False)
        outs = {k: v[:n] for k, v in outs.items()}
        if not to_numpy:
            return outs
        return {k: dt.to_numpy(v) for k, v in outs.items()}

    def cache_sizes(self) -> Dict[str, int]:
        """How many distinct feed shapes each entrypoint has dispatched
        (the reference's recompile accounting, SURVEY §7 hard-part 1).
        Ragged map_rows grows the vmap count by one per distinct
        (cell shape, lead-dim bucket) group."""
        return {
            kind: sum(1 for k in self._dispatched if k[0] == kind)
            for kind in ("block", "vmap")
        }


class Readback:
    """``to_numpy=False`` outputs on their way to the host. A CUDA tensor
    is copied on a side stream of its device (one of PyTorch's pool) into
    pinned host memory (``non_blocking``) once the compute stream has
    produced it, and an event marks the copies' end, so :meth:`wait`
    waits on that event alone, not on the whole device, and returns
    numpy arrays. Host tensors are kept as they are."""

    def __init__(self, outs: Dict[str, torch.Tensor]):
        self._events = []
        self._order = list(outs)
        self._host = {k: v for k, v in outs.items() if v.device.type != "cuda"}
        for device in {v.device for v in outs.values() if v.device.type == "cuda"}:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for k, v in outs.items():
                    if v.device != device:
                        continue
                    # the allocator must not hand v's memory to the compute
                    # stream before the side stream has read it
                    v.record_stream(side)
                    self._host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    self._host[k].copy_(v, non_blocking=True)
                event = torch.cuda.Event()
                event.record(side)
            self._events.append(event)

    def wait(self) -> Dict[str, np.ndarray]:
        for event in self._events:
            event.synchronize()
        return {k: dt.to_numpy(self._host[k]) for k in self._order}


def gather_feeds(
    block: Dict[str, object],
    input_names: Sequence[str],
    program: Program,
) -> Dict[str, np.ndarray]:
    """Materialize the program's input columns from a block as dense arrays.

    Ragged (list-stored) columns raise here with the analyze hint — the
    reference's equivalent failure happens in ``TFDataOps.convert``'s
    lead-dim check (TFDataOps.scala:28-59).
    """
    feeds = {}
    for name in input_names:
        v = block[name]
        if isinstance(v, list):
            spec = program.input(name)
            try:
                v = np.asarray(v, dtype=spec.dtype.np_dtype)
            except (ValueError, TypeError):
                raise ValueError(
                    f"Column {name!r} holds ragged cells and cannot form a "
                    "dense block. Use map_rows for ragged data, or run "
                    "analyze()/append_shape() if the cells are uniform."
                ) from None
        feeds[name] = v
        nbytes = getattr(v, "nbytes", 0)
        if nbytes:
            _GATHER_BYTES.inc(int(nbytes))
    return feeds


def block_is_ragged(block: Dict[str, object], input_names: Sequence[str]) -> bool:
    for name in input_names:
        v = block[name]
        if isinstance(v, list):
            shapes = set()
            for c in v:
                shapes.add(np.shape(c))
                if len(shapes) > 1:
                    return True
    return False


# ---------------------------------------------------------------------------
# reduce_rows folds (sequential pairwise, ≙ performReducePairwise,
# DebugRowOps.scala:939-979)
# ---------------------------------------------------------------------------

def make_pair_fold(program: Program, out_names: Sequence[str]) -> Callable:
    """The pairwise fold over the leading axis of per-output tensors:
    dict x -> [n, ...cell] (n >= 1) → dict x -> cell. Rows fold in order,
    carry first: ``carry = f(carry, row)`` — the reference's scan."""

    def fold(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        carry = {x: cols[x][0] for x in out_names}
        n = int(cols[out_names[0]].shape[0])
        with torch.inference_mode():
            for i in range(1, n):
                feeds = {}
                for x in out_names:
                    feeds[f"{x}_1"] = carry[x]
                    feeds[f"{x}_2"] = cols[x][i]
                out = program.fn(feeds)
                carry = {x: out[x] for x in out_names}
        return carry

    return fold
