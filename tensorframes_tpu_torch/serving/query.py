"""Registered relational query endpoints.

The reference package's ``serving/query.py``.
``Server.register_query(name, source, build)`` turns a lazy relational
pipeline into a served product: ``build`` takes the source frame and
returns a lazy verb chain (map → join → aggregate), and every
``submit(name, {})`` answers with the pipeline's current result table
over the source's CURRENT contents — a growing ``scan_csv``/
``scan_parquet`` directory or a static frame. The chain runs where its
verbs run (``config.device``, the card by default; a build passes
``device="cpu"`` to its verbs to run on the CPU).

Three layers keep a recurring dashboard-style query O(new data) instead
of O(table):

* **Result cache** — keyed by (plan fingerprint, input-partition content
  digest): :func:`plan.stats.chain_fingerprint` names what computes,
  :func:`compilecache.fingerprint.content_digest` over the chunk-arrival
  manifest names what it computes over. A repeat query is a memo or
  store lookup: no chunk read, no plan execution, no dispatch. The
  persistent half lives in a :class:`blockstore.ResultStore` under
  ``<TFTPU_COMPILE_CACHE>/results``, so a restarted process hits too.
* **Incremental aggregate maintenance** — when the chain is a scan-rooted
  map/filter pipeline ending in an algebraic aggregate whose every (op,
  dtype) passes :func:`plan.rules.incremental_fold_safe` and whose group
  keys pass through from the source, the endpoint keeps one aggregate
  partial table per chunk (keyed by the chunk's stat signature) and
  answers by folding them (:func:`plan.lower.fold_partial_tables`,
  bit-identical to full recompute by exact associativity). An appended
  part re-reads and re-executes only itself; a rewritten part
  invalidates only its own partial.
* **Counted degradation** — anything outside that contract (host
  callbacks, non-algebraic fetches, joins, computed keys, float sums,
  means, eager build functions) degrades to counted full recompute with a named
  reason: the ``tftpu_result_cache_recomputes_total{reason=}`` series,
  an evidence row in :func:`query_cache_events`, and ``Server.stats()``
  rows. Degraded endpoints still answer correctly; they pay O(table).

Result rows come in :func:`plan.lower.canonical_table_order` (sorted by
group keys), so a folded refresh, a full recompute and a
``TFTPU_FUSION=0`` oracle run compare byte for byte. Under
``TFTPU_FUSION=0`` the plan chain never records (the verbs run eagerly:
that is the oracle mode), so persistent caching and incremental
maintenance disarm without evidence rows and only the in-process memo
serves repeats.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..observability import flight as _flight
from ..observability.metrics import Histogram
from ..observability.latency import LATENCY_BUCKETS
from ..utils import get_logger
from ..validation import ValidationError
from .batcher import RejectedError, ResultFuture
from . import metrics as m

logger = get_logger(__name__)

__all__ = [
    "QuerySource", "QueryEndpoint", "query_cache_events",
    "QUERY_DECLINE_REASONS",
]

#: Closed set of decline reasons (the reference's TFG114 taxonomy; its
#: analysis/rules.py maps each to an actionable fix).
QUERY_DECLINE_REASONS: Tuple[str, ...] = (
    "host_callback", "non_algebraic", "eager", "join", "computed_key",
    "reduce_mean", "float_accumulation", "no_terminal_aggregate",
)


@dataclasses.dataclass(frozen=True)
class QuerySource:
    """Where a registered query reads from.

    ``path`` + ``kind`` ('csv' | 'parquet') names a growing directory
    (or explicit part list) scanned per request through
    :func:`io.part_manifest`; ``frame`` registers a static in-memory
    frame instead (content-digested via
    :func:`compilecache.fingerprint.frame_content_digest`). CSV column
    types are pinned from the first part with rows (pass ``dtypes`` to
    pin them yourself — the scan_csv contract)."""

    path: Optional[str] = None
    kind: str = "csv"
    frame: Optional[object] = None
    delimiter: str = ","
    dtypes: Optional[Dict[str, str]] = None

    def __post_init__(self):
        if self.frame is not None:
            if self.path is not None:
                raise ValueError(
                    "QuerySource takes path OR frame, not both"
                )
            return
        if self.path is None:
            raise ValueError("QuerySource needs a path or a frame")
        if self.kind not in ("csv", "parquet"):
            raise ValueError(
                f"QuerySource kind must be 'csv' or 'parquet', "
                f"got {self.kind!r}"
            )


# ---------------------------------------------------------------------------
# Decline evidence: registered endpoints whose plan declined caching or
# incremental maintenance, with the blocking stage named. Module-level
# like decode.prefix_cache_events; registration appends, deduped per
# (endpoint, mode, reason); a rolled-back endpoint withdraws its rows so
# stale evidence never outlives the endpoint.
# ---------------------------------------------------------------------------

_QUERY_EVENTS: List[dict] = []
_QUERY_SEEN: set = set()
_EVENTS_LOCK = threading.Lock()


def query_cache_events() -> List[dict]:
    """Decline evidence rows: ``{"endpoint", "mode", "reason",
    "detail"}`` — mode 'cache' means the result cache disarmed (every
    request recomputes), mode 'incremental' means refreshes pay full
    recompute while repeats still cache."""
    with _EVENTS_LOCK:
        return [dict(e) for e in _QUERY_EVENTS]


def _record_event(endpoint: str, mode: str, reason: str,
                  detail: str) -> None:
    assert reason in QUERY_DECLINE_REASONS, reason
    key = (endpoint, mode, reason)
    with _EVENTS_LOCK:
        if key in _QUERY_SEEN:
            return
        _QUERY_SEEN.add(key)
        _QUERY_EVENTS.append({
            "endpoint": endpoint, "mode": mode, "reason": reason,
            "detail": detail,
        })


def _withdraw_events(endpoint: str) -> None:
    with _EVENTS_LOCK:
        _QUERY_EVENTS[:] = [
            e for e in _QUERY_EVENTS if e["endpoint"] != endpoint
        ]
        _QUERY_SEEN.difference_update(
            {k for k in _QUERY_SEEN if k[0] == endpoint}
        )


def _result_key(fp: str, digest: str) -> str:
    return f"{fp}-r{digest}"


def _partial_key(fp: str, sig: str) -> str:
    return f"{fp}-p{sig}"


class QueryEndpoint:
    """One registered relational pipeline, served.

    Requests carry NO feeds (``{}``/None — the query's input is the
    source's current contents); execution runs synchronously under the
    endpoint lock in the submitting thread, so a cache hit's latency
    IS the lookup. Exposes the batcher-compatible ``counters()`` shape
    so ``Server.stats()`` tallies it like any endpoint, plus
    ``cache_stats()`` for the result-cache rows."""

    def __init__(self, name: str, source: QuerySource,
                 build: Callable[[object], object]):
        self.name = name
        self.source = source
        self.build = build
        self._lock = threading.RLock()
        self._open = False
        # batcher-compatible admission counters (per-endpoint, stats())
        self._admitted_requests = 0
        self._admitted_rows = 0
        self._rejected = {r: 0 for r in m.REJECT_REASONS}
        self._latency = Histogram(
            "serving_endpoint_latency_seconds",
            f"request latency for query endpoint {name!r}",
            (), threading.Lock(), buckets=LATENCY_BUCKETS,
        )
        # result-cache counters (per-endpoint mirrors of the
        # process-wide tftpu_result_cache_* registry series)
        self._hits = 0
        self._misses = 0
        self._invalidations = 0
        self._bytes = 0
        self._chunks_folded = 0
        self._chunks_executed = 0
        self._recomputes = {r: 0 for r in m.RECOMPUTE_REASONS}
        # cache state
        self._memo_digest: Optional[str] = None
        self._memo_table: Optional[Dict[str, np.ndarray]] = None
        self._last_manifest: Optional[List[Tuple[str, str]]] = None
        self._mem_partials: Dict[str, Dict[str, np.ndarray]] = {}
        self._store = None
        self._store_root: Optional[str] = None
        # plan probe state (filled by _probe)
        self._fp: Optional[str] = None
        self._cache_reason: Optional[Tuple[str, str]] = None
        self._inc_reason: Optional[Tuple[str, str]] = None
        self._agg_keys: Tuple[str, ...] = ()
        self._agg_ops: Tuple[Tuple[str, str], ...] = ()
        self._result_schema = None
        self._csv_dtypes: Optional[Dict[str, str]] = dict(
            source.dtypes) if source.dtypes else None
        self._probe()

    # -- source scanning ----------------------------------------------------

    def _manifest(self) -> List[Tuple[str, str]]:
        """Current chunk-arrival manifest: ``[(path, signature)]``."""
        if self.source.frame is not None:
            from ..compilecache.fingerprint import frame_content_digest

            return [("<frame>", frame_content_digest(self.source.frame))]
        from ..io import part_manifest

        return part_manifest(self.source.path, kind=self.source.kind)

    def _chunk_frame(self, path: str):
        if self.source.frame is not None:
            return self.source.frame
        from ..io import part_frame

        return part_frame(
            path, kind=self.source.kind,
            delimiter=self.source.delimiter, dtypes=self._csv_dtypes,
        )

    # -- plan probe ---------------------------------------------------------

    def _probe(self) -> None:
        """Fingerprint the pipeline and walk its eligibility ONCE, over
        the first chunk with rows: the chain signature is content-based
        (schema + node specs), so one chunk stands for the table."""
        manifest = self._manifest()
        probe = None
        for path, _ in manifest:
            f = self._chunk_frame(path)
            if f.num_rows > 0:
                probe = f
                break
        if probe is None:
            raise ValueError(
                f"query endpoint {self.name!r}: no part with rows under "
                f"{self.source.path!r} — register after the first data "
                "arrives (the probe pins CSV dtypes from it)"
            )
        if self.source.kind == "csv" and self._csv_dtypes is None:
            # pin types from the probe part, exactly like scan_csv: two
            # chunks of one table must never parse under different types
            self._csv_dtypes = {
                info.name: (info.dtype.name
                            if info.dtype.name in ("int64", "float64")
                            else "string")
                for info in probe.schema
            }
        result = self.build(probe)
        if result is None or not hasattr(result, "schema"):
            raise ValueError(
                f"query endpoint {self.name!r}: build must return a "
                f"frame, got {type(result).__name__}"
            )
        self._result_schema = result.schema
        self._inspect(result, probe)
        from ..plan import ir as plan_ir

        for mode, why in (("cache", self._cache_reason),
                          ("incremental", self._inc_reason)):
            # fusion-off is the operator-chosen oracle mode, not a
            # fixable plan property: no evidence row for it
            if why is not None and plan_ir.fusion_enabled():
                _record_event(self.name, mode, why[0], why[1])
        _flight.record(
            "serving.query_registered", endpoint=self.name,
            fp=self._fp, chunks=len(manifest),
            cache=self._cache_reason is None,
            incremental=self._inc_reason is None,
        )

    def _inspect(self, result, probe) -> None:
        from ..plan import ir as plan_ir
        from ..plan import stats as plan_stats
        from ..plan.rules import incremental_fold_safe

        node = getattr(result, "_plan", None)
        if node is None:
            unf = plan_ir.unfused_epilogues(result)
            if unf:
                why = ("non_algebraic",
                       f"aggregate epilogue stayed unfused: "
                       f"{unf[0].get('reason', 'non-algebraic fetches')}")
            else:
                why = ("eager",
                       "build returned a frame with no recorded plan "
                       "chain (already forced, or planning disabled)")
            self._cache_reason = self._inc_reason = why
            return
        src, nodes = plan_ir.resolve_chain(node)
        self._fp = plan_stats.chain_fingerprint(src, nodes)
        for n in nodes:
            if n.kind == "map" and plan_ir.program_has_callback(n.program):
                outs = ",".join(n.out_names)
                self._cache_reason = self._inc_reason = (
                    "host_callback",
                    f"map stage producing [{outs}] runs a host "
                    "callback — results are not a pure function of the "
                    "plan fingerprint, so neither cache level is sound",
                )
                return
        term = nodes[-1]
        if term.kind != "aggregate":
            self._inc_reason = (
                "no_terminal_aggregate",
                f"chain ends in {term.kind!r}, not a keyed algebraic "
                "aggregate — only aggregate partials fold across chunks",
            )
            return
        self._agg_keys = tuple(term.keys)
        self._agg_ops = tuple((o, op) for o, op, _ in (term.spec or ()))
        self._result_schema = term.schema
        joins = [n for n in nodes if n.kind == "join"]
        if joins:
            self._inc_reason = (
                "join",
                "the chain joins against another frame — per-chunk "
                "partials of a join-then-aggregate are not maintained "
                "(build-side changes would silently stale them)",
            )
            return
        map_outs = {o for n in nodes if n.kind == "map"
                    for o in n.out_names}
        computed = sorted(k for k in term.keys if k in map_outs)
        if computed:
            self._inc_reason = (
                "computed_key",
                f"group key(s) {computed} are computed by a map stage, "
                "not passed through from the scan — a chunk's key set "
                "is then not a pure function of the chunk",
            )
            return
        for o, op in self._agg_ops:
            dtype = term.schema[o].dtype.np_dtype
            if op == "reduce_mean":
                self._inc_reason = (
                    "reduce_mean",
                    f"fetch {o!r} is a mean — partials fold only as a "
                    "(sum, count) companion pair, which partial tables "
                    "do not carry yet; aggregate sum and count instead",
                )
                return
            if not incremental_fold_safe(op, dtype):
                self._inc_reason = (
                    "float_accumulation",
                    f"fetch {o!r} ({op} over "
                    f"{np.dtype(dtype).name}) reassociates across "
                    "chunks — the fold would not be bit-identical to "
                    "full recompute; cast to an integer dtype or accept "
                    "full recompute",
                )
                return

    # -- persistent store ---------------------------------------------------

    def _result_store(self):
        """The persistent store, armed only when caching is eligible
        AND ``compilation_cache_dir`` is configured (the same opt-in that
        arms the plan-stats sidecar)."""
        if self._cache_reason is not None or self._fp is None:
            return None
        from ..config import get_config

        root = get_config().compilation_cache_dir
        if not root:
            return None
        root = os.path.join(root, "results")
        if self._store is None or self._store_root != root:
            from ..blockstore.resultstore import ResultStore

            self._store = ResultStore(root)
            self._store_root = root
        return self._store

    # -- execution ----------------------------------------------------------

    def _table_of(self, frame) -> Dict[str, np.ndarray]:
        return {
            name: frame.column_values(name)
            for name in frame.schema.names
        }

    def _empty_table(self) -> Dict[str, np.ndarray]:
        out = {}
        for info in self._result_schema:
            np_dtype = info.dtype.np_dtype
            out[info.name] = np.zeros(
                (0,),
                dtype=(object if np.dtype(np_dtype) == object
                       else np_dtype),
            )
        return out

    def _run_chunk(self, path: str) -> Dict[str, np.ndarray]:
        frame = self._chunk_frame(path)
        if frame.num_rows == 0:
            return self._empty_table()
        return self._table_of(self.build(frame))

    def _execute_full(self, manifest) -> Dict[str, np.ndarray]:
        """Full recompute: every chunk read, one pipeline execution
        over the concatenated table (the oracle path)."""
        from ..frame import frame_from_arrays

        frames = [self._chunk_frame(p) for p, _ in manifest]
        frames = [f for f in frames if f.num_rows > 0]
        if not frames:
            return self._empty_table()
        if len(frames) == 1:
            full = frames[0]
        else:
            cols: Dict[str, object] = {}
            for info in frames[0].schema:
                parts = [f.column_values(info.name) for f in frames]
                if any(p.dtype == object for p in parts):
                    merged: List[object] = []
                    for p in parts:
                        merged.extend(p.tolist())
                    cols[info.name] = merged
                else:
                    cols[info.name] = np.concatenate(parts)
            full = frame_from_arrays(cols, num_blocks=1)
        return self._table_of(self.build(full))

    def _execute_incremental(
        self, manifest, store, invalidated: bool,
    ) -> Dict[str, np.ndarray]:
        """Fold per-chunk partials, reading/executing only chunks whose
        partial is not cached (new, invalidated, or corrupt)."""
        from ..plan.lower import fold_partial_tables

        partials: List[Dict[str, np.ndarray]] = []
        folded = executed = 0
        live_sigs = set()
        for path, sig in manifest:
            live_sigs.add(sig)
            table = self._mem_partials.get(sig)
            if table is None and store is not None:
                table, corrupt = store.load(_partial_key(self._fp, sig))
                if corrupt:
                    m.result_recompute("corrupt_partial").inc()
                    self._recomputes["corrupt_partial"] += 1
                    _flight.record(
                        "serving.query_partial_corrupt",
                        endpoint=self.name, chunk=os.path.basename(path),
                    )
            if table is None:
                table = self._run_chunk(path)
                executed += 1
                if store is not None:
                    n = store.put(_partial_key(self._fp, sig), table)
                    m.RESULT_CACHE_BYTES.inc(n)
                    self._bytes += n
            else:
                folded += 1
            self._mem_partials[sig] = table
            partials.append(table)
        # drop partials of departed chunks from the in-memory mirror
        # (the on-disk store is content-keyed; stale entries just idle)
        for sig in list(self._mem_partials):
            if sig not in live_sigs:
                del self._mem_partials[sig]
        m.RESULT_CACHE_CHUNKS_FOLDED.inc(folded)
        self._chunks_folded += folded
        self._chunks_executed += executed
        if executed:
            reason = "invalidated" if invalidated else "cold"
            m.result_recompute(reason).inc()
            self._recomputes[reason] += 1
        return fold_partial_tables(
            partials, self._agg_keys, self._agg_ops,
            self._result_schema,
        )

    def execute(self) -> Dict[str, np.ndarray]:
        """One request's answer over the source's current contents —
        memo hit, store hit, incremental fold, or counted full
        recompute, in that order."""
        from ..plan.lower import canonical_table_order
        from ..compilecache.fingerprint import content_digest

        with self._lock:
            manifest = self._manifest()
            digest = content_digest(sig for _, sig in manifest)
            if digest == self._memo_digest:
                m.RESULT_CACHE_HITS.inc()
                self._hits += 1
                return self._memo_table
            prev = self._last_manifest
            if prev is not None:
                m.RESULT_CACHE_INVALIDATIONS.inc()
                self._invalidations += 1
                _flight.record(
                    "serving.query_invalidated", endpoint=self.name,
                    chunks=len(manifest), prev_chunks=len(prev),
                )
            # append-only ⇔ every previously-seen (path, sig) survives
            invalidated = prev is not None and not (
                {(p, s) for p, s in prev}
                <= {(p, s) for p, s in manifest}
            )
            store = self._result_store()
            if store is not None:
                table, _corrupt = store.load(
                    _result_key(self._fp, digest)
                )
                if table is not None:
                    m.RESULT_CACHE_HITS.inc()
                    self._hits += 1
                    self._memo_digest, self._memo_table = digest, table
                    self._last_manifest = manifest
                    return table
            m.RESULT_CACHE_MISSES.inc()
            self._misses += 1
            if self._inc_reason is None and self.source.frame is None:
                table = self._execute_incremental(
                    manifest, store, invalidated
                )
            else:
                reason = ("ineligible" if self._inc_reason is not None
                          else ("invalidated" if invalidated else "cold"))
                m.result_recompute(reason).inc()
                self._recomputes[reason] += 1
                table = self._execute_full(manifest)
                if self._agg_keys:
                    table = canonical_table_order(table, self._agg_keys)
            if store is not None:
                n = store.put(_result_key(self._fp, digest), table)
                m.RESULT_CACHE_BYTES.inc(n)
                self._bytes += n
            self._memo_digest, self._memo_table = digest, table
            self._last_manifest = manifest
            return table

    # -- serving surface ----------------------------------------------------

    def warm(self) -> Dict[str, object]:
        """``start()``-time warm: execute once so the first request is
        already a cache hit (and, with a persistent store armed, a
        restarted process warms WITHOUT executing — the store answers)."""
        t0 = time.perf_counter()
        before = self._hits
        table = self.execute()
        report = {
            "endpoint": self.name,
            "warm_s": round(time.perf_counter() - t0, 6),
            "from_cache": self._hits > before,
            "rows": len(next(iter(table.values()))) if table else 0,
            "fingerprint": self._fp,
        }
        logger.info("query warmup[%s]: %s", self.name, report)
        return report

    def open(self) -> None:
        with self._lock:
            self._open = True

    def close(self) -> None:
        with self._lock:
            self._open = False

    def submit(self, feeds, deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> ResultFuture:
        if feeds not in (None, {}):
            raise ValidationError(
                f"query endpoint {self.name!r} takes no feeds (its "
                "input is the registered source's current contents); "
                f"got {type(feeds).__name__}"
            )
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0 (got {deadline_s}) — the same "
                "contract as RetryPolicy.deadline_s"
            )
        with self._lock:
            if not self._open:
                self._rejected["closed"] += 1
                m.rejected("closed").inc()
                raise RejectedError(
                    f"query endpoint {self.name!r} is not accepting "
                    "requests (server stopped or draining)",
                    reason="closed",
                )
            self._admitted_requests += 1
            self._admitted_rows += 1
        m.REQUESTS.inc()
        m.ROWS.inc()
        fut = ResultFuture(self.name, 1)
        t0 = time.perf_counter()
        try:
            fut._set(self.execute())
        except BaseException as e:  # the dispatch-error class: the
            # future carries it (HTTP maps to 500), admission already
            # succeeded — same split as the batcher's dispatch path
            m.DISPATCH_ERRORS.inc()
            fut._fail(e)
        wall = time.perf_counter() - t0
        self._latency.observe(wall)
        m.REQUEST_LATENCY.observe(wall)
        if trace_id:
            _flight.record(
                "serving.query_request", endpoint=self.name,
                trace=trace_id, wall_s=round(wall, 6),
            )
        return fut

    def counters(self) -> Dict[str, object]:
        """Batcher-compatible snapshot for ``Server.stats()``."""
        with self._lock:
            out = {
                "queued_rows": 0,
                "admitted_requests": self._admitted_requests,
                "admitted_rows": self._admitted_rows,
                "rejected": dict(self._rejected),
                "deadline_expired": 0,
            }
        out["latency"] = self._latency.quantiles()
        return out

    def cache_stats(self) -> Dict[str, object]:
        """The result-cache rows ``Server.stats()`` publishes per
        endpoint (per-endpoint mirrors of the process-wide
        ``tftpu_result_cache_*`` series)."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "invalidations": self._invalidations,
                "bytes": self._bytes,
                "chunks_folded": self._chunks_folded,
                "chunks_executed": self._chunks_executed,
                "recomputes": dict(self._recomputes),
                "fingerprint": self._fp,
                "cacheable": self._cache_reason is None,
                "incremental": self._inc_reason is None,
            }
