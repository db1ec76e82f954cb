"""Warmup: dispatch the expected feed-shape keys ahead of traffic.

The reference package's ``compilecache/warmup.py``. There ``warmup``
compiles (or loads from the store) one XLA executable per key; PyTorch
compiles nothing per shape, so here to warm a key is to dispatch the
program once at that shape on the verb's device, on zero-filled feeds
(:meth:`~tensorframes_tpu_torch.ops.executor.CompiledProgram.warm`). That
pays, ahead of the first request, for what a first dispatch costs: the
kernel library's load, the cuBLAS and cuDNN handles, the allocator's
growth. The warmed key is marked dispatched, so the first real dispatch
at that shape is a hit; with a persistent store
(``TFTPU_COMPILE_CACHE``) each key is also recorded, and a later process
reads ``disk`` for it.

Shape selection is the reference's, exactly:

* **block mode** (``map_blocks``): the at-most-two block row counts of
  the partitioner, or a materialized frame's distinct block sizes;
* **rows mode** (``map_rows``): each row count and its power-of-two
  bucket (:func:`~tensorframes_tpu_torch.ops.executor.bucket_rows`);
* an explicit ``rows=[...]`` overrides both; a recorded **manifest**
  (``manifest=``, appended at every new key the store records) replays
  an earlier process's shapes.

Pass :class:`~tensorframes_tpu_torch.program.Program` objects (from
``compile_program``) when later verb calls should find the keys warm in
this process: a bare function normalizes to a fresh Program per call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import torch

# the bucket ladders live in the package (they need no warmup machinery);
# this module re-exports them under the reference's names
from . import decode_slot_buckets, decode_warmup_grid, serving_row_buckets  # noqa: E402,F401

__all__ = [
    "WarmupReport", "warmup", "warm_program", "partitioner_row_counts",
    "serving_row_buckets", "decode_slot_buckets", "decode_warmup_grid",
]


@dataclasses.dataclass
class WarmupReport:
    """What a warmup pass did: one row per (program, kind, shape)."""

    entries: List[dict] = dataclasses.field(default_factory=list)

    def add(self, subject: str, kind: str, rows: Optional[int],
            status: str, detail: str = "") -> None:
        self.entries.append({
            "subject": subject, "kind": kind, "rows": rows,
            "status": status, "detail": detail,
        })

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.entries:
            out[e["status"]] = out.get(e["status"], 0) + 1
        return out

    @property
    def compiled(self) -> int:
        return self.counts().get("compiled", 0)

    @property
    def disk_hits(self) -> int:
        return self.counts().get("disk", 0)

    def pretty(self) -> str:
        c = self.counts()
        head = "warmup: " + ", ".join(
            f"{k}={v}" for k, v in sorted(c.items())
        ) if c else "warmup: nothing to do"
        lines = [head]
        for e in self.entries:
            rows = "?" if e["rows"] is None else e["rows"]
            extra = f" ({e['detail']})" if e["detail"] else ""
            lines.append(
                f"  {e['subject']} [{e['kind']} rows={rows}]: "
                f"{e['status']}{extra}"
            )
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover - convenience
        return self.pretty()


def _as_program_list(fetches, schema, block: bool, feed_dict, device):
    """One Program per fetches item (a list of DSL nodes is ONE
    multi-output program, as in the verbs)."""
    from ..dsl.node import Node
    from ..ops.verbs import _apply_feed_dict, _normalize_program
    from ..program import Program

    if isinstance(fetches, (list, tuple)) and fetches and not all(
        isinstance(f, Node) for f in fetches
    ):
        items = list(fetches)
    else:
        items = [fetches]
    out = []
    for item in items:
        if isinstance(item, Program) and item.outputs:
            program = item
        else:
            if schema is None:
                raise ValueError(
                    "warmup() needs a frame or schema to normalize "
                    "non-Program fetches (pass compile_program results "
                    "to warm without one)"
                )
            program, _ = _normalize_program(
                item, schema, block=block, device=device, feed_dict=feed_dict
            )
        out.append(_apply_feed_dict(program, feed_dict))
    return out


def partitioner_row_counts(total: int, num_blocks: int) -> List[int]:
    """The at-most-two block sizes the frame partitioner yields for
    ``total`` rows in ``num_blocks`` blocks (``n//k`` and ``n//k+1``)."""
    num_blocks = max(1, int(num_blocks))
    base = total // num_blocks
    sizes = {base, base + 1} if total % num_blocks else {base}
    return sorted(s for s in sizes if s > 0) or [total]


def _target_row_counts(frame, rows, block: bool) -> List[int]:
    if rows is not None:
        counts = sorted({int(r) for r in rows if int(r) > 0})
        if not counts:
            raise ValueError("warmup rows= must contain positive ints")
        return counts
    if frame is None:
        raise ValueError(
            "warmup() needs rows=[...] when no frame is given"
        )
    if frame.is_materialized:
        from ..frame import _block_num_rows

        return sorted({_block_num_rows(b) for b in frame.blocks()})
    # lazy frame: never force it — a pinned block lead dim in the schema
    # IS the block row count; otherwise give up loudly
    for col in frame.schema.columns:
        d = col.block_shape.dims[0]
        if isinstance(d, int):
            return [int(d)]
    raise ValueError(
        "warmup() cannot infer block sizes from a lazy frame with "
        "unknown row counts; pass rows=[...] (warmup never forces "
        "a pending computation)"
    )


def _abstract_feeds(program, n: int, kind: str):
    """Meta tensors at lead dim ``n``, exactly as the executor will see
    the feeds (``map_rows`` adds the row dim to the cell shape). None
    when an input has unknown inner dims."""
    from ..shape import Unknown

    feeds = {}
    for spec in program.inputs:
        dims = list(spec.shape.dims)
        if kind == "block":
            dims[0] = n
            cell = dims[1:]
        else:
            cell = dims
            dims = [n] + dims
        if any(d == Unknown for d in cell):
            return None
        feeds[spec.name] = torch.empty(
            tuple(int(d) for d in dims), dtype=spec.dtype.torch_dtype, device="meta"
        )
    return feeds


def _subject(program) -> str:
    return f"Program(inputs={program.input_names})"


def warm_program(program, rows: Sequence[int], block: bool = True,
                 donate: Optional[bool] = None,
                 report: Optional[WarmupReport] = None,
                 device=None) -> WarmupReport:
    """Warm one analyzed Program at explicit lead-dim row counts on
    ``device`` (default ``config.device``); :func:`warmup` is the
    frame-aware front door. ``donate`` is accepted for the reference's
    signature and has no effect (the port donates nothing)."""
    from ..config import resolve_device
    from ..ops.executor import bucket_rows

    device = resolve_device(device)
    report = report if report is not None else WarmupReport()
    kind = "block" if block else "vmap"
    if block:
        targets = sorted({int(r) for r in rows})
    else:
        # map_rows buckets adaptively: exact shapes while the frame
        # presents few sizes, power-of-two buckets once shapes
        # proliferate — warm both regimes
        targets = sorted(
            {int(r) for r in rows} | {bucket_rows(int(r)) for r in rows}
        )
    for n in targets:
        feeds = _abstract_feeds(program, n, kind)
        if feeds is None:
            report.add(_subject(program), kind, n, "skipped",
                       "unknown inner dims (ragged cells warm per group "
                       "at dispatch)")
            continue
        report.add(_subject(program), kind, n, program.compiled().warm(kind, feeds, device))
    return report


def _manifest_row_matches(program, row) -> bool:
    """A manifest row targets this program only when every recorded input
    matches the program's spec by name, dtype and known cell dims (the
    manifest is store-wide, and programs often share input names)."""
    from ..shape import Unknown

    inputs = row.get("inputs", [])
    if sorted(n for (n, _, _) in inputs) != sorted(program.input_names):
        return False
    kind = row.get("kind", "block")
    for (name, shape, dtype) in inputs:
        try:
            spec = program.input(name)
        except KeyError:
            return False
        if str(spec.dtype.torch_dtype).replace("torch.", "") != str(dtype):
            return False
        # recorded shapes are block-level: the lead dim is the row count,
        # the tail must fit the spec's cell dims
        cell = list(spec.shape.dims[1:]) if kind == "block" \
            else list(spec.shape.dims)
        if len(shape) != len(cell) + 1:
            return False
        for got, want_d in zip(shape[1:], cell):
            if want_d != Unknown and int(got) != int(want_d):
                return False
    return True


def _warm_from_manifest(programs, manifest_rows, report: WarmupReport, device) -> None:
    for program in programs:
        for row in manifest_rows:
            if not _manifest_row_matches(program, row):
                continue
            try:
                feeds = {
                    n: torch.empty(tuple(int(d) for d in s),
                                   dtype=getattr(torch, str(t)), device="meta")
                    for (n, s, t) in row["inputs"]
                }
            except (TypeError, ValueError, AttributeError):
                continue  # torn or stale manifest row
            kind = row.get("kind", "block")
            status = program.compiled().warm(kind, feeds, device)
            lead = None
            for v in feeds.values():
                lead = int(v.shape[0]) if v.dim() else None
                break
            report.add(_subject(program), kind, lead, status, "manifest")


def warmup(frame_or_schema, programs_or_verbs, *, rows=None,
           block: bool = True, feed_dict=None, donate: Optional[bool] = None,
           manifest=None, device=None) -> WarmupReport:
    """Dispatch, ahead of traffic, every key real dispatches will use.

    ``frame_or_schema`` — a TensorFrame (block sizes from the partitioner
    contract or the materialized blocks), a Schema (pass ``rows=``), or
    None when every fetch is an analyzed Program. ``programs_or_verbs`` —
    one fetches item or a sequence: Programs, plain functions or DSL
    nodes (a list of nodes is one program). ``rows=[...]`` — explicit
    lead-dim row counts (``block=False`` targets add their power-of-two
    buckets). ``manifest=`` — True (the active store's manifest) or a
    path: replay recorded feed shapes. ``device`` — where to dispatch
    (default ``config.device``).

    Returns a :class:`WarmupReport`; a warmed key makes the first real
    dispatch at its shape a hit, and with a persistent store a later
    process reads ``disk`` for it.
    """
    from ..config import resolve_device

    device = resolve_device(device)
    schema = getattr(frame_or_schema, "schema", frame_or_schema)
    frame = frame_or_schema if hasattr(frame_or_schema, "schema") else None
    programs = _as_program_list(
        programs_or_verbs, schema, block=block, feed_dict=feed_dict, device=device
    )
    report = WarmupReport()

    if manifest:
        if manifest is True:
            from .store import active_store

            store = active_store()
            if store is None:
                raise ValueError(
                    "warmup(manifest=True) needs an active persistent "
                    "store — set TFTPU_COMPILE_CACHE or "
                    "configure(compilation_cache_dir=...), or pass the "
                    "manifest path explicitly"
                )
            manifest_rows = store.read_manifest()
        else:
            if not os.path.exists(str(manifest)):
                raise ValueError(
                    f"warmup manifest {manifest!r} does not exist — a "
                    "silently-empty warmup would leave the first "
                    "request paying the full compile"
                )
            from .store import CompileCacheStore

            probe = CompileCacheStore.__new__(CompileCacheStore)
            probe.manifest_path = str(manifest)
            manifest_rows = CompileCacheStore.read_manifest(probe)
        _warm_from_manifest(programs, manifest_rows, report, device)

    if rows is not None or frame is not None or not manifest:
        counts = _target_row_counts(frame, rows, block)
        for program in programs:
            warm_program(program, counts, block=block, donate=donate,
                         report=report, device=device)
    return report
