"""Spillable columnar block store: the bottom layer of the out-of-core
data plane, and the KV pool's host-swap tier.

A :class:`BlockStore` holds frame blocks (``{column: ndarray | tensor |
list}``) under a resident-bytes budget (the ``budget_bytes`` argument,
by default ``config.block_budget_bytes``, ``TFTPU_BLOCK_BUDGET_MB``; 0 is
the disk-only store the KV swap tier uses). Blocks past the budget spill
to disk least-recently-used; spilled segments reload on demand —
CRC-checked by default, or as zero-read ``np.memmap`` views where the OS
page cache owns residency.

Durability, as in the reference package:

* segments publish via write-temp → fsync → atomic rename, so a crash
  mid-spill never leaves a half-written block under the live name;
* every dense column and the host pickle carry a CRC32 in the manifest;
  a corrupt or truncated reload is **counted**, the segment is
  **quarantined** (renamed aside, never silently re-read), and
  :meth:`BlockStore.get_or_recompute` recomputes the block from its
  lineage instead of serving bad bytes.

Dense columns are stored as their raw bytes with the dtype and shape in
the manifest (``utils/npz``'s codec), so a block of numpy arrays or of
CPU/CUDA tensors spills alike; a reload returns numpy arrays (a dtype
numpy lacks, ``bfloat16``, comes back as a CPU tensor). Consumers:
``TensorFrame.spill_to``, the chunked ``read_csv``/``read_parquet`` ingest
(io.py), the streaming partitioner (partitioner.py), and
``serving.kvpool.PagedKVPool`` (``spill``/``restore`` and the per-sequence
``swap_out_seq``/``swap_in_seq``). Fault site
``blockstore.spill`` (delay semantics too) rides the resilience registry;
``blockstore.*`` flight records land in the crash black box.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import get_config
from ..observability import flight as _flight
from ..observability.metrics import counter as _counter
from ..observability.metrics import gauge as _gauge
from ..observability.metrics import histogram as _histogram
from ..resilience.faults import delay_point, fault_point, register_site
from ..utils import get_logger
from ..utils.npz import decode_array, encode_array

logger = get_logger(__name__)

register_site(
    "blockstore.spill",
    "blockstore/store.py _spill_entry, before the segment publish — an "
    "injected error fails that block's spill (the put raises; resident "
    "accounting is untouched); an injected Delay stalls the spill, "
    "back-pressuring the streaming partitioner deterministically",
)

# Data-plane telemetry, pre-registered at import under the reference's
# names.
RESIDENT_BYTES = _gauge(
    "tftpu_blockstore_resident_bytes",
    "Bytes of block data currently held in host RAM across live block "
    "stores (delta-tracked, like the decode free-pages gauge: several "
    "stores share the one process-wide series)",
)
SPILLED_BYTES = _gauge(
    "tftpu_blockstore_spilled_bytes",
    "Bytes of block data currently spilled to disk segments across "
    "live block stores (delta-tracked)",
)
SPILL_SECONDS = _histogram(
    "tftpu_blockstore_spill_seconds",
    "Wall-clock to publish one block's spill segment (encode + fsync + rename)",
)
RELOAD_SECONDS = _histogram(
    "tftpu_blockstore_reload_seconds",
    "Wall-clock to reload + CRC-check one spilled block",
)
QUARANTINES = _counter(
    "tftpu_blockstore_quarantines_total",
    "Spilled segments failing CRC/manifest checks on reload, renamed aside",
)
HOSTGATHER_BYTES = _counter(
    "tftpu_blockstore_hostgather_bytes_total",
    "Bytes of partial tables host-gathered by multi-process aggregates "
    "(the pre-shuffle path; zero when the file shuffle carries the merge)",
)

_MANIFEST = "manifest.json"
_HOST_PKL = "host.pkl"
_FORMAT_VERSION = 1


class BlockCorruptionError(RuntimeError):
    """A spilled segment failed its CRC/manifest check on reload. The
    segment has already been quarantined and counted; callers holding
    lineage should recompute (:meth:`BlockStore.get_or_recompute`)."""


@dataclass(frozen=True)
class BlockRef:
    """Handle to one block in a :class:`BlockStore` (stable across
    spill/reload; hashable so callers can keep ref → lineage maps)."""

    block_id: int
    nbytes: int
    num_rows: int


class _Entry:
    __slots__ = ("ref", "block", "spilled", "disk_bytes")

    def __init__(self, ref: BlockRef, block: Dict[str, object]):
        self.ref = ref
        self.block = block          # None once spilled-and-dropped
        self.spilled = False        # a clean on-disk segment exists
        self.disk_bytes = 0         # payload bytes of the live segment


def _dense(v) -> bool:
    return torch.is_tensor(v) or (isinstance(v, np.ndarray) and v.dtype != object)


def _block_nbytes(block: Dict[str, object]) -> int:
    total = 0
    for v in block.values():
        if torch.is_tensor(v):
            total += v.numel() * v.element_size()
        elif _dense(v):
            total += int(v.nbytes)
        else:
            # host cells (strings / ragged): a cheap proxy keeps budget
            # accounting O(1); the spill pickles them for real
            total += 64 * max(1, len(v))
    return total


def _block_rows(block: Dict[str, object]) -> int:
    for v in block.values():
        return len(v)
    return 0


def _decode(raw: np.ndarray, meta: Dict) -> object:
    """A column's bytes back as a numpy array of its dtype and shape (a
    view, no copy), or as a CPU tensor for a dtype numpy lacks."""
    try:
        np_dtype = np.dtype(meta["dtype"])
    except TypeError:
        np_dtype = None
    if np_dtype is not None and np_dtype.kind != "V":
        return raw.view(np_dtype).reshape(meta["shape"])
    return decode_array(np.array(raw), meta)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class BlockStore:
    """Spillable block container with an LRU resident-bytes budget.

    ``root`` is the spill directory (created; a private temp dir under
    ``config.blockstore_dir`` by default, deleted at :meth:`close`).
    ``budget_bytes`` bounds the bytes held in RAM across resident blocks
    (default ``config.block_budget_bytes``, ``TFTPU_BLOCK_BUDGET_MB``);
    ``put`` spills the least-recently-used residents past it (0: every
    block spills on arrival). Thread-safe."""

    def __init__(self, root: Optional[str] = None,
                 budget_bytes: Optional[int] = None):
        cfg = get_config()
        if root is None:
            # a private spill dir per store (segment ids are store-local,
            # so two stores must never share one directory)
            parent = cfg.blockstore_dir or None
            if parent:
                os.makedirs(parent, exist_ok=True)
            root = tempfile.mkdtemp(prefix="tftpu-blockstore-", dir=parent)
            self._owns_root = True
        else:
            os.makedirs(root, exist_ok=True)
            self._owns_root = False
        self.root = root
        self.budget_bytes = int(
            cfg.block_budget_bytes if budget_bytes is None else budget_bytes)
        self._lock = threading.RLock()
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._next_id = 0
        self._resident = 0
        self._spilled_bytes = 0

    # -- accounting ---------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        return self._resident

    @property
    def spilled_bytes(self) -> int:
        return self._spilled_bytes

    def _account(self, d_resident: int, d_spilled: int) -> None:
        self._resident += d_resident
        self._spilled_bytes += d_spilled
        # delta-tracked: the gauges aggregate over every live store
        RESIDENT_BYTES.inc(float(d_resident))
        SPILLED_BYTES.inc(float(d_spilled))

    def _seg_dir(self, block_id: int) -> str:
        return os.path.join(self.root, f"blk-{block_id:08d}")

    # -- write side ---------------------------------------------------------

    def put(self, block: Dict[str, object]) -> BlockRef:
        """Register one block; spill LRU residents past the budget."""
        nbytes = _block_nbytes(block)
        with self._lock:
            ref = BlockRef(self._next_id, nbytes, _block_rows(block))
            self._next_id += 1
            self._entries[ref.block_id] = _Entry(ref, dict(block))
            self._account(+nbytes, 0)
            self._enforce_budget()
        return ref

    def put_spilled(self, block: Dict[str, object]) -> BlockRef:
        """Register one block and push it straight to its disk segment
        (temp → fsync → rename, CRC-stamped), dropping the in-RAM copy at
        once. The per-sequence KV swap path: a swapped-out sequence's
        pages are cold by definition and must not displace the resident
        working set — this never spills other blocks the way :meth:`put`
        can."""
        nbytes = _block_nbytes(block)
        with self._lock:
            ref = BlockRef(self._next_id, nbytes, _block_rows(block))
            self._next_id += 1
            e = _Entry(ref, dict(block))
            self._entries[ref.block_id] = e
            self._account(+nbytes, 0)
            try:
                self._spill_entry(e)
            except BaseException:
                # a failed publish leaves nothing behind under this ref
                self._entries.pop(ref.block_id, None)
                self._account(-nbytes, 0)
                raise
        return ref

    def _enforce_budget(self) -> None:
        # under the lock; oldest-touched first. budget <= 0 is the
        # disk-only store: every block spills on arrival
        for bid in list(self._entries):
            if self._resident <= self.budget_bytes:
                return
            e = self._entries[bid]
            if e.block is None:
                continue
            self._spill_entry(e)

    def spill(self, ref: BlockRef) -> None:
        """Explicitly spill one block (no-op if already on disk only)."""
        with self._lock:
            e = self._require(ref)
            if e.block is not None:
                self._spill_entry(e)

    def spill_all(self) -> None:
        with self._lock:
            for e in list(self._entries.values()):
                if e.block is not None:
                    self._spill_entry(e)

    def _spill_entry(self, e: _Entry) -> None:
        """Publish the block's segment (unless already clean on disk) and
        drop the in-RAM copy. Atomic: temp dir → fsync → rename."""
        t0 = time.perf_counter()
        if not e.spilled:
            delay_point("blockstore.spill")
            fault_point("blockstore.spill")
            seg = self._seg_dir(e.ref.block_id)
            tmp = f"{seg}.tmp.{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            cols, host = [], {}
            disk_bytes = 0
            try:
                for name, v in e.block.items():
                    if _dense(v):
                        raw, meta = encode_array(v)
                        fn = f"c{len(cols)}.bin"
                        data = raw.tobytes()
                        with open(os.path.join(tmp, fn), "wb") as f:
                            f.write(data)
                            f.flush()
                            os.fsync(f.fileno())
                        cols.append({
                            "name": name, "kind": "dense", "file": fn,
                            "dtype": meta["dtype"], "shape": meta["shape"],
                            "crc32": zlib.crc32(data), "nbytes": len(data),
                        })
                        disk_bytes += len(data)
                    else:
                        host[name] = list(v)
                if host:
                    payload = pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL)
                    with open(os.path.join(tmp, _HOST_PKL), "wb") as f:
                        f.write(payload)
                        f.flush()
                        os.fsync(f.fileno())
                    cols.append({
                        "kind": "host", "file": _HOST_PKL, "names": sorted(host),
                        "crc32": zlib.crc32(payload), "nbytes": len(payload),
                    })
                    disk_bytes += len(payload)
                manifest = {
                    "format_version": _FORMAT_VERSION,
                    "block_id": e.ref.block_id,
                    "num_rows": e.ref.num_rows,
                    "columns": cols,
                }
                with open(os.path.join(tmp, _MANIFEST), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                shutil.rmtree(seg, ignore_errors=True)
                os.rename(tmp, seg)
                _fsync_dir(self.root)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            e.spilled = True
            e.disk_bytes = disk_bytes
            self._account(0, +disk_bytes)
            _flight.record("blockstore.spill", block_id=e.ref.block_id,
                           nbytes=e.ref.nbytes, disk_bytes=disk_bytes)
        e.block = None
        self._account(-e.ref.nbytes, 0)
        SPILL_SECONDS.observe(time.perf_counter() - t0)

    # -- read side ----------------------------------------------------------

    def _require(self, ref: BlockRef) -> _Entry:
        e = self._entries.get(ref.block_id)
        if e is None:
            raise KeyError(f"block {ref.block_id} is not in this store")
        self._entries.move_to_end(ref.block_id)  # LRU touch
        return e

    def get(self, ref: BlockRef, mmap: bool = False) -> Dict[str, object]:
        """Return one block. Resident blocks come back as they are;
        spilled blocks reload from their segment — CRC-checked by default
        (the segment is read once), or as ``np.memmap`` views with
        ``mmap=True`` (nothing read up front; manifest and sizes are still
        validated). Reloading does not re-admit the block into the
        resident budget: the caller owns the returned dict."""
        with self._lock:
            e = self._require(ref)
            if e.block is not None:
                return e.block
        t0 = time.perf_counter()
        block = self._load_segment(ref, verify=not mmap, mmap=mmap)
        RELOAD_SECONDS.observe(time.perf_counter() - t0)
        return block

    def get_or_recompute(self, ref: BlockRef, recompute: Callable[[], Dict[str, object]],
                         mmap: bool = False) -> Dict[str, object]:
        """:meth:`get`, healing corruption from lineage: a quarantined
        reload recomputes the block, re-publishes the segment and returns
        the fresh copy."""
        try:
            return self.get(ref, mmap=mmap)
        except BlockCorruptionError:
            block = recompute()
            with self._lock:
                e = self._require(ref)
                e.block = dict(block)
                e.spilled = False
                self._account(+ref.nbytes, 0)
                self._spill_entry(e)
            return self.get(ref, mmap=mmap)

    def _load_segment(self, ref: BlockRef, verify: bool, mmap: bool) -> Dict[str, object]:
        seg = self._seg_dir(ref.block_id)
        try:
            with open(os.path.join(seg, _MANIFEST)) as f:
                manifest = json.load(f)
            if manifest.get("format_version", 0) > _FORMAT_VERSION:
                raise ValueError(
                    f"segment format {manifest.get('format_version')} > {_FORMAT_VERSION}"
                )
            block: Dict[str, object] = {}
            for col in manifest["columns"]:
                path = os.path.join(seg, col["file"])
                if col["kind"] == "host":
                    with open(path, "rb") as f:
                        payload = f.read()
                    if zlib.crc32(payload) != col["crc32"]:
                        raise ValueError(f"host pickle CRC mismatch ({path})")
                    block.update(pickle.loads(payload))
                    continue
                if os.path.getsize(path) != col["nbytes"]:
                    raise ValueError(f"segment size mismatch ({path})")
                if verify:
                    with open(path, "rb") as f:
                        data = f.read()
                    if zlib.crc32(data) != col["crc32"]:
                        raise ValueError(f"column CRC mismatch ({path})")
                    raw = np.frombuffer(bytearray(data), np.uint8)
                else:
                    raw = np.memmap(path, dtype=np.uint8, mode="r")
                block[col["name"]] = _decode(raw, {"dtype": col["dtype"],
                                                   "shape": col["shape"]})
            return block
        except (OSError, ValueError, KeyError, TypeError, json.JSONDecodeError,
                pickle.UnpicklingError, EOFError) as err:
            self._quarantine(ref, seg, err)
            raise BlockCorruptionError(
                f"block {ref.block_id} segment failed verification "
                f"({type(err).__name__}: {err}); segment quarantined — "
                "recompute from lineage (get_or_recompute)"
            ) from err

    def _quarantine(self, ref: BlockRef, seg: str, err: BaseException) -> None:
        QUARANTINES.inc()
        _flight.record("blockstore.quarantine", block_id=ref.block_id,
                       error=type(err).__name__, message=str(err)[:200])
        with self._lock:
            e = self._entries.get(ref.block_id)
            if e is not None:
                e.spilled = False
                self._account(0, -e.disk_bytes)
                e.disk_bytes = 0
        aside = f"{seg}.quarantine.{os.getpid()}"
        try:
            shutil.rmtree(aside, ignore_errors=True)
            os.rename(seg, aside)
        except OSError:  # pragma: no cover - already gone/raced
            pass
        logger.warning("blockstore: quarantined segment for block %d (%s)", ref.block_id, err)

    # -- lifecycle ----------------------------------------------------------

    def drop(self, ref: BlockRef) -> None:
        """Forget one block and delete its segment."""
        with self._lock:
            e = self._entries.pop(ref.block_id, None)
            if e is None:
                return
            if e.block is not None:
                self._account(-e.ref.nbytes, 0)
            if e.spilled:
                shutil.rmtree(self._seg_dir(ref.block_id), ignore_errors=True)
                self._account(0, -e.disk_bytes)

    def refs(self) -> List[BlockRef]:
        with self._lock:
            return [e.ref for e in self._entries.values()]

    def close(self) -> None:
        """Drop everything; delete the root if this store created it."""
        with self._lock:
            for ref in list(self.refs()):
                self.drop(ref)
            if self._owns_root:
                shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self) -> "BlockStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"BlockStore(root={self.root!r}, blocks={len(self._entries)}, "
            f"resident={self._resident}, spilled={self._spilled_bytes}, "
            f"budget={self.budget_bytes})"
        )


__all__ = ["BlockStore", "BlockRef", "BlockCorruptionError"]
