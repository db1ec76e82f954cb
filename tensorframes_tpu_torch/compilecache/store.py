"""Size-bounded on-disk store of dispatch keys, and the kernel library
beside it.

The reference package's ``compilecache/store.py`` keeps one serialized
XLA executable per fingerprint. PyTorch compiles nothing per shape
(:mod:`tensorframes_tpu_torch.ops.executor`), so what survives a process
here is of two kinds:

* **the kernel library** (``build/torch_kernels/libtftorch_kernels-<hash>.so``,
  :mod:`tensorframes_tpu_torch.kernels`): the one compiled artifact, named
  by the content hash of its sources, built once and loaded by every
  later process;
* **the dispatch keys**: one entry per fingerprint
  (:func:`~.fingerprint.dispatch_fingerprint`), ``<fp>.xc``, holding the
  key's meta record (its fingerprint components, entry kind, feed shapes
  and dtypes). The executor consults the store at every first-seen
  dispatch key when ``compilation_cache_dir`` is set: a recorded key
  counts a hit, a new one is recorded and counted a miss, and its feed
  shapes are appended to ``manifest.jsonl``, which :func:`warmup
  <tensorframes_tpu_torch.compilecache.warmup>` replays in a later
  process. The executor reads no payload back: an entry is what a key
  was, not how to run it.

The mechanics are the reference's: entries publish by write-temp, fsync,
atomic ``os.replace`` (two writers of one key both succeed); every entry
carries a CRC32 of its record, and a corrupt or truncated one is counted,
quarantined (unlinked) and treated as a miss; eviction is LRU by bytes
(mtime, refreshed on a hit) against ``config.compile_cache_max_bytes``.
A store problem never fails a dispatch. ``stats``, ``verify`` and
``prune`` also report the kernel libraries: ``verify`` names the one
built from the current sources and the stale ones, ``prune`` removes the
stale ones.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..observability.metrics import counter as _counter
from ..observability.metrics import gauge as _gauge
from ..observability.metrics import histogram as _histogram
from ..utils import get_logger
from .fingerprint import FORMAT_VERSION

logger = get_logger(__name__)

__all__ = ["CompileCacheStore", "active_store", "note_unfingerprintable", "store_for"]

_MAGIC = b"TFXC"
_ENTRY_SUFFIX = ".xc"
_LIB_GLOB = "libtftorch_kernels-*.so"

# Registered at import: a process that never enables the store still
# exposes the whole family at 0.
_HITS = _counter(
    "tftpu_compilecache_hits_total",
    "Executables served from the persistent AOT store instead of compiled",
)
_MISSES = _counter(
    "tftpu_compilecache_misses_total",
    "Store lookups that found no entry (a fresh compile follows)",
)
_LOAD_SECONDS = _histogram(
    "tftpu_compilecache_load_seconds",
    "Wall-clock to read + CRC-check + deserialize one stored executable",
)
_BYTES_WRITTEN = _counter(
    "tftpu_compilecache_bytes_total",
    "Bytes of serialized executables written to the persistent store",
)
_STORE_BYTES = _gauge(
    "tftpu_compilecache_store_bytes",
    "Current total size of the persistent store directory's entries",
)
_EVICTIONS = _counter(
    "tftpu_compilecache_evictions_total",
    "Entries removed by LRU eviction against the byte bound",
)
_FALLBACKS = {
    reason: _counter(
        "tftpu_compilecache_fallback_total",
        "Store operations abandoned in favor of a normal compile, by reason",
        labels={"reason": reason},
    )
    for reason in (
        "corrupt", "deserialize", "store_error", "tree_unsupported",
        "unavailable", "unfingerprintable",
    )
}


def note_unfingerprintable() -> None:
    """Count a dispatch that skipped the store because its program could
    not be fingerprinted (it fails under ``FakeTensorMode``: ``.item()``,
    data-dependent shapes). The dispatch runs as always; it just never
    records or hits a key."""
    _FALLBACKS["unfingerprintable"].inc()


_STORE_LOCK = threading.Lock()
_STORES: Dict[Tuple[str, int], Optional["CompileCacheStore"]] = {}


class CompileCacheStore:
    """One directory of ``<fingerprint>.xc`` entries + ``manifest.jsonl``."""

    def __init__(self, root: str, max_bytes: int = 0):
        self.root = root
        self.max_bytes = int(max_bytes)
        self.manifest_path = os.path.join(root, "manifest.jsonl")
        self._manifest_seen: set = set()
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    # -- paths --------------------------------------------------------------

    def _path(self, fp: str) -> str:
        if not fp or any(c in fp for c in "/\\."):
            raise ValueError(f"bad fingerprint {fp!r}")
        return os.path.join(self.root, fp + _ENTRY_SUFFIX)

    def _entries(self) -> List[Tuple[str, float, int]]:
        """[(path, mtime, size)] of current entries, oldest first."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            if not name.endswith(_ENTRY_SUFFIX):
                continue
            p = os.path.join(self.root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue  # raced with an eviction elsewhere
            out.append((p, st.st_mtime, st.st_size))
        out.sort(key=lambda e: e[1])
        return out

    # -- read ---------------------------------------------------------------

    def _read_entry(self, path: str) -> Tuple[dict, dict]:
        """Parse + CRC-check one entry file into (header, record); raises
        on any defect."""
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:4] != _MAGIC:
            raise ValueError("bad magic")
        (version,) = struct.unpack("<I", blob[4:8])
        if version != FORMAT_VERSION:
            raise ValueError(f"format version {version}")
        (hlen,) = struct.unpack("<Q", blob[8:16])
        header = json.loads(blob[16:16 + hlen].decode("utf-8"))
        payload = blob[16 + hlen:]
        if len(payload) != header["payload_bytes"]:
            raise ValueError("truncated payload")
        if zlib.crc32(payload) != header["payload_crc32"]:
            raise ValueError("payload CRC mismatch")
        return header, json.loads(payload.decode("utf-8"))

    def get(self, fp: str) -> Optional[dict]:
        """The recorded meta of key ``fp``, or None on a miss or any defect
        (defects are counted and quarantined, never raised)."""
        path = self._path(fp)
        if not os.path.exists(path):
            _MISSES.inc()
            return None
        t0 = time.perf_counter()
        try:
            _, record = self._read_entry(path)
        except Exception as e:
            logger.warning("compile cache entry %s unreadable (%s); "
                           "quarantining, dispatching as a new key",
                           os.path.basename(path), e)
            _FALLBACKS["corrupt"].inc()
            self._quarantine(path)
            _MISSES.inc()
            return None
        _HITS.inc()
        _LOAD_SECONDS.observe(time.perf_counter() - t0)
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        return record

    def _quarantine(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    # -- write --------------------------------------------------------------

    def put(self, fp: str, meta: dict) -> bool:
        """Publish one key's meta record. Best-effort: returns False (and
        counts the reason) instead of raising."""
        try:
            payload = json.dumps(meta, sort_keys=True).encode("utf-8")
            header = {
                "fingerprint": fp,
                "created": round(time.time(), 3),
                "payload_bytes": len(payload),
                "payload_crc32": zlib.crc32(payload),
            }
            hbytes = json.dumps(header, sort_keys=True).encode("utf-8")
            blob = (_MAGIC + struct.pack("<I", FORMAT_VERSION)
                    + struct.pack("<Q", len(hbytes)) + hbytes + payload)
            path = self._path(fp)
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            from ..checkpoint import _fsync_path

            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic publish; racing writers both win
            _fsync_path(self.root)
            _BYTES_WRITTEN.inc(len(blob))
            self._evict()
            return True
        except Exception as e:
            logger.warning("compile cache store of %s failed (%s); "
                           "continuing unrecorded", fp, e)
            _FALLBACKS["store_error"].inc()
            return False

    def _evict(self) -> None:
        """LRU-evict entries until total bytes fit the bound. The newest
        entry survives even when alone over the bound."""
        entries = self._entries()
        total = sum(s for _, _, s in entries)
        _STORE_BYTES.set(total)
        if self.max_bytes <= 0:
            return
        while total > self.max_bytes and len(entries) > 1:
            path, _, size = entries.pop(0)
            try:
                os.unlink(path)
            except OSError:
                if os.path.exists(path):
                    continue  # undeletable but still present: skip it
                total -= size  # a racing process already evicted it
                continue
            total -= size
            _EVICTIONS.inc()
            logger.info("compile cache evicted %s (%d bytes; store over "
                        "%d-byte bound)", os.path.basename(path), size,
                        self.max_bytes)
        _STORE_BYTES.set(total)

    # -- manifest -----------------------------------------------------------

    def record_miss(self, kind: str,
                    inputs: Sequence[Tuple[str, Tuple[int, ...], str]]) -> None:
        """Append one feed-shape record for warmup replay (deduplicated
        per process; best-effort)."""
        row = {
            "kind": kind,
            "inputs": sorted([n, list(s), d] for (n, s, d) in inputs),
        }
        key = json.dumps(row, sort_keys=True)
        with self._lock:
            if key in self._manifest_seen:
                return
            self._manifest_seen.add(key)
        try:
            with open(self.manifest_path, "a") as f:
                f.write(key + "\n")
        except OSError as e:
            logger.debug("manifest append failed: %s", e)

    def read_manifest(self) -> List[dict]:
        rows: List[dict] = []
        try:
            with open(self.manifest_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rows.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # torn tail line from a crashed writer
        except OSError:
            pass
        return rows

    # -- the kernel libraries -----------------------------------------------

    @staticmethod
    def libraries() -> dict:
        """The kernel libraries on disk: ``current`` (the file built from
        the current sources, or None when not built yet) and ``stale``
        (files built from other sources), each ``{"file", "bytes"}``."""
        from .. import kernels

        lib_dir = Path(kernels.BUILD_DIR)
        want = kernels.library_path().name
        current, stale = None, []
        for p in sorted(lib_dir.glob(_LIB_GLOB)):
            try:
                row = {"file": p.name, "bytes": p.stat().st_size}
            except OSError:
                continue
            if p.name == want:
                current = row
            else:
                stale.append(row)
        return {"dir": str(lib_dir), "sources_hash": kernels.sources_hash(),
                "current": current, "stale": stale}

    # -- ops surface (CLI) --------------------------------------------------

    def stats(self) -> dict:
        entries = []
        for path, mtime, size in self._entries():
            row = {
                "fingerprint": os.path.basename(path)[:-len(_ENTRY_SUFFIX)],
                "bytes": size,
                "mtime": round(mtime, 3),
            }
            try:
                header, record = self._read_entry(path)
                row["created"] = header.get("created")
                for k in ("kind", "device_kind", "torch", "kernels", "inputs"):
                    if k in record:
                        row[k] = record[k]
            except Exception:
                row["unreadable"] = True
            entries.append(row)
        return {
            "root": self.root,
            "max_bytes": self.max_bytes,
            "entries": len(entries),
            "bytes": sum(e["bytes"] for e in entries),
            "manifest_rows": len(self.read_manifest()),
            "entry_list": entries,
            "libraries": self.libraries(),
        }

    def verify(self, delete_bad: bool = False) -> dict:
        """CRC + header check of every entry; optionally removes the
        defective ones. Also names the kernel library built from the
        current sources and the stale ones (``prune`` removes those)."""
        good, bad = [], []
        for path, _, _ in self._entries():
            name = os.path.basename(path)
            try:
                self._read_entry(path)
                good.append(name)
            except Exception as e:
                bad.append({"entry": name, "error": str(e)})
                if delete_bad:
                    self._quarantine(path)
        return {"ok": not bad, "good": len(good), "bad": bad,
                "deleted": len(bad) if delete_bad else 0,
                "libraries": self.libraries()}

    def prune(self, max_bytes: Optional[int] = None, clear: bool = False) -> dict:
        """Evict to ``max_bytes`` (default: the configured bound), or drop
        every entry and the manifest with ``clear=True``; either way
        remove the kernel libraries built from other sources than the
        current ones."""
        removed = 0
        if clear:
            for path, _, _ in self._entries():
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
            try:
                os.unlink(self.manifest_path)
            except OSError:
                pass
        else:
            bound = self.max_bytes if max_bytes is None else int(max_bytes)
            entries = self._entries()
            total = sum(s for _, _, s in entries)
            while entries and total > bound:
                path, _, size = entries.pop(0)
                try:
                    os.unlink(path)
                except OSError:
                    if os.path.exists(path):
                        continue  # undeletable but present: skip it
                    total -= size  # already gone: its bytes left the disk
                    continue
                total -= size
                removed += 1
        libs = self.libraries()
        pruned_libs = []
        for row in libs["stale"]:
            try:
                os.unlink(os.path.join(libs["dir"], row["file"]))
                pruned_libs.append(row["file"])
            except OSError:
                pass
        left = self._entries()
        _STORE_BYTES.set(sum(s for _, _, s in left))
        return {"removed": removed, "entries": len(left),
                "bytes": sum(s for _, _, s in left),
                "libraries_removed": pruned_libs}


def store_for(root: str, max_bytes: Optional[int] = None
              ) -> Optional["CompileCacheStore"]:
    """Store instance for an explicit directory (the CLI's surface); None
    when the directory cannot be created."""
    from ..config import get_config

    mb = get_config().compile_cache_max_bytes if max_bytes is None \
        else int(max_bytes)
    key = (os.path.abspath(root), mb)
    with _STORE_LOCK:
        if key not in _STORES:
            try:
                _STORES[key] = CompileCacheStore(key[0], mb)
            except OSError as e:
                logger.warning("compile cache unavailable at %s: %s",
                               root, e)
                _FALLBACKS["unavailable"].inc()
                _STORES[key] = None
        return _STORES[key]


def active_store() -> Optional["CompileCacheStore"]:
    """The config-selected store (``<compilation_cache_dir>/aot``, beside
    the plan-stats sidecar's ``planstats`` and the result store's
    ``results``), or None when the cache is off — the default, in which
    case every dispatch behaves as if this module did not exist."""
    from ..config import get_config

    root = get_config().compilation_cache_dir
    if not root:
        return None
    return store_for(os.path.join(root, "aot"))
