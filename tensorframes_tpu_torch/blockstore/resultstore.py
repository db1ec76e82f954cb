"""Content-keyed persistent tables: cached query results and aggregate
partials.

The reference package's ``blockstore/resultstore.py``, with its file
format: a second serving process must find the first one's cached result
under nothing but content keys — (plan fingerprint, input-partition
digest) for whole results, (plan fingerprint, chunk signature) for
per-chunk aggregate partials — so :class:`BlockStore` segments, keyed by
store-local block ids, cannot carry them. :class:`ResultStore` is that
mapping: one CRC-framed file per table under a caller-chosen root
(``<TFTPU_COMPILE_CACHE>/results`` in serving), atomic-rename publish,
quarantine on corruption. Entries are small aggregate tables, so there is
no budget or LRU; eviction is the operator's ``rm -r``.

A *table* is ``{column name: np.ndarray | list}``, what
:meth:`TensorFrame.column_values` yields per column. It is pickled and
framed by ``TFRS\x01`` + (crc32, length), so a torn write or a flipped
bit never deserializes into a wrong answer: :meth:`load` reports it as
``corrupt`` and the caller recomputes (counted). An entry either package
wrote loads in the other.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from ..observability.metrics import counter as _counter
from ..utils import get_logger

logger = get_logger(__name__)

__all__ = ["ResultStore"]

#: File frame: magic + format byte, then little-endian (crc32, length)
#: of the pickled table payload. Bump the magic on layout changes so
#: old entries miss cleanly instead of mis-deserializing.
_MAGIC = b"TFRS\x01"
_HEADER = struct.Struct("<IQ")

_WRITES = _counter(
    "tftpu_resultstore_writes_total",
    "Tables published into content-keyed result stores",
)
_CORRUPT = _counter(
    "tftpu_resultstore_corrupt_total",
    "Result-store entries that failed CRC/format verification on load "
    "and were quarantined (the caller recomputes — corruption never "
    "serves a wrong answer)",
)


_KEY_CHARS = frozenset(
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ-._"
)


def _safe_key(key: str) -> str:
    if not key or any(c not in _KEY_CHARS for c in key):
        raise ValueError(
            f"result-store keys must be non-empty [alnum.-_] strings, "
            f"got {key!r}"
        )
    return key


class ResultStore:
    """One directory of CRC-framed, content-keyed tables."""

    def __init__(self, root: str):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, _safe_key(key) + ".tbl")

    # -- read ---------------------------------------------------------------

    def load(self, key: str) -> Tuple[Optional[Dict[str, object]], bool]:
        """``(table, corrupt)``: the stored table and ``False``; a clean
        miss is ``(None, False)``; a present-but-damaged entry is
        quarantined and reported as ``(None, True)`` so the caller can
        COUNT the recompute it now owes."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None, False
        except OSError as e:  # unreadable counts as damage, not a miss
            logger.warning("result store %s: read failed: %s", key, e)
            self._quarantine(path, f"read failed: {e}")
            return None, True
        try:
            if blob[: len(_MAGIC)] != _MAGIC:
                raise ValueError("bad magic / format version")
            crc, length = _HEADER.unpack_from(blob, len(_MAGIC))
            payload = blob[len(_MAGIC) + _HEADER.size:]
            if len(payload) != length:
                raise ValueError(
                    f"truncated payload ({len(payload)} != {length})"
                )
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError("CRC mismatch")
            table = pickle.loads(payload)
            if not isinstance(table, dict):
                raise ValueError(f"payload is {type(table).__name__}, "
                                 "not a column table")
        except Exception as e:
            logger.warning("result store %s: corrupt entry: %s", key, e)
            self._quarantine(path, str(e))
            return None, True
        return table, False

    # -- write --------------------------------------------------------------

    def put(self, key: str, table: Dict[str, object]) -> int:
        """Publish ``table`` under ``key`` (last-writer-wins, atomic
        rename — a concurrent reader sees the old entry or the new one,
        never a torn file). Returns bytes written."""
        payload = pickle.dumps(dict(table), protocol=4)
        blob = (_MAGIC
                + _HEADER.pack(zlib.crc32(payload) & 0xFFFFFFFF,
                               len(payload))
                + payload)
        path = self._path(key)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        _WRITES.inc()
        return len(blob)

    def drop(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self) -> List[str]:
        return sorted(
            name[: -len(".tbl")]
            for name in os.listdir(self.root)
            if name.endswith(".tbl")
        )

    def _quarantine(self, path: str, why: str) -> None:
        _CORRUPT.inc()
        try:
            os.replace(path, path + ".corrupt")
        except OSError:  # racing quarantine/unlink: gone either way
            pass
        logger.warning("result store quarantined %s (%s)", path, why)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ResultStore(root={self.root!r})"
