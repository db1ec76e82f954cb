"""Clean-room TensorFlow TensorBundle (checkpoint) reader.

A TF2 SavedModel stores its variable values as a *tensor bundle*:
``variables/variables.index`` (a LevelDB-style sorted string table
mapping tensor keys to ``BundleEntryProto`` records) plus one or more
``variables/variables.data-NNNNN-of-MMMMM`` shards holding the raw
tensor bytes. This module reads both with no TensorFlow dependency, so
a variable-bearing SavedModel imports without freezing it through TF
first (``graphdef.py`` ``load_saved_model``). It is the port's own copy
of ``tensorframes_tpu/bundle.py`` (host-only, numpy), with the same
formats, error types and messages.

Wire formats implemented here (all public, stable TF formats):

* **SSTable** (``variables.index``): 48-byte footer (varint64 block
  handles + magic ``0xdb4775248b80fb57``), prefix-compressed blocks
  with a restart array, 1-byte compression tag per block (only raw,
  type 0, is produced for bundle indexes).
* **BundleEntryProto** (value of each index entry): dtype (field 1),
  TensorShapeProto (2), shard_id (3), offset (4), size (5), crc32c (6).
* **Bundle string tensors** (the ``_CHECKPOINTABLE_OBJECT_GRAPH``
  entry): per-element varint lengths, a 4-byte crc of the lengths,
  then the concatenated bytes.
* **TrackableObjectGraph** (the object graph tensor's payload): nodes
  (field 1) with attributes (field 2) = SerializedTensor {name=1,
  full_name=2, checkpoint_key=3} — the map from a variable's graph
  name to its checkpoint key.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_FOOTER_MAGIC = bytes.fromhex("57fb808b247547db")  # little-endian magic


class BundleError(ValueError):
    """Raised for malformed bundle files (callers may fall back)."""


def _read_varint(b: bytes, p: int) -> Tuple[int, int]:
    x = 0
    s = 0
    while True:
        if p >= len(b):
            raise BundleError("truncated varint")
        c = b[p]
        p += 1
        x |= (c & 0x7F) << s
        if not c & 0x80:
            return x, p
        s += 7


def _iter_fields(b: bytes):
    p = 0
    while p < len(b):
        tag, p = _read_varint(b, p)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, p = _read_varint(b, p)
        elif wire == 2:
            ln, p = _read_varint(b, p)
            v = b[p : p + ln]
            p += ln
        elif wire == 5:
            v = b[p : p + 4]
            p += 4
        elif wire == 1:
            v = b[p : p + 8]
            p += 8
        else:
            raise BundleError(f"unsupported wire type {wire}")
        yield field, wire, v


def _parse_table_block(data: bytes, off: int, size: int) -> List[Tuple[bytes, bytes]]:
    """Decode one SSTable block (prefix-compressed entries + restart
    array). The byte at ``data[off+size]`` is the compression tag —
    bundle index blocks are written raw (type 0)."""
    # ``>=``: the compression-tag byte at data[off+size] must itself be
    # in range, else a truncated index crashes with IndexError instead
    # of the BundleError the fallback contract documents
    if off + size >= len(data):
        raise BundleError("block handle past end of file")
    if size < 4:
        raise BundleError("block too small for a restart array")
    if data[off + size] != 0:
        raise BundleError(
            f"compressed index block (type {data[off + size]}) — bundle "
            "indexes are written uncompressed"
        )
    raw = data[off : off + size]
    n_restarts = struct.unpack("<I", raw[-4:])[0]
    limit = len(raw) - 4 * (n_restarts + 1)
    if limit < 0:
        raise BundleError("restart array larger than block")
    entries: List[Tuple[bytes, bytes]] = []
    p = 0
    key = b""
    while p < limit:
        shared, p = _read_varint(raw, p)
        unshared, p = _read_varint(raw, p)
        vlen, p = _read_varint(raw, p)
        key = key[:shared] + raw[p : p + unshared]
        p += unshared
        entries.append((key, raw[p : p + vlen]))
        p += vlen
    return entries


def _parse_shape(data: bytes) -> List[int]:
    dims: List[int] = []
    for field, _, v in _iter_fields(data):
        if field == 2:
            size = 0
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    size = v2
            dims.append(int(size))
    return dims


# types.proto DataType enum → numpy dtype for the bundle payloads
_BUNDLE_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    6: np.int8,
    9: np.int64,
    10: np.bool_,
    19: np.float16,
}
try:  # bfloat16 payloads need ml_dtypes (a dependency of the port's bfloat16 columns)
    import ml_dtypes as _mld

    _BUNDLE_DTYPES[14] = _mld.bfloat16
except Exception:  # pragma: no cover - ml_dtypes ships with the port's dependencies
    pass
_DT_STRING = 7


class BundleEntry:
    __slots__ = ("dtype_enum", "shape", "shard_id", "offset", "size")

    def __init__(self, value: bytes):
        self.dtype_enum = 0
        self.shape: List[int] = []
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        for field, _, v in _iter_fields(value):
            if field == 1:
                self.dtype_enum = int(v)
            elif field == 2:
                self.shape = _parse_shape(v)
            elif field == 3:
                self.shard_id = int(v)
            elif field == 4:
                self.offset = int(v)
            elif field == 5:
                self.size = int(v)


def read_index(index_path: str) -> Dict[str, BundleEntry]:
    """Parse ``variables.index`` into ``{tensor_key: BundleEntry}``."""
    with open(index_path, "rb") as f:
        data = f.read()
    if len(data) < 48 or data[-8:] != _FOOTER_MAGIC:
        raise BundleError(f"{index_path}: not a tensor-bundle index")
    footer = data[-48:-8]
    p = 0
    _meta_off, p = _read_varint(footer, p)
    _meta_size, p = _read_varint(footer, p)
    idx_off, p = _read_varint(footer, p)
    idx_size, p = _read_varint(footer, p)
    entries: Dict[str, BundleEntry] = {}
    for _, handle in _parse_table_block(data, idx_off, idx_size):
        boff, q = _read_varint(handle, 0)
        bsize, q = _read_varint(handle, q)
        for key, value in _parse_table_block(data, boff, bsize):
            if key == b"":
                continue  # BundleHeaderProto (num_shards/endianness)
            entries[key.decode("utf-8")] = BundleEntry(value)
    return entries


def _shard_path(prefix: str, shard_id: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard_id:05d}-of-{num_shards:05d}"


def _read_entry(prefix: str, entry: BundleEntry, num_shards: int):
    path = _shard_path(prefix, entry.shard_id, num_shards)
    with open(path, "rb") as f:
        f.seek(entry.offset)
        raw = f.read(entry.size)
    if len(raw) != entry.size:
        raise BundleError(f"{path}: truncated read at {entry.offset}")
    if entry.dtype_enum == _DT_STRING:
        n = int(np.prod(entry.shape)) if entry.shape else 1
        lens = []
        p = 0
        for _ in range(n):
            ln, p = _read_varint(raw, p)
            lens.append(ln)
        p += 4  # crc32c of the lengths
        out = np.empty(n, object)
        for i, ln in enumerate(lens):
            out[i] = raw[p : p + ln]
            p += ln
        return out.reshape(entry.shape) if entry.shape else out[0]
    np_dt = _BUNDLE_DTYPES.get(entry.dtype_enum)
    if np_dt is None:
        raise BundleError(
            f"bundle tensor dtype enum {entry.dtype_enum} unsupported"
        )
    arr = np.frombuffer(raw, np_dt)
    return arr.reshape(entry.shape)


def _object_graph_name_map(og_bytes: bytes) -> Dict[str, str]:
    """TrackableObjectGraph → ``{variable full_name: checkpoint_key}``."""
    mapping: Dict[str, str] = {}
    for field, _, node in _iter_fields(og_bytes):
        if field != 1:
            continue
        for f2, _, attr in _iter_fields(node):
            if f2 != 2:  # attributes: SerializedTensor
                continue
            full = key = None
            for f3, _, v3 in _iter_fields(attr):
                if f3 == 2 and isinstance(v3, bytes):
                    full = v3.decode("utf-8")
                elif f3 == 3 and isinstance(v3, bytes):
                    key = v3.decode("utf-8")
            if key and full:
                mapping[full] = key
    return mapping


_OBJECT_GRAPH_KEY = "_CHECKPOINTABLE_OBJECT_GRAPH"
_VAR_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def restore_variables(variables_dir: str) -> Dict[str, np.ndarray]:
    """Read every variable in a SavedModel's ``variables/`` directory,
    keyed by the VARIABLE NAME the graph's ``VarHandleOp`` nodes carry
    (``shared_name``), with the bare checkpoint keys as a fallback
    alias. TF-free at conversion AND scoring time."""
    prefix = os.path.join(variables_dir, "variables")
    entries = read_index(prefix + ".index")
    # num_shards: derive from the shard files present (header says too,
    # but the filesystem is authoritative for what we can read)
    num_shards = 1
    for name in os.listdir(variables_dir):
        if name.startswith("variables.data-"):
            num_shards = int(name.rsplit("-", 1)[1])
            break
    name_map: Dict[str, str] = {}
    if _OBJECT_GRAPH_KEY in entries:
        og = _read_entry(prefix, entries[_OBJECT_GRAPH_KEY], num_shards)
        og_bytes = og if isinstance(og, bytes) else bytes(og)
        name_map = _object_graph_name_map(og_bytes)
    out: Dict[str, np.ndarray] = {}
    for key, entry in entries.items():
        if key == _OBJECT_GRAPH_KEY or entry.dtype_enum == _DT_STRING:
            continue
        value = _read_entry(prefix, entry, num_shards)
        out[key] = value
        if key.endswith(_VAR_SUFFIX):
            out.setdefault(key[: -len(_VAR_SUFFIX)], value)
    # the object graph's full_name is the graph-side variable name for
    # keras-style models whose checkpoint keys are object paths
    # (layer_with_weights-0/kernel/…) rather than variable names
    for full, key in name_map.items():
        if key in out:
            out.setdefault(full, out[key])
    return out
