"""Input-partition content digests: the half of a registered query's
result-cache key that names WHAT a plan computed over.

The reference package's ``compilecache/fingerprint.py:83-130``, its
content-digest half. The plan fingerprint
(:func:`~tensorframes_tpu_torch.plan.stats.chain_fingerprint`) names what
computes; these name the input, so a (plan fingerprint, content digest)
pair stays a valid key across process restarts: both halves are derived
from content, never from ``hash()``, object ids or addresses. The same
files give the same digests in both packages.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable

import numpy as np

__all__ = ["part_signature", "content_digest", "frame_content_digest"]


def part_signature(path: str) -> str:
    """Signature of one on-disk part file: sha256 over (basename, size,
    mtime_ns). A stat proxy, deliberately not a content hash: a growing
    directory is fingerprinted in O(#files) stat calls, and any ordinary
    rewrite moves mtime_ns. A rewrite that keeps the size and forges the
    nanosecond mtime would serve stale."""
    st = os.stat(path)
    h = hashlib.sha256()
    h.update(os.path.basename(path).encode())
    h.update(b"|%d|%d" % (int(st.st_size), int(st.st_mtime_ns)))
    return h.hexdigest()[:24]


def content_digest(signatures: Iterable[str]) -> str:
    """Fold per-part signatures into one input-partition digest. Order
    matters: the manifest order is the row order."""
    h = hashlib.sha256(b"parts|")
    for sig in signatures:
        h.update(str(sig).encode())
        h.update(b"|")
    return h.hexdigest()[:32]


def frame_content_digest(frame) -> str:
    """Content digest of an in-memory frame (a registered query's static
    source): the schema and every block's bytes. Dense columns hash their
    buffer, host and object columns their repr."""
    h = hashlib.sha256(b"frame|")
    h.update(json.dumps(
        [(c.name, c.dtype.name) for c in frame.schema]
    ).encode())
    for block in frame.blocks():
        for name in sorted(block):
            v = block[name]
            h.update(name.encode() + b"|")
            if isinstance(v, list):
                h.update(repr(v).encode())
                continue
            arr = np.asarray(v)
            if arr.dtype == object:
                h.update(repr(arr.tolist()).encode())
            else:
                h.update(str((arr.shape, str(arr.dtype))).encode())
                h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:32]
