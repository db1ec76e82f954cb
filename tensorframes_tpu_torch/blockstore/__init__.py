"""Out-of-core data plane: the spillable columnar block store, the
streaming partitioner and the content-keyed result store.

* :mod:`.store` — :class:`BlockStore`: frame blocks under a resident-bytes
  budget (``TFTPU_BLOCK_BUDGET_MB``, 512 MB, by default), LRU spill to
  CRC-checked disk segments with atomic publish and quarantine on
  corruption. The decode engine's KV pool swaps through it
  (``serving/kvpool.py``) with a budget of 0.
* :mod:`.partitioner` — :func:`stream_chain` / :class:`SpilledFrame`: a
  lazy verb chain over a frame larger than RAM, walked block by block,
  results spilling as they complete.
* :mod:`.resultstore` — :class:`ResultStore`: a registered query's cached
  results and per-chunk partials under content keys.

Importing this package pre-registers every ``tftpu_blockstore_*`` and
``tftpu_resultstore_*`` metric. The reference's file shuffle is
multi-process and waits in ROADMAP queue 1 (item 5).
"""

from .partitioner import SpilledFrame, stream_chain  # noqa: F401
from .resultstore import ResultStore  # noqa: F401
from .store import BlockCorruptionError, BlockRef, BlockStore  # noqa: F401

__all__ = [
    "BlockStore", "BlockRef", "BlockCorruptionError",
    "ResultStore", "SpilledFrame", "stream_chain",
]
