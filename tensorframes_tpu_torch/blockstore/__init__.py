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
* :mod:`.shuffle` — the file shuffle: a rank-to-rank exchange through
  CRC-framed spill files in a shared directory, and the
  ``distributed_aggregate``/``distributed_join`` helpers over it.

Importing this package pre-registers every ``tftpu_blockstore_*`` and
``tftpu_resultstore_*`` metric.
"""

from .partitioner import SpilledFrame, stream_chain  # noqa: F401
from .resultstore import ResultStore  # noqa: F401
from .store import BlockCorruptionError, BlockRef, BlockStore  # noqa: F401
from . import shuffle  # noqa: F401

__all__ = [
    "BlockStore", "BlockRef", "BlockCorruptionError",
    "ResultStore", "SpilledFrame", "stream_chain",
]
