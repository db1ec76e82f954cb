"""Out-of-core data plane: the spillable columnar block store.

:mod:`.store` — :class:`BlockStore`: frame blocks under a resident-bytes
budget (``budget_bytes``, 0 by default: disk only), LRU spill to CRC-checked disk
segments with atomic publish and quarantine on corruption. The decode
engine's KV pool swaps through it (``serving/kvpool.py``).

Importing this package pre-registers every ``tftpu_blockstore_*`` metric.
The reference's streaming partitioner, file shuffle and result store
wait in ROADMAP queue 1 (item 7).
"""

from .store import BlockCorruptionError, BlockRef, BlockStore  # noqa: F401

__all__ = ["BlockStore", "BlockRef", "BlockCorruptionError"]
