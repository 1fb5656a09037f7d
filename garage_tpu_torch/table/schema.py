"""Table schema: how entries are keyed, encoded, merged and reacted to.

Reference src/table/schema.rs:72-93.  Entries are CRDT objects; the
`updated` hook runs INSIDE the storage transaction that changed the entry,
so reactive cascades (object -> version -> block_ref -> rc) are atomic
with the write that triggered them.
"""

from __future__ import annotations

from typing import Any

from ..db import Tx
from ..utils.data import blake2sum


class TableSchema:
    table_name: str = ""

    # --- keys ---------------------------------------------------------------

    def entry_partition_key(self, entry) -> bytes:
        raise NotImplementedError

    def entry_sort_key(self, entry) -> bytes:
        raise NotImplementedError

    def partition_hash(self, pk: bytes) -> bytes:
        """Placement hash of a partition key."""
        return blake2sum(pk)

    def tree_key(self, pk: bytes, sk: bytes) -> bytes:
        """Local storage key: hash(pk) || sk (reference table/data.rs)."""
        return self.partition_hash(pk) + sk

    # --- encoding -----------------------------------------------------------

    def encode_entry(self, entry) -> Any:
        return entry.to_obj()

    def decode_entry(self, obj: Any):
        raise NotImplementedError

    # --- semantics ----------------------------------------------------------

    def merge_entries(self, a, b):
        """CRDT merge (in place on a, returns a)."""
        a.merge(b)
        return a

    def is_tombstone(self, entry) -> bool:
        """Tombstones are GC'd by the 3-phase protocol."""
        return False

    def matches_filter(self, entry, filt) -> bool:
        return True

    def updated(self, tx: Tx, old, new) -> None:
        """Reactive hook, called inside the update transaction."""
