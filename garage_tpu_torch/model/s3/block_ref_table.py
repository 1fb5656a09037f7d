"""Block reference table (reference src/model/s3/block_ref_table.rs).

pk = block hash (so refs of a block live WITH the block's storage nodes),
sk = version uuid.  The `updated()` hook adjusts the block manager's
refcounts inside the same transaction, and queues a resync check when a
block becomes needed or unneeded — this is the pivot between the metadata
plane and the data plane.
"""

from __future__ import annotations

from typing import Any

from ...table.schema import TableSchema
from ...utils.crdt import Bool


class BlockRef:
    def __init__(self, block: bytes, version: bytes, deleted: Bool | None = None):
        self.block = block
        self.version = version
        self.deleted = deleted or Bool(False)

    def merge(self, other: "BlockRef") -> None:
        self.deleted.merge(other.deleted)

    def to_obj(self) -> Any:
        return [self.block, self.version, self.deleted.to_obj()]


class BlockRefTable(TableSchema):
    table_name = "block_ref"

    def __init__(self, block_manager=None):
        self.block_manager = block_manager

    def entry_partition_key(self, e: BlockRef) -> bytes:
        return e.block

    def entry_sort_key(self, e: BlockRef) -> bytes:
        return e.version

    def partition_hash(self, pk: bytes) -> bytes:
        # the partition key IS the block hash: placement must match the
        # block's own placement, so no re-hashing (reference block_ref
        # sharding is by block hash directly)
        return pk

    def decode_entry(self, obj: Any) -> BlockRef:
        return BlockRef(bytes(obj[0]), bytes(obj[1]), Bool.from_obj(obj[2]))

    def merge_entries(self, a: BlockRef, b: BlockRef) -> BlockRef:
        a.merge(b)
        return a

    def is_tombstone(self, e: BlockRef) -> bool:
        return e.deleted.get()

    def updated(self, tx, old: BlockRef | None, new: BlockRef | None) -> None:
        if self.block_manager is None:
            return
        was_ref = old is not None and not old.deleted.get()
        now_ref = new is not None and not new.deleted.get()
        block = (new or old).block
        if not was_ref and now_ref:
            if self.block_manager.rc.incr(tx, block):
                # 0 -> 1: we may need to fetch this block, once the
                # PUT that made the reference has had its time to land
                resync = self.block_manager.resync
                resync.queue_block(block, delay_ms=resync.incref_delay_ms(), tx=tx)
        if was_ref and not now_ref:
            if self.block_manager.rc.decr(tx, block):
                # rc hit 0: deletion marker set; check after the delay
                from ...block.rc import BLOCK_GC_DELAY_MS

                self.block_manager.resync.queue_block(
                    block, delay_ms=BLOCK_GC_DELAY_MS + 1000, tx=tx
                )