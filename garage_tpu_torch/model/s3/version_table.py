"""Version table: block lists of object versions
(reference src/model/s3/version_table.rs).

pk = version uuid (placement by uuid hash — spreads a big object's
metadata independently of the object entry), sk = "".

blocks: CrdtMap keyed [part_number, offset] -> {"h": hash, "s": size};
deleted: Bool tombstone.  The `updated()` hook cascades deletion to the
block_ref table (which decrements rc transactionally).
"""

from __future__ import annotations

from typing import Any

from ...table.schema import TableSchema
from ...utils.crdt import Bool, CrdtMap


class Version:
    def __init__(
        self,
        uuid: bytes,
        bucket_id: bytes,
        key: str,
        blocks: CrdtMap | None = None,
        parts_etags: CrdtMap | None = None,
        deleted: Bool | None = None,
    ):
        self.uuid = uuid
        self.bucket_id = bucket_id
        self.key = key
        self.blocks = blocks or CrdtMap()  # [part, offset] -> {"h","s"}
        self.parts_etags = parts_etags or CrdtMap()  # part -> etag (mpu)
        self.deleted = deleted or Bool(False)

    @classmethod
    def deleted_marker(cls, uuid: bytes, bucket_id: bytes, key: str) -> "Version":
        return cls(uuid, bucket_id, key, deleted=Bool(True))

    def merge(self, other: "Version") -> None:
        self.deleted.merge(other.deleted)
        if self.deleted.get():
            self.blocks = CrdtMap()
            self.parts_etags = CrdtMap()
        else:
            self.blocks.merge(other.blocks)
            self.parts_etags.merge(other.parts_etags)

    def sorted_blocks(self) -> list[tuple[tuple[int, int], dict]]:
        """Blocks in (part, offset) order — the object's byte stream."""
        return [((int(k[0]), int(k[1])), v) for k, v in self.blocks.items()]

    def total_size(self) -> int:
        return sum(v["s"] for _k, v in self.sorted_blocks())

    def to_obj(self) -> Any:
        return [
            self.uuid,
            self.bucket_id,
            self.key,
            self.blocks.to_obj(),
            self.parts_etags.to_obj(),
            self.deleted.to_obj(),
        ]


class VersionRowCache:
    """Per-node LRU of COMPLETE versions' rows, keyed by version uuid
    (metadata fast path).  Safety argument: a GET only looks
    up vids its quorum-fresh OBJECT row declares complete-and-visible,
    and such a version's block list is immutable — every block entry
    was quorum-committed before the complete object row was written
    (api/s3/objects.py, api/s3/multipart.py), and the row can only be
    tombstoned after the version stops being visible (the prune
    cascade), at which point no fresh object row resolves it.  So a
    cache hit can never serve a block list that differs from what a
    quorum read would return for a visible vid.  Overwrites/deletes
    need no invalidation (the object row gates visibility); the only
    consumer-side fallback is the escalation path, which bypasses the
    cache by construction.  Entry-bounded, per node — NEVER a process
    singleton (in-process multi-node tests)."""

    def __init__(self, max_entries: int = 1024):
        from collections import OrderedDict

        self.max_entries = int(max_entries)
        self._d: "OrderedDict[bytes, Version]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, vid: bytes) -> "Version | None":
        if self.max_entries <= 0:
            return None
        v = self._d.get(bytes(vid))
        if v is None:
            self.misses += 1
            return None
        self._d.move_to_end(bytes(vid))
        self.hits += 1
        return v

    def put(self, vid: bytes, ver: "Version") -> None:
        if self.max_entries <= 0 or ver.deleted.get():
            return
        self._d[bytes(vid)] = ver
        self._d.move_to_end(bytes(vid))
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)


class VersionTable(TableSchema):
    table_name = "version"

    def __init__(self, block_ref_table=None):
        self.block_ref_table = block_ref_table

    def entry_partition_key(self, e: Version) -> bytes:
        return e.uuid

    def entry_sort_key(self, e: Version) -> bytes:
        return b""

    def decode_entry(self, obj: Any) -> Version:
        blocks = CrdtMap.from_obj(obj[3])
        for _k, v in blocks.items():
            v["h"] = bytes(v["h"])
        return Version(
            bytes(obj[0]),
            bytes(obj[1]),
            obj[2],
            blocks,
            CrdtMap.from_obj(obj[4]),
            Bool.from_obj(obj[5]),
        )

    def merge_entries(self, a: Version, b: Version) -> Version:
        a.merge(b)
        return a

    def is_tombstone(self, e: Version) -> bool:
        return e.deleted.get()

    def updated(self, tx, old: Version | None, new: Version | None) -> None:
        if self.block_ref_table is None:
            return
        from .block_ref_table import BlockRef

        was_deleted = old is None or old.deleted.get()
        now_deleted = new is None or new.deleted.get()
        if not was_deleted and now_deleted:
            # deletion cascade: tombstone every block reference
            for _k, blk in old.sorted_blocks():
                self.block_ref_table.queue_insert(
                    BlockRef(blk["h"], old.uuid, deleted=Bool(True)), tx=tx
                )