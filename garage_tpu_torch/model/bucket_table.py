"""Bucket table (full-copy; reference src/model/bucket_table.rs).

A bucket is identified by a random 32-byte id; human names are aliases
(global, or local to an access key).  All parameters are LWW registers so
concurrent admin edits converge.
"""

from __future__ import annotations

from typing import Any

from ..table.schema import TableSchema
from ..utils.crdt import Crdt, Deletable, Lww, LwwMap
from ..utils.time_util import now_msec


class BucketParams(Crdt):
    def __init__(
        self,
        creation_date: int | None = None,
        aliases: LwwMap | None = None,  # global alias name -> bool
        local_aliases: LwwMap | None = None,  # [key_id, name] -> bool
        website: Lww | None = None,  # None | {index_document, error_document}
        cors: Lww | None = None,  # None | list of cors rules
        lifecycle: Lww | None = None,  # None | list of lifecycle rules
        quotas: Lww | None = None,  # {max_size, max_objects}
    ):
        self.creation_date = creation_date if creation_date is not None else now_msec()
        self.aliases = aliases or LwwMap()
        self.local_aliases = local_aliases or LwwMap()
        self.website = website or Lww.raw(0, None)
        self.cors = cors or Lww.raw(0, None)
        self.lifecycle = lifecycle or Lww.raw(0, None)
        self.quotas = quotas or Lww.raw(0, {"max_size": None, "max_objects": None})

    def merge(self, other: "BucketParams") -> None:
        self.creation_date = min(self.creation_date, other.creation_date)
        self.aliases.merge(other.aliases)
        self.local_aliases.merge(other.local_aliases)
        self.website.merge(other.website)
        self.cors.merge(other.cors)
        self.lifecycle.merge(other.lifecycle)
        self.quotas.merge(other.quotas)

    def to_obj(self) -> Any:
        return {
            "cd": self.creation_date,
            "al": self.aliases.to_obj(),
            "la": self.local_aliases.to_obj(),
            "web": self.website.to_obj(),
            "cors": self.cors.to_obj(),
            "lc": self.lifecycle.to_obj(),
            "q": self.quotas.to_obj(),
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "BucketParams":
        return cls(
            creation_date=obj["cd"],
            aliases=LwwMap.from_obj(obj["al"]),
            local_aliases=LwwMap.from_obj(obj["la"]),
            website=Lww.from_obj(obj["web"]),
            cors=Lww.from_obj(obj["cors"]),
            lifecycle=Lww.from_obj(obj["lc"]),
            quotas=Lww.from_obj(obj["q"]),
        )


class Bucket:
    def __init__(self, bucket_id: bytes, state: Deletable):
        self.id = bucket_id
        self.state = state  # Deletable[BucketParams]

    @classmethod
    def new(cls, bucket_id: bytes) -> "Bucket":
        return cls(bucket_id, Deletable.present(BucketParams()))

    def is_deleted(self) -> bool:
        return self.state.is_deleted()

    def params(self) -> BucketParams | None:
        return self.state.get()

    def merge(self, other: "Bucket") -> None:
        self.state.merge(other.state)

    def to_obj(self) -> Any:
        return [self.id, self.state.to_obj()]


class BucketTable(TableSchema):
    table_name = "bucket"

    def entry_partition_key(self, e: Bucket) -> bytes:
        return e.id

    def entry_sort_key(self, e: Bucket) -> bytes:
        return b""

    def decode_entry(self, obj: Any) -> Bucket:
        return Bucket(
            bytes(obj[0]), Deletable.from_obj(obj[1], BucketParams.from_obj)
        )

    def is_tombstone(self, e: Bucket) -> bool:
        return e.is_deleted()
