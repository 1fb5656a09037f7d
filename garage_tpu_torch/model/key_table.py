"""Access-key table (full-copy; reference src/model/key_table.rs).

Key id format `GK` + hex (like the reference); the secret is a 64-hex
string.  Permissions live on the key side: authorized_buckets maps
bucket_id -> BucketKeyPerm.
"""

from __future__ import annotations

import os
from typing import Any

from ..table.schema import TableSchema
from ..utils.crdt import Crdt, Deletable, Lww, LwwMap
from .permission import BucketKeyPerm


class KeyParams(Crdt):
    def __init__(
        self,
        secret_key: str,
        name: Lww | None = None,
        allow_create_bucket: Lww | None = None,
        authorized_buckets: LwwMap | None = None,  # bucket_id -> perm obj
        local_aliases: LwwMap | None = None,  # name -> bucket_id | None
    ):
        self.secret_key = secret_key
        self.name = name or Lww.raw(0, "")
        self.allow_create_bucket = allow_create_bucket or Lww.raw(0, False)
        self.authorized_buckets = authorized_buckets or LwwMap()
        self.local_aliases = local_aliases or LwwMap()

    def merge(self, other: "KeyParams") -> None:
        self.name.merge(other.name)
        self.allow_create_bucket.merge(other.allow_create_bucket)
        self.authorized_buckets.merge(other.authorized_buckets)
        self.local_aliases.merge(other.local_aliases)

    def to_obj(self) -> Any:
        return {
            "sk": self.secret_key,
            "n": self.name.to_obj(),
            "acb": self.allow_create_bucket.to_obj(),
            "ab": self.authorized_buckets.to_obj(),
            "la": self.local_aliases.to_obj(),
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "KeyParams":
        return cls(
            secret_key=obj["sk"],
            name=Lww.from_obj(obj["n"]),
            allow_create_bucket=Lww.from_obj(obj["acb"]),
            authorized_buckets=LwwMap.from_obj(obj["ab"]),
            local_aliases=LwwMap.from_obj(obj["la"]),
        )


class Key:
    def __init__(self, key_id: str, state: Deletable):
        self.key_id = key_id
        self.state = state  # Deletable[KeyParams]

    @classmethod
    def new(cls, name: str = "") -> "Key":
        key_id = "GK" + os.urandom(12).hex()
        secret = os.urandom(32).hex()
        params = KeyParams(secret)
        params.name.update(name)
        return cls(key_id, Deletable.present(params))

    def is_deleted(self) -> bool:
        return self.state.is_deleted()

    def params(self) -> KeyParams | None:
        return self.state.get()

    def secret(self) -> str | None:
        p = self.params()
        return p.secret_key if p else None

    def bucket_permissions(self, bucket_id: bytes) -> BucketKeyPerm:
        p = self.params()
        if p is None:
            return BucketKeyPerm.NO_PERMISSIONS
        perm = p.authorized_buckets.get(bucket_id)
        return BucketKeyPerm.from_obj(perm) if perm else BucketKeyPerm.NO_PERMISSIONS

    def merge(self, other: "Key") -> None:
        self.state.merge(other.state)

    def to_obj(self) -> Any:
        return [self.key_id, self.state.to_obj()]


class KeyTable(TableSchema):
    table_name = "key"

    def entry_partition_key(self, e: Key) -> bytes:
        return e.key_id.encode()

    def entry_sort_key(self, e: Key) -> bytes:
        return b""

    def decode_entry(self, obj: Any) -> Key:
        return Key(obj[0], Deletable.from_obj(obj[1], KeyParams.from_obj))

    def is_tombstone(self, e: Key) -> bool:
        return e.is_deleted()
