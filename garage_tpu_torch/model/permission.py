"""Bucket-key permissions (reference src/model/permission.rs).

A timestamped allow/deny triple; merge keeps the newest decision per flag.
"""

from __future__ import annotations

from typing import Any

from ..utils.crdt import Crdt


class BucketKeyPerm(Crdt):
    __slots__ = ("ts", "allow_read", "allow_write", "allow_owner")

    NO_PERMISSIONS: "BucketKeyPerm"

    def __init__(self, ts: int = 0, allow_read=False, allow_write=False, allow_owner=False):
        self.ts = ts
        self.allow_read = bool(allow_read)
        self.allow_write = bool(allow_write)
        self.allow_owner = bool(allow_owner)

    def merge(self, other: "BucketKeyPerm") -> None:
        if other.ts > self.ts:
            self.ts = other.ts
            self.allow_read = other.allow_read
            self.allow_write = other.allow_write
            self.allow_owner = other.allow_owner
        elif other.ts == self.ts:
            # tie: union of permissions (deterministic, errs on permissive
            # like the reference's merge of equal timestamps)
            self.allow_read = self.allow_read or other.allow_read
            self.allow_write = self.allow_write or other.allow_write
            self.allow_owner = self.allow_owner or other.allow_owner

    def is_any(self) -> bool:
        return self.allow_read or self.allow_write or self.allow_owner

    def to_obj(self) -> Any:
        return [self.ts, self.allow_read, self.allow_write, self.allow_owner]

    @classmethod
    def from_obj(cls, obj: Any) -> "BucketKeyPerm":
        return cls(obj[0], obj[1], obj[2], obj[3])


BucketKeyPerm.NO_PERMISSIONS = BucketKeyPerm()
