"""Layout data types (reference src/rpc/layout/mod.rs:37-150)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

PARTITION_BITS = 8
N_PARTITIONS = 1 << PARTITION_BITS  # 256


def partition_of(hash32: bytes) -> int:
    """Partition = top PARTITION_BITS bits of the key hash
    (reference version.rs:101-104)."""
    return hash32[0]


@dataclass
class NodeRole:
    """Role assigned to a node: zone, capacity in bytes (None = gateway:
    serves API traffic, stores no partitions), free-form tags
    (reference mod.rs:83-94)."""

    zone: str
    capacity: int | None
    tags: list[str] = field(default_factory=list)

    def to_obj(self) -> Any:
        return [self.zone, self.capacity, list(self.tags)]

    @classmethod
    def from_obj(cls, obj: Any) -> "NodeRole":
        return cls(zone=obj[0], capacity=obj[1], tags=list(obj[2]))


class ZoneRedundancy:
    """'maximum' = spread replicas over as many zones as possible;
    AtLeast(x) = each partition must span >= x distinct zones
    (reference mod.rs:143-150)."""

    MAXIMUM = "maximum"

    @staticmethod
    def at_least(x: int) -> int:
        return x

    @staticmethod
    def to_obj(v) -> Any:
        return v

    @staticmethod
    def from_obj(obj) -> Any:
        return obj
