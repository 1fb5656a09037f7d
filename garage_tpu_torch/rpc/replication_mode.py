"""Replication factor, consistency mode and quorum arithmetic.

Reference src/rpc/replication_mode.rs:8-59:
  read_quorum  = ceil(rf/2)   (degraded/dangerous read 1)
  write_quorum = rf + 1 - read_quorum   (dangerous writes 1)
so read_quorum + write_quorum = rf + 1 > rf (read-your-writes).
RF=3 consistent => read 2 / write 2; RF=2 => read 1 / write 2.

The cluster has TWO quorum tuples: the block plane
keeps `replication_factor` (the EC stripe width k+m), while the
metadata tables carry their own smaller factor (`[meta]
replication_factor`, default 3) so table quorums are O(1) in stripe
width.  The module-level `read_quorum_for`/`write_quorum_for` are the
one implementation of the arithmetic — the meta ring computes its
quorums at the EFFECTIVE factor (min(meta_rf, layout rf), see
table/replication.py) and must not be able to drift from the block
plane's math.
"""

from __future__ import annotations

from dataclasses import dataclass

CONSISTENCY_MODES = ("consistent", "degraded", "dangerous")


def read_quorum_for(rf: int, consistency_mode: str = "consistent") -> int:
    """Read quorum at factor `rf` (ceil(rf/2) when consistent)."""
    if consistency_mode == "consistent":
        return (rf + 1) // 2
    return 1  # degraded | dangerous


def write_quorum_for(rf: int, consistency_mode: str = "consistent") -> int:
    if consistency_mode == "dangerous":
        return 1
    return rf + 1 - read_quorum_for(rf, consistency_mode)


@dataclass(frozen=True)
class ReplicationMode:
    replication_factor: int
    consistency_mode: str = "consistent"  # consistent | degraded | dangerous

    def __post_init__(self):
        if self.replication_factor < 1:
            raise ValueError("replication_factor must be >= 1")
        if self.consistency_mode not in CONSISTENCY_MODES:
            raise ValueError(f"bad consistency mode {self.consistency_mode!r}")

    def read_quorum(self) -> int:
        return read_quorum_for(self.replication_factor, self.consistency_mode)

    def write_quorum(self) -> int:
        return write_quorum_for(self.replication_factor, self.consistency_mode)

    def is_read_after_write_consistent(self) -> bool:
        return self.read_quorum() + self.write_quorum() > self.replication_factor
