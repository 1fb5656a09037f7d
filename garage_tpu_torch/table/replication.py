"""Replication strategies (reference src/table/replication/).

TableShardedReplication — data tables: each entry lives on the rf nodes
the layout assigns to hash(pk); quorums from the replication mode
(sharded.rs:16-50).

TableMetaReplication — the `model/` sharded tables carry
their own (small) replication factor instead of inheriting the block
plane's stripe width.  Entries live on the METADATA RING: the first
`meta_rf` distinct nodes of the partition's layout node list, derived
per active layout version — so an ec:8:3 cluster quorums object/
version/blockref rows over 3 nodes while blocks still fan to all 11.
Quorums come from the meta replication mode at the EFFECTIVE factor
min(meta_rf, layout rf) (replica modes "1"/"2" fall back to the full
partition node list), keeping `read_q + write_q > effective_rf`
(read-your-writes) by the same arithmetic as the block plane.  Sync,
GC and offload all go through this interface, so anti-entropy follows
the meta ring and never repairs to a node that no longer stores the
partition.

TableFullReplication — control-plane tables (buckets, keys): every node
stores everything; reads are local; writes go to all nodes with a majority
quorum (fullcopy.rs:21-55).
"""

from __future__ import annotations

from ..rpc.layout.types import N_PARTITIONS
from ..rpc.replication_mode import (
    ReplicationMode,
    read_quorum_for,
    write_quorum_for,
)
from ..rpc.system import System


class TableReplication:
    # full-copy tables sync as one partition covering the whole keyspace
    full_copy = False

    def read_nodes(self, hash32: bytes) -> list[bytes]:
        raise NotImplementedError

    def read_quorum(self) -> int:
        raise NotImplementedError

    def write_sets(self, hash32: bytes) -> list[list[bytes]]:
        raise NotImplementedError

    def write_quorum(self) -> int:
        raise NotImplementedError

    def storage_nodes(self, hash32: bytes) -> list[bytes]:
        """All nodes that should (eventually) store this hash."""
        raise NotImplementedError

    def background_nodes(self, hash32: bytes) -> list[bytes]:
        """Nodes that should eventually store this hash but take no part
        in quorum accounting: inserts send them best-effort background
        copies, anti-entropy is the backstop.  Empty for every strategy
        whose quorum set IS its storage set."""
        return []

    def local_partitions(self, node: bytes) -> list[tuple[int, bytes]]:
        """(partition index, first hash of partition) stored by `node`."""
        raise NotImplementedError

    def partition_of(self, hash32: bytes) -> int:
        """Merkle/sync partition for a placement hash."""
        raise NotImplementedError


def partition_first_hash(p: int) -> bytes:
    return bytes([p]) + b"\x00" * 31


class TableShardedReplication(TableReplication):
    def __init__(self, system: System):
        self.system = system

    @property
    def _layout(self):
        return self.system.layout_manager.history

    def read_nodes(self, hash32: bytes) -> list[bytes]:
        return self._layout.read_nodes_of(hash32)

    def read_quorum(self) -> int:
        return self.system.replication_mode.read_quorum()

    def write_sets(self, hash32: bytes) -> list[list[bytes]]:
        return self._layout.write_sets_of(hash32)

    def write_quorum(self) -> int:
        return self.system.replication_mode.write_quorum()

    def storage_nodes(self, hash32: bytes) -> list[bytes]:
        # union over self.write_sets (NOT the raw layout sets) so the
        # meta subclass's ring subsetting applies to sync/GC/offload too
        nodes: list[bytes] = []
        for s in self.write_sets(hash32):
            for n in s:
                if n not in nodes:
                    nodes.append(n)
        return nodes

    def partition_of(self, hash32: bytes) -> int:
        return hash32[0]

    def _partition_nodes_of(self, v, p: int) -> list[bytes]:
        """One layout version's storage set for partition `p` — the seam
        the meta subclass narrows to its ring."""
        return v.nodes_of_partition(p)

    def local_partitions(self, node: bytes) -> list[tuple[int, bytes]]:
        out = []
        for p in range(N_PARTITIONS):
            fh = partition_first_hash(p)
            if any(
                node in self._partition_nodes_of(v, p)
                for v in self._layout.versions
                if v.ring_assignment
            ):
                out.append((p, fh))
        return out


class TableMetaReplication(TableShardedReplication):
    """The metadata ring (module docstring): first `meta_rf` distinct
    nodes of each partition's node list, per active layout version.

    Ring properties the tier-1 tests pin down:
      - distinctness: the subset inherits the layout invariant that a
        partition's replicas are distinct nodes (and dedupes
        defensively, so a corrupt assignment can't shrink a quorum
        silently);
      - stability: the layout orders a partition's nodes previous-
        holders-first (version.py compute_assignment), so the meta
        subset only changes when the partition's placement actually
        changes — tracker gossip never moves it;
      - transitions: one subset per ACTIVE version, so writes quorum in
        every active version's meta set and a read from the newest
        synced version intersects the write set of the same version
        (`read_q + write_q > effective_rf`);
      - fallback: a layout whose own rf is below meta_rf (replica
        modes "1"/"2") keeps the full partition node list, with quorums
        at that smaller effective factor.
    """

    def __init__(self, system: System, mode: ReplicationMode):
        super().__init__(system)
        # `mode` carries the CONFIGURED [meta] replication_factor +
        # consistency mode; the effective factor follows the live layout
        self.mode = mode

    def effective_rf(self) -> int:
        return min(
            self.mode.replication_factor, self._layout.replication_factor
        )

    def meta_nodes_of(self, nodes: list[bytes]) -> list[bytes]:
        rf = self.mode.replication_factor
        out: list[bytes] = []
        for n in nodes:
            if n not in out:
                out.append(n)
                if len(out) >= rf:
                    break
        return out

    def read_nodes(self, hash32: bytes) -> list[bytes]:
        return self.meta_nodes_of(self._layout.read_nodes_of(hash32))

    def read_quorum(self) -> int:
        return read_quorum_for(self.effective_rf(), self.mode.consistency_mode)

    def write_sets(self, hash32: bytes) -> list[list[bytes]]:
        return [
            self.meta_nodes_of(s) for s in self._layout.write_sets_of(hash32)
        ]

    def write_quorum(self) -> int:
        return write_quorum_for(
            self.effective_rf(), self.mode.consistency_mode
        )

    def _partition_nodes_of(self, v, p: int) -> list[bytes]:
        return self.meta_nodes_of(v.nodes_of_partition(p))


class TableStripeSyncedReplication(TableMetaReplication):
    """block_ref only: meta-ring QUORUMS, full-stripe ANTI-ENTROPY.

    The block_ref table is the pivot between the metadata and data
    planes: its `updated()` hook feeds each node's local rc tree, and
    the rc tree is what resync, scrub, the durability ledger and block
    GC walk — so every node holding a PIECE of block h must eventually
    hold h's ref rows, even though the foreground insert only needs a
    small quorum.  This strategy therefore keeps the fast path on the
    meta ring (insert/get fan to meta_rf nodes, same quorum arithmetic
    as TableMetaReplication — read-your-writes holds because reads and
    writes use the same per-version subsets) while `storage_nodes` /
    `local_partitions` span the FULL stripe: the Merkle syncer treats
    every piece holder as a replica, so refs reach rank >= meta_rf
    holders within one anti-entropy round (<= sync interval, immediate
    on layout change), and the 3-phase tombstone GC still requires
    every holder's ack before a deletion marker may disappear (any
    holder could otherwise resurrect the ref).  The lag is benign: rc
    on a high-rank holder arriving late only delays background heal/
    scrub/ledger visibility of a young block — piece durability comes
    from the direct block-plane write, and deletion keeps the rc GC
    delay on top.  See doc/metadata-replication.md."""

    def storage_nodes(self, hash32: bytes) -> list[bytes]:
        nodes: list[bytes] = []
        for s in self._layout.write_sets_of(hash32):
            for n in s:
                if n not in nodes:
                    nodes.append(n)
        return nodes

    def background_nodes(self, hash32: bytes) -> list[bytes]:
        """The stripe holders beyond the meta ring: they receive
        foreground best-effort copies so a young block's refs (and the
        rc entries they feed) appear on its piece holders immediately
        instead of at the next anti-entropy round."""
        quorum: set[bytes] = set()
        for s in self.write_sets(hash32):
            quorum.update(s)
        return [n for n in self.storage_nodes(hash32) if n not in quorum]

    def _partition_nodes_of(self, v, p: int) -> list[bytes]:
        return v.nodes_of_partition(p)


class TableFullReplication(TableReplication):
    full_copy = True

    def __init__(self, system: System):
        self.system = system

    def _all_nodes(self) -> list[bytes]:
        nodes = self.system.layout_manager.history.all_nodes()
        if not nodes:
            nodes = [self.system.id]
        return nodes

    def read_nodes(self, hash32: bytes) -> list[bytes]:
        return [self.system.id]  # always readable locally

    def read_quorum(self) -> int:
        return 1

    def write_sets(self, hash32: bytes) -> list[list[bytes]]:
        return [self._all_nodes()]

    def write_quorum(self) -> int:
        n = len(self._all_nodes())
        return n // 2 + 1

    def storage_nodes(self, hash32: bytes) -> list[bytes]:
        return self._all_nodes()

    def partition_of(self, hash32: bytes) -> int:
        return 0

    def local_partitions(self, node: bytes) -> list[tuple[int, bytes]]:
        # full-copy tables sync as a single partition 0
        return [(0, partition_first_hash(0))]
