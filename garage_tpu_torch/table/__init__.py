"""Replicated CRDT table engine (reference src/table/).

A Table stores CRDT entries keyed by (partition key, sort key), replicated
to the nodes the cluster layout designates for hash(partition key):

  - writes CRDT-merge into local storage transactionally and fan out with
    try_write_many_sets (quorum in every active layout version)
  - reads are quorum reads with CRDT merge of the replies + background
    read-repair of stale nodes
  - convergence without coordination: a per-partition Merkle trie is
    maintained incrementally and anti-entropy syncs diverging subtrees
  - tombstones are garbage-collected with the 3-phase protocol (replicate
    tombstone everywhere, then delete-if-equal-hash) after a 24 h delay
"""

from .schema import TableSchema
from .table import Table

__all__ = ["Table", "TableSchema"]
