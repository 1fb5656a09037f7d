"""Cluster layout: roles, partition assignment, CRDT history + staging.

Reference src/rpc/layout/ — the heart of Garage's no-consensus design:
placement is a deterministic function of a CRDT-replicated layout, computed
with an optimal min-cost-flow assignment (doc/optimal_layout_report).
"""

from .types import NodeRole, ZoneRedundancy, PARTITION_BITS, N_PARTITIONS
from .version import LayoutVersion
from .history import LayoutHistory, LayoutStaging

__all__ = [
    "NodeRole",
    "ZoneRedundancy",
    "LayoutVersion",
    "LayoutHistory",
    "LayoutStaging",
    "PARTITION_BITS",
    "N_PARTITIONS",
]
