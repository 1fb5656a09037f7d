"""One layout version: node roles + optimal partition assignment.

Reference src/rpc/layout/version.rs:305 (`calculate_partition_assignment`):
dichotomy on the partition size × a flow problem, then move-cost
minimization against the previous layout; invariant checker `check()`
(version.rs:177-249).  Flow network shape (version.rs:536-598):

    source --rf--> partition --(rf-z+1)--> (partition, zone) --1--> node
    node --floor(capacity/partition_size)--> sink

A full flow (256 * rf) exists iff every partition can place rf replicas in
>= z distinct zones without exceeding any node's capacity quota.  The
dichotomy finds the largest partition size with a full flow (= maximize
usable capacity); the min-cost pass then prefers keeping a partition's
replicas where the previous layout had them (cost 0) over moving (cost 1).
"""

from __future__ import annotations

import logging
from typing import Any

from ...utils.data import hex_of
from .graph_algo import FlowGraph
from .types import N_PARTITIONS, NodeRole, ZoneRedundancy, partition_of

logger = logging.getLogger("garage.layout")


class LayoutError(Exception):
    pass


class LayoutVersion:
    def __init__(
        self,
        version: int,
        replication_factor: int,
        zone_redundancy=ZoneRedundancy.MAXIMUM,
        roles: dict[bytes, NodeRole] | None = None,
    ):
        self.version = version
        self.replication_factor = replication_factor
        self.zone_redundancy = zone_redundancy
        self.roles: dict[bytes, NodeRole] = roles or {}
        # computed by compute_assignment:
        self.node_id_vec: list[bytes] = []
        self.ring_assignment: list[list[int]] = []  # per partition: rf node idxs
        self.partition_size: int = 0

    # --- queries -------------------------------------------------------------

    def storage_nodes(self) -> list[bytes]:
        return sorted(
            nid for nid, role in self.roles.items() if role.capacity is not None
        )

    def all_nodes(self) -> list[bytes]:
        return sorted(self.roles.keys())

    def nodes_of(self, hash32: bytes) -> list[bytes]:
        """The rf nodes storing this hash (reference version.rs:117-130)."""
        p = partition_of(hash32)
        return self.nodes_of_partition(p)

    def nodes_of_partition(self, p: int) -> list[bytes]:
        if not self.ring_assignment:
            return []
        return [self.node_id_vec[i] for i in self.ring_assignment[p]]

    def effective_zone_redundancy(self) -> int:
        zones = {r.zone for r in self.roles.values() if r.capacity is not None}
        if self.zone_redundancy == ZoneRedundancy.MAXIMUM:
            return min(self.replication_factor, max(1, len(zones)))
        z = int(self.zone_redundancy)
        if z > self.replication_factor:
            raise LayoutError("zone_redundancy cannot exceed replication_factor")
        return z

    # --- assignment ----------------------------------------------------------

    def compute_assignment(self, prev: "LayoutVersion | None" = None) -> list[str]:
        """Compute ring_assignment; returns a human-readable change report.

        Deterministic: same roles + same previous layout => same result on
        every node (required: each node computes placement independently).
        """
        rf = self.replication_factor
        storage = self.storage_nodes()
        if len(storage) < rf:
            raise LayoutError(
                f"not enough storage nodes: {len(storage)} < replication_factor {rf}"
            )
        z = self.effective_zone_redundancy()
        zones = sorted({self.roles[n].zone for n in storage})
        if len(zones) < z:
            raise LayoutError(
                f"not enough zones: {len(zones)} < zone_redundancy {z}"
            )

        # node ordering: storage nodes first (stable hex order), gateways after
        self.node_id_vec = storage + [
            n for n in self.all_nodes() if n not in set(storage)
        ]
        caps = [self.roles[n].capacity for n in storage]

        prev_sets: list[set[int]] = [set() for _ in range(N_PARTITIONS)]
        if prev is not None and prev.ring_assignment:
            idx_of = {n: i for i, n in enumerate(storage)}
            for p in range(N_PARTITIONS):
                for nid in prev.nodes_of_partition(p):
                    if nid in idx_of:
                        prev_sets[p].add(idx_of[nid])

        # dichotomy on partition size: find the largest size with full flow.
        # upper bound: full flow needs sum(floor(cap_i/size)) >= 256*rf
        lo, hi = 1, max(1, sum(caps) // (N_PARTITIONS * rf))
        best = 0
        while lo <= hi:
            mid = (lo + hi) // 2
            if self._feasible(storage, zones, caps, z, mid):
                best = mid
                lo = mid + 1
            else:
                hi = mid - 1
        if best == 0:
            raise LayoutError("cluster capacity too small to place all partitions")
        self.partition_size = best

        # per-node partition-count targets, proportional to capacity inside
        # the zone structure (the balance criterion), then a min-cost flow
        # that meets the targets exactly while minimizing replica moves
        # (the reference achieves the same two-level objective with cycle
        # cancelling, version.rs:642)
        targets = self._balanced_targets(storage, zones, caps, z, best)
        g, part_zone_edges = self._build_graph(
            storage, zones, caps, z, best, prev_sets, sink_caps=targets
        )
        flow, cost = g.min_cost_max_flow(0, 1)
        if flow != N_PARTITIONS * rf:
            # integer rounding of targets can (rarely) be infeasible against
            # the per-partition zone constraints: fall back to plain quotas
            logger.warning("target-constrained flow infeasible; using quotas")
            g, part_zone_edges = self._build_graph(
                storage, zones, caps, z, best, prev_sets
            )
            flow, cost = g.min_cost_max_flow(0, 1)
        if flow != N_PARTITIONS * rf:
            raise LayoutError("internal error: final flow not full")

        self.ring_assignment = [[] for _ in range(N_PARTITIONS)]
        for (p, _zi, ni), eid in part_zone_edges.items():
            if g.flow_on(eid) > 0:
                self.ring_assignment[p].append(ni)
        for p in range(N_PARTITIONS):
            # deterministic replica order: previous nodes first, then by index
            self.ring_assignment[p].sort(
                key=lambda ni: (0 if ni in prev_sets[p] else 1, ni)
            )
            if len(self.ring_assignment[p]) != rf:
                raise LayoutError(f"partition {p} got {len(self.ring_assignment[p])} replicas")

        moved = sum(
            len(set(self.ring_assignment[p]) - prev_sets[p])
            for p in range(N_PARTITIONS)
            if prev_sets[p]
        )
        report = [
            f"partition size: {self.partition_size} bytes",
            f"usable capacity per node: "
            + ", ".join(
                f"{hex_of(n)[:8]}={self._n_partitions_of(i)}p"
                for i, n in enumerate(storage)
            ),
            f"replica moves vs previous layout: {moved} (cost {cost})",
        ]
        return report

    def _n_partitions_of(self, node_idx: int) -> int:
        return sum(1 for a in self.ring_assignment if node_idx in a)

    def _graph_vertices(self, storage, zones):
        # 0 = source, 1 = sink, partitions 2..2+256,
        # (partition, zone) pairs, then nodes
        base_pz = 2 + N_PARTITIONS
        n_pz = N_PARTITIONS * len(zones)
        base_nodes = base_pz + n_pz
        n_vertices = base_nodes + len(storage)
        return base_pz, base_nodes, n_vertices

    def _build_graph(self, storage, zones, caps, z, psize, prev_sets, sink_caps=None):
        rf = self.replication_factor
        zone_idx = {zn: i for i, zn in enumerate(zones)}
        base_pz, base_nodes, n_v = self._graph_vertices(storage, zones)
        g = FlowGraph(n_v)
        for p in range(N_PARTITIONS):
            g.add_edge(0, 2 + p, rf)
        part_zone_edges: dict[tuple[int, int, int], int] = {}
        for p in range(N_PARTITIONS):
            for zi in range(len(zones)):
                g.add_edge(2 + p, base_pz + p * len(zones) + zi, rf - z + 1)
        for ni, n in enumerate(storage):
            zi = zone_idx[self.roles[n].zone]
            for p in range(N_PARTITIONS):
                cost = 0 if ni in prev_sets[p] else 1
                eid = g.add_edge(
                    base_pz + p * len(zones) + zi, base_nodes + ni, 1, cost
                )
                part_zone_edges[(p, zi, ni)] = eid
            quota = caps[ni] // psize if sink_caps is None else sink_caps[ni]
            g.add_edge(base_nodes + ni, 1, quota)
        return g, part_zone_edges

    def _balanced_targets(self, storage, zones, caps, z, psize) -> list[int]:
        """Per-node partition-count targets: allocate the 256*rf replica
        slots to zones proportionally to zone capacity (bounded by the
        per-partition zone cap rf-z+1 and zone quota), then within each
        zone to nodes proportionally to capacity (bounded by quota and the
        one-replica-per-partition limit)."""
        rf = self.replication_factor
        total = N_PARTITIONS * rf
        quotas = [min(caps[i] // psize, N_PARTITIONS) for i in range(len(storage))]
        zone_nodes: dict[str, list[int]] = {}
        for i, n in enumerate(storage):
            zone_nodes.setdefault(self.roles[n].zone, []).append(i)
        zone_caps = {zn: sum(caps[i] for i in idxs) for zn, idxs in zone_nodes.items()}
        zone_uppers = {
            zn: min(N_PARTITIONS * (rf - z + 1), sum(quotas[i] for i in idxs))
            for zn, idxs in zone_nodes.items()
        }
        zone_alloc = _proportional_allocation(
            total,
            [zone_caps[zn] for zn in zones],
            [zone_uppers[zn] for zn in zones],
        )
        targets = [0] * len(storage)
        for zi, zn in enumerate(zones):
            idxs = zone_nodes[zn]
            alloc = _proportional_allocation(
                zone_alloc[zi],
                [caps[i] for i in idxs],
                [quotas[i] for i in idxs],
            )
            for j, i in enumerate(idxs):
                targets[i] = alloc[j]
        return targets

    def _feasible(self, storage, zones, caps, z, psize) -> bool:
        g, _ = self._build_graph(storage, zones, caps, z, psize, [set()] * N_PARTITIONS)
        return g.max_flow(0, 1) == N_PARTITIONS * self.replication_factor



    # --- invariants (reference version.rs:177-249) ---------------------------

    def check(self) -> None:
        rf = self.replication_factor
        storage = self.storage_nodes()
        n_storage = len(storage)
        assert len(self.ring_assignment) == N_PARTITIONS, "wrong partition count"
        z = self.effective_zone_redundancy()
        for p, nodes in enumerate(self.ring_assignment):
            assert len(nodes) == rf, f"partition {p}: {len(nodes)} != rf"
            assert len(set(nodes)) == rf, f"partition {p}: duplicate replicas"
            assert all(0 <= i < n_storage for i in nodes), (
                f"partition {p}: gateway or unknown node assigned"
            )
            pzones = {self.roles[self.node_id_vec[i]].zone for i in nodes}
            assert len(pzones) >= z, f"partition {p}: zone redundancy violated"
        # capacity quota: no node holds more partitions than its capacity allows
        for i, n in enumerate(storage):
            quota = self.roles[n].capacity // self.partition_size
            held = self._n_partitions_of(i)
            assert held <= quota, f"node {hex_of(n)[:8]} over quota: {held} > {quota}"

    # --- serialization -------------------------------------------------------

    def to_obj(self) -> Any:
        return {
            "version": self.version,
            "rf": self.replication_factor,
            "zr": ZoneRedundancy.to_obj(self.zone_redundancy),
            "roles": [[n, r.to_obj()] for n, r in sorted(self.roles.items())],
            "node_id_vec": list(self.node_id_vec),
            "ring": [list(a) for a in self.ring_assignment],
            "psize": self.partition_size,
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "LayoutVersion":
        lv = cls(
            version=obj["version"],
            replication_factor=obj["rf"],
            zone_redundancy=ZoneRedundancy.from_obj(obj["zr"]),
            roles={bytes(n): NodeRole.from_obj(r) for n, r in obj["roles"]},
        )
        lv.node_id_vec = [bytes(n) for n in obj["node_id_vec"]]
        lv.ring_assignment = [list(a) for a in obj["ring"]]
        lv.partition_size = obj["psize"]
        return lv


def _proportional_allocation(
    total: int, weights: list[int], uppers: list[int]
) -> list[int]:
    """Integer allocation of `total` units proportional to `weights`,
    clipped at `uppers` with water-filling redistribution; largest-remainder
    rounding, ties broken by index (deterministic on all nodes)."""
    n = len(weights)
    alloc = [0] * n
    active = [i for i in range(n) if uppers[i] > 0]
    remaining = total
    while remaining > 0 and active:
        wsum = sum(weights[i] for i in active)
        if wsum == 0:
            # no capacity weights left: spread evenly
            shares = {i: remaining / len(active) for i in active}
        else:
            shares = {i: remaining * weights[i] / wsum for i in active}
        clipped = [i for i in active if alloc[i] + shares[i] >= uppers[i]]
        if clipped:
            for i in clipped:
                remaining -= uppers[i] - alloc[i]
                alloc[i] = uppers[i]
            active = [i for i in active if i not in set(clipped)]
            continue
        # no clipping: integer-round shares by largest remainder
        floors = {i: int(shares[i]) for i in active}
        rem = remaining - sum(floors.values())
        order = sorted(active, key=lambda i: (-(shares[i] - floors[i]), i))
        for i in active:
            alloc[i] += floors[i]
        for i in order[:rem]:
            alloc[i] += 1
        remaining = 0
    if remaining > 0:
        raise LayoutError("proportional allocation infeasible (bounds too tight)")
    return alloc
