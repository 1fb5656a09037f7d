"""Layout staging + multi-version history with CRDT update trackers.

Reference src/rpc/layout/history.rs + mod.rs v010: during a layout change,
several versions are simultaneously active — writes must reach a quorum in
EVERY active version's node set, reads use the newest version whose data
has been fully synced, and old versions are retired once every node has
acknowledged the sync.  All of it converges by CRDT merge (gossip), never
consensus.

Trackers (maps node -> version number, merged by per-node max):
  ack      node uses this version for its writes
  sync     node has locally finished syncing data into this version
  sync_ack node has seen that ALL nodes' sync >= this version
"""

from __future__ import annotations

from typing import Any

from ...utils.crdt import Lww, LwwMap
from ...utils.data import blake2sum
from ...utils.serde import pack
from .types import NodeRole, ZoneRedundancy
from .version import LayoutError, LayoutVersion


class UpdateTracker:
    def __init__(self, values: dict[bytes, int] | None = None):
        self.values: dict[bytes, int] = values or {}

    def set_max(self, node: bytes, v: int) -> bool:
        if self.values.get(node, -1) < v:
            self.values[node] = v
            return True
        return False

    def get(self, node: bytes) -> int:
        return self.values.get(node, 0)

    def min_among(self, nodes: list[bytes], default: int) -> int:
        if not nodes:
            return default
        return min(self.values.get(n, 0) for n in nodes)

    def merge(self, other: "UpdateTracker") -> None:
        for n, v in other.values.items():
            self.set_max(n, v)

    def to_obj(self) -> Any:
        return [[n, v] for n, v in sorted(self.values.items())]

    @classmethod
    def from_obj(cls, obj: Any) -> "UpdateTracker":
        return cls({bytes(n): int(v) for n, v in obj})


class LayoutStaging:
    """Staged role changes + parameters, merged CRDT-style across nodes
    before an explicit `apply` (reference mod.rs LayoutStaging)."""

    def __init__(self):
        self.roles: LwwMap = LwwMap()  # node_id -> role obj or None (remove)
        self.parameters: Lww = Lww.raw(0, {"zone_redundancy": ZoneRedundancy.MAXIMUM})

    def stage_role(self, node: bytes, role: NodeRole | None) -> None:
        self.roles.update_in_place(node, role.to_obj() if role else None)

    def merge(self, other: "LayoutStaging") -> None:
        self.roles.merge(other.roles)
        self.parameters.merge(other.parameters)

    def clear(self) -> None:
        self.roles = LwwMap()

    def to_obj(self) -> Any:
        return {"roles": self.roles.to_obj(), "params": self.parameters.to_obj()}

    @classmethod
    def from_obj(cls, obj: Any) -> "LayoutStaging":
        s = cls()
        s.roles = LwwMap.from_obj(obj["roles"])
        s.parameters = Lww.from_obj(obj["params"])
        return s


class LayoutHistory:
    def __init__(self, replication_factor: int):
        self.replication_factor = replication_factor
        self.versions: list[LayoutVersion] = []
        self.ack = UpdateTracker()
        self.sync = UpdateTracker()
        self.sync_ack = UpdateTracker()
        self.staging = LayoutStaging()

    @classmethod
    def initial(cls, replication_factor: int) -> "LayoutHistory":
        h = cls(replication_factor)
        v0 = LayoutVersion(0, replication_factor)
        h.versions = [v0]
        return h

    # --- queries -------------------------------------------------------------

    def current(self) -> LayoutVersion:
        return self.versions[-1]

    def min_stored(self) -> int:
        return self.versions[0].version

    def all_nodes(self) -> list[bytes]:
        nodes: set[bytes] = set()
        for v in self.versions:
            nodes.update(v.all_nodes())
        return sorted(nodes)

    def all_storage_nodes(self) -> list[bytes]:
        nodes: set[bytes] = set()
        for v in self.versions:
            nodes.update(v.storage_nodes())
        return sorted(nodes)

    def read_version(self) -> LayoutVersion:
        """Newest version whose data every storage node has synced
        (reads are safe there); falls back to the oldest active version."""
        for v in reversed(self.versions):
            nodes = v.storage_nodes()
            if self.sync.min_among(nodes, default=v.version) >= v.version:
                return v
        return self.versions[0]

    def read_nodes_of(self, hash32: bytes) -> list[bytes]:
        return self.read_version().nodes_of(hash32)

    def write_sets_of(self, hash32: bytes) -> list[list[bytes]]:
        """One node-set per active version: a write must reach quorum in
        EACH set (reference rpc_helper try_write_many_sets +
        parameters.rs:20-24)."""
        return [v.nodes_of(hash32) for v in self.versions if v.ring_assignment]

    def digest(self) -> bytes:
        return blake2sum(pack(self.to_obj()))

    def placement_digest(self) -> bytes:
        """Digest of the placement-relevant state only: layout versions
        and their ring assignments — NOT the update trackers.  Tracker
        gossip advances constantly during normal operation; anti-entropy
        consumers key off this digest so tracker-only updates don't
        retrigger full sync rounds (each one is ~512 root-compare RPCs
        per table)."""
        return blake2sum(
            pack([
                [v.version, v.node_id_vec, v.ring_assignment]
                for v in self.versions
            ])
        )

    def staging_digest(self) -> bytes:
        return blake2sum(pack(self.staging.to_obj()))

    # --- mutations ------------------------------------------------------------

    def merge(self, other: "LayoutHistory") -> bool:
        """CRDT merge; returns True if anything changed."""
        before = pack(self.to_obj())
        by_ver = {v.version: v for v in self.versions}
        for v in other.versions:
            if v.version not in by_ver:
                by_ver[v.version] = v
        # keep only versions >= the newest min_stored of the two histories
        min_keep = max(self.min_stored(), other.min_stored()) if self.versions and other.versions else 0
        self.versions = [by_ver[k] for k in sorted(by_ver) if k >= min_keep]
        self.ack.merge(other.ack)
        self.sync.merge(other.sync)
        self.sync_ack.merge(other.sync_ack)
        self.staging.merge(other.staging)
        return pack(self.to_obj()) != before

    def apply_staged_changes(self, version: int | None = None) -> tuple["LayoutVersion", list[str]]:
        """Compute the next layout version from current roles + staged
        changes (reference version.rs:281-305 calculate_next_version)."""
        cur = self.current()
        new_roles: dict[bytes, NodeRole] = dict(cur.roles)
        for node, role_obj in self.staging.roles.items():
            if role_obj is None:
                new_roles.pop(bytes(node), None)
            else:
                new_roles[bytes(node)] = NodeRole.from_obj(role_obj)
        params = self.staging.parameters.get()
        next_ver = cur.version + 1
        if version is not None and version != next_ver:
            raise LayoutError(
                f"version mismatch: expected {next_ver} (got {version}); "
                "layout changed concurrently, re-stage and retry"
            )
        lv = LayoutVersion(
            next_ver,
            self.replication_factor,
            params.get("zone_redundancy", ZoneRedundancy.MAXIMUM),
            new_roles,
        )
        report = lv.compute_assignment(cur if cur.ring_assignment else None)
        self.versions.append(lv)
        self.staging.clear()
        self.trim()
        return lv, report

    def revert_staged_changes(self) -> None:
        self.staging.clear()

    # --- tracker updates (called by the local node) ---------------------------

    def update_trackers_of(self, node: bytes) -> None:
        """Advance this node's ack tracker to the newest version, compute
        sync_ack, and retire fully-synced old versions."""
        latest = self.current().version
        self.ack.set_max(node, latest)
        # sync_ack: this node has observed that everyone synced up to v
        all_nodes = self.all_storage_nodes()
        min_sync = self.sync.min_among(all_nodes, default=latest)
        self.sync_ack.set_max(node, min_sync)
        self.trim()

    def mark_synced(self, node: bytes, version: int | None = None) -> None:
        self.sync.set_max(node, version if version is not None else self.current().version)

    def trim(self) -> None:
        """Retire old versions once every node's sync_ack has passed them.
        The bootstrap version (no ring assignment, stores nothing) is
        dropped as soon as a real version exists."""
        while len(self.versions) > 1 and not self.versions[0].ring_assignment:
            self.versions.pop(0)
        while len(self.versions) > 1:
            next_v = self.versions[1].version
            nodes = self.all_storage_nodes()
            if self.sync_ack.min_among(nodes, default=0) >= next_v:
                self.versions.pop(0)
            else:
                break

    # --- serialization --------------------------------------------------------

    def to_obj(self) -> Any:
        return {
            "rf": self.replication_factor,
            "versions": [v.to_obj() for v in self.versions],
            "ack": self.ack.to_obj(),
            "sync": self.sync.to_obj(),
            "sync_ack": self.sync_ack.to_obj(),
            "staging": self.staging.to_obj(),
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "LayoutHistory":
        h = cls(obj["rf"])
        h.versions = [LayoutVersion.from_obj(v) for v in obj["versions"]]
        h.ack = UpdateTracker.from_obj(obj["ack"])
        h.sync = UpdateTracker.from_obj(obj["sync"])
        h.sync_ack = UpdateTracker.from_obj(obj["sync_ack"])
        h.staging = LayoutStaging.from_obj(obj["staging"])
        return h
