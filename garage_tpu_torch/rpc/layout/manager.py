"""LayoutManager: owns the replicated LayoutHistory, persists it, gossips
it, and notifies subscribers on change.

Reference src/rpc/layout/manager.rs:21-120: layouts propagate via
SystemRpc::{Pull,Advertise}ClusterLayout; merging is pure CRDT so any
gossip order converges.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

from ...utils.migrate import Migratable
from .history import LayoutHistory
from .types import NodeRole

logger = logging.getLogger("garage.layout")


class PersistedLayout(Migratable):
    VERSION_MARKER = b"GT0layout"

    def __init__(self, history: LayoutHistory):
        self.history = history

    def to_obj(self) -> Any:
        return self.history.to_obj()

    @classmethod
    def from_obj(cls, obj: Any) -> "PersistedLayout":
        return cls(LayoutHistory.from_obj(obj))


class LayoutManager:
    def __init__(self, node_id: bytes, replication_factor: int, persister=None):
        self.node_id = node_id
        self.persister = persister
        loaded = persister.load() if persister else None
        if loaded is not None:
            self.history = loaded.history
            if self.history.replication_factor != replication_factor:
                raise ValueError(
                    f"replication_factor changed from "
                    f"{self.history.replication_factor} to {replication_factor}; "
                    "this is not supported"
                )
        else:
            self.history = LayoutHistory.initial(replication_factor)
        # merge_remote/local_update are synchronous on the event loop, which
        # is what serializes them — no lock needed
        self.change_listeners: list[Callable[[], None]] = []
        # layout-sync coordination (reference src/rpc/layout/manager.rs:
        # each table syncer reports completed sync rounds; once EVERY
        # registered component has synced up to version v, this node's
        # sync tracker advances, which — gossiped and acked by the other
        # nodes — lets trim() retire old versions and read_version() move
        # forward).  name -> highest cleanly-synced layout version.
        self._sync_components: dict[str, int] = {}

    # --- local views ---------------------------------------------------------

    def digest(self) -> bytes:
        return self.history.digest()

    def save(self) -> None:
        if self.persister:
            self.persister.save(PersistedLayout(self.history))

    def subscribe(self, fn: Callable[[], None]) -> None:
        self.change_listeners.append(fn)

    def _notify(self) -> None:
        for fn in self.change_listeners:
            try:
                fn()
            except Exception:  # noqa: BLE001
                logger.exception("layout change listener failed")

    # --- merge / advertise ---------------------------------------------------

    def merge_remote(self, obj: Any) -> bool:
        """Merge a layout advertised by a peer; returns True if changed."""
        other = LayoutHistory.from_obj(obj)
        if other.replication_factor != self.history.replication_factor:
            logger.error(
                "peer advertises replication_factor %d != ours %d; ignoring",
                other.replication_factor,
                self.history.replication_factor,
            )
            return False
        changed = self.history.merge(other)
        if changed:
            self.history.update_trackers_of(self.node_id)
            self.save()
            self._notify()
        return changed

    def local_update(self, mutate: Callable[[LayoutHistory], Any]) -> Any:
        """Apply a local mutation (stage/apply/revert/tracker update),
        persist and notify."""
        res = mutate(self.history)
        self.history.update_trackers_of(self.node_id)
        self.save()
        self._notify()
        return res

    # --- convenience for the CLI/admin paths ---------------------------------

    def stage_role(self, node: bytes, role: NodeRole | None) -> None:
        self.local_update(lambda h: h.staging.stage_role(node, role))

    def apply_staged(self, version: int | None = None):
        return self.local_update(lambda h: h.apply_staged_changes(version))

    def revert_staged(self) -> None:
        self.local_update(lambda h: h.revert_staged_changes())

    def mark_synced(self, version: int | None = None) -> None:
        self.local_update(lambda h: h.mark_synced(self.node_id, version))

    # --- sync completion tracking --------------------------------------------

    def register_sync_component(self, name: str) -> None:
        """Declare a component whose sync completion gates layout-version
        retirement.  All components must be registered before workers
        start reporting (Garage wires every table before spawn)."""
        self._sync_components.setdefault(name, 0)

    def component_synced(self, name: str, version: int) -> None:
        """A component finished a CLEAN sync round that began at layout
        `version`; advance this node's sync tracker to the minimum across
        all components."""
        if self._sync_components.get(name, 0) >= version:
            return
        self._sync_components[name] = version
        v = min(self._sync_components.values())
        if v > self.history.sync.get(self.node_id):
            self.mark_synced(v)
