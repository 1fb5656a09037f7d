"""System: cluster membership, status gossip, health.

Reference src/rpc/system.rs:87-179: persists the peer list, exchanges
`NodeStatus` (hostname, version, layout digest, disk space) with all
connected peers every STATUS_EXCHANGE_INTERVAL, runs a discovery loop over
bootstrap peers, pulls/advertises cluster layouts when digests differ, and
computes `ClusterHealth` from per-partition quorum availability.
"""

from __future__ import annotations

import asyncio
import logging
import shutil
import socket
import time
from dataclasses import dataclass, field
from typing import Any

from ..net.message import PRIO_HIGH, Req, Resp
from ..utils.background import spawn
from ..utils.data import blake2sum
from ..utils.serde import pack
from ..net.netapp import NetApp
from ..net.peering import PeeringManager
from ..utils.migrate import Migratable
from ..utils.persister import Persister
from .layout.manager import LayoutManager
from .layout.types import N_PARTITIONS
from .replication_mode import ReplicationMode
from .transition import OFFSET_ALPHA, estimate_offset

logger = logging.getLogger("garage.system")

STATUS_EXCHANGE_INTERVAL = 10.0
DISCOVERY_INTERVAL = 60.0
ADVERTISE_COALESCE = 0.2  # burst-coalescing window for layout gossip
# node_status entries older than this are aged out (a dead peer stops
# refreshing; keeping it forever made the rollup and `garage status`
# show departed nodes as current indefinitely)
NODE_STATUS_EXPIRY = 6 * STATUS_EXCHANGE_INTERVAL


@dataclass
class NodeStatus:
    hostname: str
    version: str
    layout_digest: bytes
    meta_disk_avail: tuple[int, int] | None = None  # (free, total)
    data_disk_avail: tuple[int, int] | None = None
    replication_factor: int = 1
    # cluster telemetry plane (rpc/telemetry_digest.py): the sender's
    # pre-aggregated telemetry digest, piggybacked on the status
    # exchange.  None from peers running a version without the field.
    telemetry: Any = None

    def to_obj(self) -> Any:
        obj = {
            "h": self.hostname,
            "v": self.version,
            "ld": self.layout_digest,
            "md": list(self.meta_disk_avail) if self.meta_disk_avail else None,
            "dd": list(self.data_disk_avail) if self.data_disk_avail else None,
            "rf": self.replication_factor,
        }
        if self.telemetry is not None:
            obj["tm"] = self.telemetry
        return obj

    @classmethod
    def from_obj(cls, obj: Any) -> "NodeStatus":
        return cls(
            hostname=obj["h"],
            version=obj["v"],
            layout_digest=bytes(obj["ld"]),
            meta_disk_avail=tuple(obj["md"]) if obj.get("md") else None,
            data_disk_avail=tuple(obj["dd"]) if obj.get("dd") else None,
            replication_factor=obj.get("rf", 1),
            telemetry=obj.get("tm"),  # tolerant: old peers don't send it
        )


@dataclass
class ClusterHealth:
    status: str  # healthy | degraded | unavailable
    known_nodes: int = 0
    connected_nodes: int = 0
    storage_nodes: int = 0
    storage_nodes_up: int = 0
    partitions: int = N_PARTITIONS
    partitions_quorum: int = 0
    partitions_all_ok: int = 0
    # MAD-flagged sick nodes (rpc/telemetry_digest.py detect_outliers);
    # empty when fewer than 3 nodes report digests
    outlier_nodes: list[str] = field(default_factory=list)


class PersistedPeers(Migratable):
    VERSION_MARKER = b"GT0peers"

    def __init__(self, peers: list[tuple[bytes, tuple[str, int]]]):
        self.peers = peers

    def to_obj(self) -> Any:
        return [[p, list(a)] for p, a in self.peers]

    @classmethod
    def from_obj(cls, obj: Any) -> "PersistedPeers":
        return cls([(bytes(p), (a[0], int(a[1]))) for p, a in obj])


class System:
    """Composition of NetApp + PeeringManager + LayoutManager + gossip."""

    def __init__(
        self,
        netapp: NetApp,
        layout_manager: LayoutManager,
        replication_mode: ReplicationMode,
        bootstrap: list[tuple[bytes, tuple[str, int]]] | None = None,
        # the annotation doubles as the analyzer's receiver-type source:
        # `self.peer_persister.save` resolves into Persister
        peer_persister: Persister | None = None,
        metadata_dir: str | None = None,
        data_dirs: list[str] | None = None,
        public_addr: tuple[str, int] | None = None,
        discovery: list | None = None,
    ):
        self.netapp = netapp
        self.id = netapp.id
        self.layout_manager = layout_manager
        self.replication_mode = replication_mode
        self.peer_persister = peer_persister
        self.metadata_dir = metadata_dir
        self.data_dirs = data_dirs or []
        # external publishers (Consul/Kubernetes, rpc/discovery.py)
        self.discovery = discovery or []
        self.public_addr = public_addr
        persisted = peer_persister.load() if peer_persister else None
        known = list(bootstrap or [])
        if persisted:
            known.extend(persisted.peers)
        self.peering = PeeringManager(netapp, known, public_addr=public_addr)
        self.node_status: dict[bytes, tuple[NodeStatus, float]] = {}
        # cluster telemetry plane: model/garage.py points this at its
        # DigestCollector.collect so every outgoing NodeStatus carries
        # the local digest (None = no collector, e.g. bare System tests)
        self.telemetry_collector = None
        # rebalance observatory (rpc/transition.py): model/garage.py
        # points these at its TransitionTracker / flight-event bank
        self.transition_tracker = None
        self.events_collector = None
        # NTP-style per-peer clock offsets estimated from the status
        # exchange: peer id -> {"offset": s, "rtt": s, "at": monotonic}
        self.clock_offsets: dict[bytes, dict] = {}
        self.wallclock = time.time  # injectable for skew tests
        self.status_expiry = NODE_STATUS_EXPIRY
        self._tasks: list[asyncio.Task] = []
        # coalesced layout gossip state (see _advertise_loop)
        self._adv_event = asyncio.Event()
        self._adv_sem = asyncio.Semaphore(8)
        self._advertised: dict[bytes, bytes] = {}  # peer -> last digest sent
        self._adv_inflight: set[bytes] = set()
        self._adv_latest: bytes | None = None  # last wave's snapshot digest

        self.status_ep = netapp.endpoint("rpc/system/status")
        self.status_ep.set_handler(self._handle_status)
        self.pull_layout_ep = netapp.endpoint("rpc/system/pull_layout")
        self.pull_layout_ep.set_handler(self._handle_pull_layout)
        self.adv_layout_ep = netapp.endpoint("rpc/system/advertise_layout")
        self.adv_layout_ep.set_handler(self._handle_advertise_layout)
        self.events_ep = netapp.endpoint("rpc/system/events")
        self.events_ep.set_handler(self._handle_events)
        layout_manager.subscribe(self._on_layout_change)

    # --- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self.peering.start()
        self._tasks.append(asyncio.create_task(self._status_loop()))
        self._tasks.append(asyncio.create_task(self._discovery_loop()))
        self._tasks.append(asyncio.create_task(self._advertise_loop()))

    async def stop(self) -> None:
        from ..utils.aio import reap

        await reap(self._tasks, log=logger, what="system loop")
        for d in self.discovery:
            try:
                await d.close()
            except Exception as e:  # noqa: BLE001
                logger.debug(
                    "discovery %s close failed: %r", type(d).__name__, e
                )
        await self.peering.stop()

    # --- status --------------------------------------------------------------

    def local_status(self) -> NodeStatus:
        def disk(path):
            try:
                u = shutil.disk_usage(path)
                return (u.free, u.total)
            except OSError:
                return None

        telemetry = None
        if self.telemetry_collector is not None:
            try:
                telemetry = self.telemetry_collector()
            except Exception:  # noqa: BLE001 — status gossip must survive
                logger.exception("telemetry digest collection failed")
        return NodeStatus(
            hostname=socket.gethostname(),
            version="garage-tpu/0.1.0",
            layout_digest=self.layout_manager.digest(),
            meta_disk_avail=disk(self.metadata_dir) if self.metadata_dir else None,
            data_disk_avail=disk(self.data_dirs[0]) if self.data_dirs else None,
            replication_factor=self.replication_mode.replication_factor,
            telemetry=telemetry,
        )

    async def _handle_status(self, from_id: bytes, req: Req) -> Resp:
        st = NodeStatus.from_obj(req.body)
        self._record_status(from_id, st)
        # the reply carries a fresh wall-clock stamp for the caller's
        # NTP-style offset estimate (rpc/transition.py estimate_offset)
        return Resp({**self.local_status().to_obj(), "ts": self.wallclock()})

    def _note_peer_clock(
        self, pid: bytes, t0: float, t_peer: float, t3: float
    ) -> None:
        """EWMA one NTP-style offset sample for a peer (one sample per
        status exchange — the merged event timeline's ordering and the
        `SKEW!` flag both hang off this estimate)."""
        off, rtt = estimate_offset(t0, t_peer, t3)
        prev = self.clock_offsets.get(pid)
        if prev is not None:
            off = OFFSET_ALPHA * off + (1 - OFFSET_ALPHA) * prev["offset"]
            rtt = OFFSET_ALPHA * rtt + (1 - OFFSET_ALPHA) * prev["rtt"]
        self.clock_offsets[pid] = {
            "offset": off, "rtt": rtt, "at": time.monotonic()
        }

    async def _handle_events(self, from_id: bytes, req: Req) -> Resp:
        """Federated event timeline (rpc/transition.py): serve this
        node's banked flight events to a peer's admin fan-out."""
        body = req.body if isinstance(req.body, dict) else {}
        collector = self.events_collector
        if collector is None:
            return Resp([])
        return Resp(collector(
            since=float(body.get("since", 0.0) or 0.0),
            min_severity=str(body.get("sev", "info")),
        ))

    def _record_status(self, from_id: bytes, st: NodeStatus) -> None:
        self.node_status[from_id] = (st, time.monotonic())
        if st.layout_digest != self.layout_manager.digest():
            spawn(self._pull_layout_from(from_id))

    async def _pull_layout_from(self, node: bytes) -> None:
        try:
            resp = await self.pull_layout_ep.call(node, None, prio=PRIO_HIGH)
            if resp.body is not None:
                self.layout_manager.merge_remote(resp.body)
        except Exception as e:  # noqa: BLE001
            logger.debug("layout pull from %s failed: %r", node.hex()[:8], e)

    async def _handle_pull_layout(self, from_id: bytes, req: Req) -> Resp:
        return Resp(self.layout_manager.history.to_obj())

    async def _handle_advertise_layout(self, from_id: bytes, req: Req) -> Resp:
        self.layout_manager.merge_remote(req.body)
        return Resp(None)

    def _on_layout_change(self) -> None:
        # Coalesced gossip: mark dirty and let _advertise_loop push ONE
        # snapshot per burst.  Broadcasting on every CRDT delta is an
        # amplification bomb on a full mesh: each of n nodes' tracker
        # bumps re-triggers an n-peer broadcast on each of n nodes —
        # a 21-node layout apply was observed to pile up >13k concurrent
        # advertise tasks and starve the event loop for ~70 s.
        self._adv_event.set()

    async def _advertise_loop(self) -> None:
        """Push the layout to peers when it changed, one wave per burst.
        Per-peer digest suppression avoids re-sending a snapshot the peer
        was already sent; the status loop's digest-mismatch pull is the
        convergence backstop for lost adverts.  Waves never await their
        sends: a hung peer occupies one in-flight slot, it does not delay
        the next wave to the healthy peers."""
        while True:
            await self._adv_event.wait()
            await asyncio.sleep(ADVERTISE_COALESCE)
            self._adv_event.clear()
            try:
                obj = self.layout_manager.history.to_obj()
                # same bytes as layout_manager.digest() without packing
                # the history a second time (waves fire every 0.2 s
                # under tracker churn)
                digest = blake2sum(pack(obj))
                self._adv_latest = digest
                connected = set(self.peering.connected_peers())
                # drop suppression state for departed peers (a reconnecting
                # peer with an unchanged digest is covered by the status
                # loop's pull backstop)
                self._advertised = {
                    p: d for p, d in self._advertised.items() if p in connected
                }
                for p in connected:
                    if (
                        self._advertised.get(p) != digest
                        and p not in self._adv_inflight
                    ):
                        self._adv_inflight.add(p)
                        spawn(self._advertise_one(p, obj, digest))
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                logger.exception("advertise loop error")

    async def _advertise_one(self, pid: bytes, obj: Any, digest: bytes) -> None:
        try:
            async with self._adv_sem:  # bounded fan-out on wide meshes
                await self.adv_layout_ep.call(pid, obj, prio=PRIO_HIGH, timeout=10.0)
            self._advertised[pid] = digest
        except Exception as e:  # noqa: BLE001
            logger.debug("layout advertise to %s failed: %r", pid.hex()[:8], e)
        finally:
            self._adv_inflight.discard(pid)
            # the layout may have moved on while this send was in flight
            # (waves skip in-flight peers): retrigger so the peer gets
            # the newer snapshot
            if digest != self._adv_latest:
                self._adv_event.set()

    # --- loops ---------------------------------------------------------------

    async def status_exchange_once(self) -> None:
        """One status-gossip wave: push our NodeStatus (+ telemetry
        digest) to every connected peer, record theirs, age out entries
        from departed peers.  The status loop's body; tests drive it
        directly to converge a cluster without waiting out the
        exchange interval."""
        st = self.local_status().to_obj()

        async def exchange(pid):
            try:
                t0 = self.wallclock()
                resp = await self.status_ep.call(
                    pid, {**st, "ts": t0}, prio=PRIO_HIGH, timeout=10.0
                )
                t3 = self.wallclock()
                self._record_status(pid, NodeStatus.from_obj(resp.body))
                ts = (
                    resp.body.get("ts")
                    if isinstance(resp.body, dict) else None
                )
                if ts is not None:
                    self._note_peer_clock(pid, t0, float(ts), t3)
            except Exception as e:  # noqa: BLE001 — one dead peer must not
                # stall the wave, but the miss is worth a debug line
                logger.debug(
                    "status exchange with %s failed: %r", pid.hex()[:8], e
                )

        # concurrent fan-out: one hung peer must not delay the rest
        await asyncio.gather(
            *[exchange(pid) for pid in self.peering.connected_peers()]
        )
        self.expire_node_status()

    def expire_node_status(self) -> None:
        """Age out status entries no longer being refreshed.  A
        connected peer re-records every exchange; an entry that is BOTH
        stale and disconnected belongs to a departed node — dropping it
        removes the node from the telemetry rollup and from `garage
        status` hostnames.  (Digest rows are rendered inline from this
        map, never registered as per-node gauges, so there is nothing
        else to unregister.)"""
        now = time.monotonic()
        for pid in [
            p
            for p, (_st, ts) in self.node_status.items()
            if now - ts > self.status_expiry and not self.netapp.is_connected(p)
        ]:
            logger.info(
                "aging out status of departed node %s", pid.hex()[:8]
            )
            del self.node_status[pid]
            self.clock_offsets.pop(pid, None)

    async def _status_loop(self) -> None:
        while True:
            try:
                await self.status_exchange_once()
            except Exception:  # noqa: BLE001
                logger.exception("status loop error")
            await asyncio.sleep(STATUS_EXCHANGE_INTERVAL)

    async def _discovery_loop(self) -> None:
        while True:
            try:
                if self.peer_persister:
                    peers = [
                        (p.id, p.addr)
                        for p in self.peering.peers.values()
                        if p.addr is not None
                    ]
                    # off-loop: the peer-list fsync used to run on the
                    # event loop every discovery tick (loop-blocker,
                    # visible only since receiver-type resolution)
                    await self.peer_persister.save_in_thread(
                        PersistedPeers(peers)
                    )
                await self._external_discovery()
            except Exception:  # noqa: BLE001
                logger.exception("discovery loop error")
            await asyncio.sleep(DISCOVERY_INTERVAL)

    async def _external_discovery(self) -> None:
        """Publish this node to + learn peers from external publishers
        (reference system.rs discovery via consul.rs / kubernetes.rs)."""
        if not self.discovery:
            return
        my_addr = self.public_addr or self.netapp.bind_addr
        if my_addr is not None and my_addr[0] in ("0.0.0.0", "::", ""):
            # a wildcard bind address is meaningless to peers — publishing
            # it would make everyone dial themselves
            logger.warning(
                "discovery: rpc_public_addr not set and bind address is "
                "%s; not publishing this node", my_addr[0],
            )
            my_addr = None
        for d in self.discovery:
            try:
                if my_addr is not None:
                    await d.publish(self.id, my_addr)
                for node_id, addr in await d.get_nodes():
                    if node_id == self.id or self.netapp.is_connected(node_id):
                        continue
                    try:
                        await self.netapp.connect(addr, node_id)
                    except Exception as e:  # noqa: BLE001
                        logger.debug(
                            "discovered peer %s @ %s unreachable: %r",
                            node_id.hex()[:8], addr, e,
                        )
            except Exception as e:  # noqa: BLE001
                logger.warning("external discovery (%s) failed: %r",
                               type(d).__name__, e)

    # --- health --------------------------------------------------------------

    def health(self, outlier_nodes: list[str] | None = None) -> ClusterHealth:
        """`outlier_nodes`: pass a precomputed set (telemetry rollup /
        federated exposition already ran the MAD detector on the same
        rows) to avoid re-deriving it; None computes it here."""
        layout = self.layout_manager.history
        storage_nodes = layout.all_storage_nodes()
        up = {
            n
            for n in storage_nodes
            if n == self.id or self.netapp.is_connected(n)
        }
        quorum = self.replication_mode.write_quorum()
        n_quorum = n_all = 0
        cur = layout.current()
        if cur.ring_assignment:
            for p in range(N_PARTITIONS):
                nodes = set(cur.nodes_of_partition(p))
                # during migration a partition must be writable in every
                # active version's node set
                ok_all = all(
                    sum(1 for n in v.nodes_of_partition(p) if n in up) >= quorum
                    for v in layout.versions
                    if v.ring_assignment
                )
                if ok_all:
                    n_quorum += 1
                if nodes <= up:
                    n_all += 1
        status = "healthy"
        if cur.ring_assignment:
            if n_quorum < N_PARTITIONS:
                status = "unavailable"
            elif n_all < N_PARTITIONS or len(up) < len(storage_nodes):
                status = "degraded"
        known = self.peering.peers
        if outlier_nodes is None:
            from .telemetry_digest import outlier_node_ids

            outlier_nodes = outlier_node_ids(self)
        return ClusterHealth(
            status=status,
            known_nodes=len(known) + 1,
            connected_nodes=len(self.peering.connected_peers()) + 1,
            storage_nodes=len(storage_nodes),
            storage_nodes_up=len(up),
            partitions_quorum=n_quorum,
            partitions_all_ok=n_all,
            outlier_nodes=outlier_nodes,
        )
