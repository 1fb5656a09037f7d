"""Full-mesh peering with ping-based failure detection.

Reference src/net/peering.rs:23-50: every node tries to keep a connection
to every known peer; pings every PING_INTERVAL, a peer is DOWN after
FAILED_PING_THRESHOLD consecutive misses; peer lists are exchanged so the
mesh closes transitively.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass, field

from ..utils.aio import spawn_supervised
from ..utils.backoff import expo, jittered
from .message import PRIO_HIGH, Req, Resp
from .netapp import NetApp

logger = logging.getLogger("garage.peering")

PING_INTERVAL = 15.0
# a peer whose circuit breaker is not closed gets pinged at this much
# faster cadence: RPC traffic to it is being fast-failed, so these pings
# are the only probe that notices the peer healing — at 15 s, a healed
# peer could be fast-failed for up to 15 extra seconds while every
# sync/queue worker sinks deeper into its error backoff
SICK_PING_INTERVAL = 2.0
FAILED_PING_THRESHOLD = 4
PING_TIMEOUT = 10.0
CONNECT_RETRY_BASE = 1.0
CONNECT_RETRY_MAX = 60.0


@dataclass
class PeerInfo:
    id: bytes
    addr: tuple[str, int] | None = None
    state: str = "new"  # new | connecting | up | down
    last_seen: float = 0.0
    ping_rtt: float | None = None
    failed_pings: int = 0
    connect_failures: int = 0
    next_retry: float = 0.0
    rtts: list[float] = field(default_factory=list)
    # at most ONE ping in flight per peer: the sick-peer cadence (2 s) is
    # shorter than PING_TIMEOUT (10 s), so without this guard a dark peer
    # would accumulate ~5 concurrent hanging pings whose STALE failures
    # land after the peer heals and re-open its circuit breaker
    ping_inflight: bool = False


class PeeringManager:
    def __init__(
        self,
        netapp: NetApp,
        bootstrap: list[tuple[bytes, tuple[str, int]]],
        public_addr: tuple[str, int] | None = None,
    ):
        self.netapp = netapp
        # the address advertised to peers: a 0.0.0.0/:: bind address is not
        # dialable, so deployments must set rpc_public_addr (reference
        # config.rs rpc_public_addr); defaults to the bind address, which
        # is fine for loopback dev clusters and tests
        self.public_addr = public_addr
        # per-instance override of the module default (reference
        # config.rs rpc_ping_timeout_msec -> system.rs:269)
        self.ping_timeout = PING_TIMEOUT
        self.peers: dict[bytes, PeerInfo] = {}
        for pid, addr in bootstrap:
            if pid != netapp.id:
                self.peers[pid] = PeerInfo(id=pid, addr=addr)
        # optional rpc/peer_health.PeerHealth: ping outcomes feed the
        # same breaker/EWMA state the RpcHelper uses (wired by the
        # composition root); pings bypass the breaker on purpose — they
        # are the background probe that detects healing
        self.health = None
        self.ping_ep = netapp.endpoint("net/ping")
        self.ping_ep.set_handler(self._handle_ping)
        self.peerlist_ep = netapp.endpoint("net/peer_list")
        self.peerlist_ep.set_handler(self._handle_peer_list)
        netapp.on_connected = self._on_connected
        netapp.on_disconnected = self._on_disconnected
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = spawn_supervised(self._loop(), name="peering-loop")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    # --- handlers ------------------------------------------------------------

    async def _handle_ping(self, from_id: bytes, req: Req) -> Resp:
        return Resp(req.body)  # echo nonce

    async def _handle_peer_list(self, from_id: bytes, req: Req) -> Resp:
        self._learn(req.body or [], from_id=from_id)
        return Resp(self._known_list())

    def _known_list(self) -> list:
        my_addr = self.public_addr or self.netapp.bind_addr or ("", 0)
        out = [[self.netapp.id, list(my_addr)]]
        for p in self.peers.values():
            if p.addr:
                out.append([p.id, list(p.addr)])
        return out

    def _learn(self, peer_list, from_id: bytes | None = None) -> None:
        """Merge a peer-list exchange.  `from_id` is the reporting peer:
        its OWN entry is authoritative for its address — a peer that
        crashed and restarted on a new port (redeploy; the jepsen
        crash/restart nemesis) used to be unreachable forever once the
        connections it had dialed died, because the stale address was
        never overwritten and every redial backed off against a dead
        port.  Third-party entries only fill unknown addresses (gossip
        re-propagating a stale address must not clobber a fresh
        authoritative one)."""
        for item in peer_list:
            pid, addr = bytes(item[0]), (item[1][0], int(item[1][1]))
            if pid == self.netapp.id:
                continue
            p = self.peers.get(pid)
            if p is None:
                self.peers[pid] = PeerInfo(id=pid, addr=addr)
            elif p.addr is None:
                p.addr = addr
            elif (
                pid == from_id
                and p.addr != addr
                # a node without rpc_public_addr self-reports its BIND
                # address, which may be a wildcard — never overwrite a
                # dialable address with an undialable one
                and addr[0] not in ("", "0.0.0.0", "::")
                and addr[1] != 0
            ):
                p.addr = addr
                # the old address's connect backoff is meaningless for
                # the new one: redial promptly
                p.connect_failures = 0
                p.next_retry = 0.0

    def _on_connected(self, pid: bytes, incoming: bool) -> None:
        info = self.peers.setdefault(pid, PeerInfo(id=pid))
        info.state = "up"
        info.last_seen = time.monotonic()
        info.failed_pings = 0
        info.connect_failures = 0

    def _on_disconnected(self, pid: bytes) -> None:
        if pid in self.peers:
            self.peers[pid].state = "down"

    # --- main loop -----------------------------------------------------------

    async def _loop(self) -> None:
        while True:
            try:
                await self._tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                logger.warning("peering tick error: %r", e)
            await asyncio.sleep(1.0)

    async def _tick(self) -> None:
        now = time.monotonic()
        for p in list(self.peers.values()):
            if self.netapp.is_connected(p.id):
                interval = PING_INTERVAL
                if (
                    self.health is not None
                    and self.health.state_of(p.id) != "closed"
                ):
                    interval = SICK_PING_INTERVAL
                if now - p.last_seen >= interval:
                    # supervised: a crashed ping task must be logged, not
                    # silently dropped with the peer stuck "up" forever
                    spawn_supervised(
                        self._ping(p), name=f"ping-{p.id.hex()[:8]}"
                    )
            elif p.addr and now >= p.next_retry:
                p.state = "connecting"
                spawn_supervised(
                    self._try_connect(p), name=f"connect-{p.id.hex()[:8]}"
                )

    async def _ping(self, p: PeerInfo) -> None:
        if p.ping_inflight:
            return
        p.ping_inflight = True
        p.last_seen = time.monotonic()  # reset the cadence clock
        nonce = random.getrandbits(63)
        t0 = time.monotonic()
        try:
            resp = await self.ping_ep.call(
                p.id, nonce, prio=PRIO_HIGH, timeout=self.ping_timeout
            )
            if resp.body != nonce:
                raise ValueError("ping nonce mismatch")
            p.ping_rtt = time.monotonic() - t0
            p.rtts = (p.rtts + [p.ping_rtt])[-16:]
            p.failed_pings = 0
            p.state = "up"
            if self.health is not None:
                self.health.record_success(p.id, p.ping_rtt)
            # piggyback peer-list exchange on successful pings
            resp = await self.peerlist_ep.call(
                p.id, self._known_list(), prio=PRIO_HIGH,
                timeout=self.ping_timeout,
            )
            self._learn(resp.body or [], from_id=p.id)
        except Exception:  # noqa: BLE001
            p.failed_pings += 1
            if self.health is not None:
                self.health.record_failure(p.id)
            if p.failed_pings >= FAILED_PING_THRESHOLD:
                p.state = "down"
                conn = self.netapp.conns.get(p.id)
                if conn:
                    await conn.close()
        finally:
            p.ping_inflight = False

    async def _try_connect(self, p: PeerInfo) -> None:
        try:
            await self.netapp.connect(p.addr, p.id)
        except Exception as e:  # noqa: BLE001
            p.connect_failures += 1
            p.state = "down"
            delay = jittered(
                expo(p.connect_failures, CONNECT_RETRY_BASE, CONNECT_RETRY_MAX)
            )
            p.next_retry = time.monotonic() + delay
            logger.debug("connect to %s failed: %r", p.id.hex()[:8], e)

    # --- introspection --------------------------------------------------------

    def peer_avg_rtt(self, pid: bytes) -> float | None:
        p = self.peers.get(pid)
        if p and p.rtts:
            return sum(p.rtts) / len(p.rtts)
        return None

    def connected_peers(self) -> list[bytes]:
        return [pid for pid in self.peers if self.netapp.is_connected(pid)]

    def peer_states(self) -> dict[bytes, str]:
        return {
            pid: ("up" if self.netapp.is_connected(pid) else p.state)
            for pid, p in self.peers.items()
        }
