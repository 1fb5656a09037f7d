"""Quorum RPC strategies (reference src/rpc/rpc_helper.rs:128-533).

  call / call_many / broadcast — plain fan-out
  try_call_many — parallel calls until `quorum` successes; either
      all-at-once (writes) or preference-ordered staggered sends (reads:
      self > lowest observed rtt, reference rpc_helper.rs:621)
  try_write_many_sets — during layout transitions a write must reach a
      quorum in EVERY active layout version's node set; leftover requests
      keep running in the background so slow nodes still converge
      (reference rpc_helper.rs:432-533)

Every remote call is health-tracked (rpc/peer_health.py): a per-peer
circuit breaker fast-fails calls to known-dead peers, timeouts adapt to
the peer's observed RTT, idempotent calls retry with jittered backoff,
and request_order deprioritizes sick peers.  See
doc/fault-injection.md.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from ..net.connection import ConnectionClosed, RemoteError
from ..net.message import PRIO_NORMAL
from ..net.netapp import Endpoint
from ..utils.backoff import Backoff
from ..utils.background import spawn
from ..utils.error import Quorum
from ..utils.metrics import registry
from ..utils.tracing import NOOP_SPAN, tracer
from .peer_health import PeerHealth, PeerUnavailable

logger = logging.getLogger("garage.rpc")

STAGGER_DELAY = 0.2  # launch an extra request if no reply within this
RETRY_BASE = 0.05  # idempotent-call retry backoff (jittered-exponential)
RETRY_MAX = 2.0


def _quorum_fail(lbl: tuple, quorum: int, got: int, errors: list[str]):
    """Count + raise in one place so no Quorum path misses the metric."""
    registry.incr("rpc_quorum_error_counter", lbl)
    raise Quorum(quorum, got, errors)


def _is_transport_error(e: BaseException) -> bool:
    """Failures that say something about the PEER/LINK (feed the breaker,
    eligible for idempotent retry) vs application-level errors."""
    from ..net.netapp import RpcError

    return isinstance(
        e, (asyncio.TimeoutError, ConnectionClosed, OSError, RpcError)
    ) and not isinstance(e, RemoteError)


class RpcHelper:
    def __init__(
        self,
        our_id: bytes,
        peering,
        default_timeout: float = 30.0,
        health: PeerHealth | None = None,
    ):
        self.our_id = our_id
        self.peering = peering
        self.default_timeout = default_timeout
        # per-peer health/breaker state; the composition root shares one
        # instance with the peering layer so ping outcomes feed it too
        self.health = health or PeerHealth(our_id)
        # node_id -> zone name (or None), wired by the composition root
        # from the current cluster layout; used by request_order
        self.zone_of = None

    # --- ordering ------------------------------------------------------------

    def request_order(self, nodes: list[bytes]) -> list[bytes]:
        """Self first, then same-zone nodes, then by ascending observed
        ping rtt (reference rpc_helper.rs:621-648: "priorize ourself, then
        nodes in the same zone, and within a same zone ... lowest
        latency").  Known-sick peers (open breaker / collapsed success
        rate) sort after every healthy one regardless of zone or rtt, so
        staggered reads don't spend their first quorum slots on nodes
        that will fast-fail or stall.  Zone lookup comes from
        `self.zone_of` (wired to the cluster layout by the composition
        root); without it the order degrades to self-then-rtt."""
        our_zone = self.zone_of(self.our_id) if self.zone_of else None

        def key(n: bytes):
            if n == self.our_id:
                return (0, 0, 0, 0.0, n)
            sick = 1 if self.health.is_sick(n) else 0
            other_zone = (
                1 if our_zone is None or self.zone_of(n) != our_zone else 0
            )
            # one RTT view for ordering AND adaptive timeouts: the health
            # EWMA sees every RPC outcome plus pings; peering's ping-only
            # average is the cold-start fallback
            rtt = self.health.rtt_of(n)
            if rtt is None:
                rtt = self.peering.peer_avg_rtt(n)
            return (1, sick, other_zone, rtt if rtt is not None else 9.0, n)

        return sorted(nodes, key=key)

    # --- basic ---------------------------------------------------------------

    async def call(
        self,
        endpoint: Endpoint,
        node: bytes,
        msg: Any,
        prio: int = PRIO_NORMAL,
        timeout: float | None = None,
        stream_factory=None,
        idempotent: bool = False,
        max_attempts: int = 3,
        order_tag=None,
    ):
        """One health-tracked RPC.

        stream_factory() makes a FRESH attached byte stream per call —
        required because an async iterator can only be consumed once but a
        quorum write sends the same payload to several nodes (and a retry
        resends it).

        Breaker: calls to a peer whose circuit is open raise
        PeerUnavailable immediately instead of burning a timeout.  Unless
        the caller pinned `timeout`, the per-call timeout adapts to the
        peer's observed RTT (a historically-fast peer fails in ~1 s, not
        `default_timeout`).

        `idempotent=True` enables jittered-exponential retry (up to
        `max_attempts` total tries) on TRANSPORT failures only — reads
        and other at-least-once-safe calls; application errors
        (RemoteError) never retry."""
        backoff = Backoff(RETRY_BASE, RETRY_MAX)
        attempts = max(1, max_attempts) if idempotent else 1
        lbl = (("endpoint", endpoint.path),)
        last_exc: Exception | None = None
        for attempt in range(attempts):
            if attempt:
                registry.incr("rpc_retry_counter", lbl)
                await asyncio.sleep(backoff.next())
            # each attempt is its own child span (the retry story of a
            # request is visible in the trace: attempt number + what the
            # breaker thought of the peer when the attempt launched)
            cm = (
                tracer.span(
                    "rpc-attempt:" + endpoint.path,
                    attempt=attempt,
                    breaker=self.health.state_of(node),
                    to=node.hex()[:16],
                )
                if tracer.enabled
                else NOOP_SPAN
            )
            try:
                with cm:
                    return await self._call_once(
                        endpoint, node, msg, prio, timeout, stream_factory,
                        order_tag,
                    )
            except PeerUnavailable as e:
                # fast-fail is cheap; retrying it is pointless until the
                # breaker half-opens, which takes longer than our backoff
                raise e
            except (asyncio.TimeoutError, ConnectionClosed, OSError) as e:
                last_exc = e
            except Exception as e:  # noqa: BLE001
                if isinstance(e, RemoteError) or not _is_transport_error(e):
                    raise
                last_exc = e
        assert last_exc is not None
        raise last_exc

    async def _call_once(
        self, endpoint, node, msg, prio, timeout, stream_factory,
        order_tag=None,
    ):
        if node == self.our_id:
            # local shortcut: no transport involved, health not consulted
            return await endpoint.call(
                node, msg, prio=prio, timeout=timeout or self.default_timeout,
                stream=stream_factory() if stream_factory else None,
                order_tag=order_tag,
            )
        health = self.health
        # raises PeerUnavailable when the circuit is open; True = this
        # call owns the half-open probe slot and must release it if it
        # ends without a verdict
        is_probe = health.acquire(node)
        if timeout is not None:
            eff_timeout = timeout
        elif is_probe:
            # the half-open probe gets the full default timeout: it must
            # be able to CLOSE the breaker even when the adaptive window
            # has collapsed below the peer's current response time
            eff_timeout = self.default_timeout
        else:
            eff_timeout = health.adaptive_timeout(node, self.default_timeout)
        t0 = time.perf_counter()
        try:
            resp = await endpoint.call(
                node, msg, prio=prio, timeout=eff_timeout,
                stream=stream_factory() if stream_factory else None,
                order_tag=order_tag,
            )
        except RemoteError:
            # the peer answered (with an application error): transport is
            # healthy — feed the breaker a success, re-raise for the caller
            health.record_success(
                node, time.perf_counter() - t0, probe=is_probe
            )
            raise
        except asyncio.CancelledError:
            if is_probe:
                health.release(node)  # no verdict: free the probe slot
            raise
        except Exception as e:  # noqa: BLE001
            if isinstance(e, asyncio.TimeoutError):
                # widen the peer's adaptive window (TCP-RTO style)
                health.record_failure(
                    node, timed_out_after=eff_timeout, probe=is_probe
                )
            elif _is_transport_error(e):
                health.record_failure(node, probe=is_probe)
            elif is_probe:
                health.release(node)
            raise
        health.record_success(node, time.perf_counter() - t0, probe=is_probe)
        return resp

    async def call_many(
        self,
        endpoint: Endpoint,
        nodes: list[bytes],
        msg: Any,
        prio: int = PRIO_NORMAL,
        timeout: float | None = None,
    ) -> list[tuple[bytes, Any]]:
        """Call all nodes; returns [(node, Resp | Exception)]."""

        async def one(n):
            try:
                return (n, await self.call(endpoint, n, msg, prio, timeout))
            except Exception as e:  # noqa: BLE001
                return (n, e)

        return list(await asyncio.gather(*[one(n) for n in nodes]))

    async def broadcast(self, endpoint: Endpoint, msg: Any, prio=PRIO_NORMAL):
        nodes = [self.our_id] + list(self.peering.connected_peers())
        return await self.call_many(endpoint, nodes, msg, prio)

    # --- quorum reads/writes --------------------------------------------------

    async def try_call_many(
        self,
        endpoint: Endpoint,
        nodes: list[bytes],
        msg: Any,
        quorum: int,
        prio: int = PRIO_NORMAL,
        timeout: float | None = None,
        all_at_once: bool = True,
    ) -> list[Any]:
        """Returns the first `quorum` successful response bodies, or raises
        `Quorum`.  With all_at_once=False, requests are launched in
        preference order, staggering extras only when replies are slow —
        the read path optimization that keeps traffic off far nodes."""
        nodes = self.request_order(nodes)
        lbl = (("endpoint", endpoint.path),)
        if quorum > len(nodes):
            _quorum_fail(lbl, quorum, 0, [f"only {len(nodes)} candidate nodes"])
        # `timeout` stays None unless the caller pinned it, so each
        # per-node call gets its adaptive (RTT-derived) timeout

        results: list[Any] = []
        errors: list[str] = []
        pending: set[asyncio.Task] = set()
        next_idx = 0

        def launch(n: bytes):
            async def one():
                return await self.call(endpoint, n, msg, prio, timeout)

            t = asyncio.create_task(one())
            t.node = n  # type: ignore[attr-defined]
            pending.add(t)

        initial = len(nodes) if all_at_once else quorum
        for n in nodes[:initial]:
            launch(n)
        next_idx = initial

        try:
            while len(results) < quorum:
                if not pending:
                    _quorum_fail(lbl, quorum, len(results), errors)
                wait_timeout = None if all_at_once else STAGGER_DELAY
                done, _ = await asyncio.wait(
                    pending,
                    timeout=wait_timeout,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if not done and next_idx < len(nodes):
                    # slow: stagger one more request
                    registry.incr("rpc_stagger_launch_counter", lbl)
                    launch(nodes[next_idx])
                    next_idx += 1
                    continue
                for t in done:
                    pending.discard(t)
                    try:
                        results.append(t.result())
                    except Exception as e:  # noqa: BLE001
                        errors.append(f"{t.node.hex()[:8]}: {e!r}")  # type: ignore[attr-defined]
                        if next_idx < len(nodes):
                            launch(nodes[next_idx])
                            next_idx += 1
            return results[:quorum]
        finally:
            if pending:
                if all_at_once:
                    # write path: surplus requests keep running so slow
                    # replicas still receive the update (reference
                    # rpc_helper.rs non-interrupting strategy)
                    spawn(_drain(pending))
                else:
                    # read path: extra reads are pure cost, cancel them
                    for t in pending:
                        t.cancel()

    async def try_write_many_sets(
        self,
        endpoint: Endpoint,
        write_sets: list[list[bytes]],
        msg: Any,
        quorum: int,
        prio: int = PRIO_NORMAL,
        timeout: float | None = None,
        stream_factory=None,
    ) -> None:
        """Write to the union of all sets; success when EVERY set has
        `quorum` successes.  Remaining in-flight requests are left running
        in the background (they still deliver the write to slow nodes).

        Per-node calls are PINNED to the full timeout, not the adaptive
        RTT-derived one: writes carry whole payloads (block PUT streams),
        and the call only completes once the peer has ingested the entire
        stream — judging that by a ping-scale RTT window would abort
        slow-but-healthy writes and feed their failures to the breaker
        (the EC put path in block/manager.py pins its sends for the same
        reason).  Reads (try_call_many) keep adaptive timeouts: their
        responses are latency-bound, and a stuck read has cheap fallback
        nodes."""
        overall_timeout = timeout if timeout is not None else self.default_timeout
        lbl = (("endpoint", endpoint.path),)
        if not write_sets or all(not s for s in write_sets):
            _quorum_fail(lbl, quorum, 0, ["no write sets (layout has no nodes yet)"])
        all_nodes: list[bytes] = []
        for s in write_sets:
            for n in s:
                if n not in all_nodes:
                    all_nodes.append(n)
        # a write set smaller than the configured quorum can never deliver
        # the promised durability — fail loudly instead of silently
        # lowering the bar (reference rpc_helper.rs errors here too)
        for i, s in enumerate(write_sets):
            if len(s) < quorum:
                _quorum_fail(
                    lbl, quorum, 0,
                    [f"write set {i} has only {len(s)} nodes (< quorum {quorum})"],
                )
        set_success = [0] * len(write_sets)
        set_failed = [0] * len(write_sets)
        errors: list[str] = []
        done_ev = asyncio.Event()

        def sets_satisfied() -> bool:
            return all(s >= quorum for s in set_success)

        def sets_hopeless() -> bool:
            return any(
                len(write_sets[i]) - set_failed[i] < quorum
                for i in range(len(write_sets))
            )

        async def one(n: bytes):
            try:
                await self.call(
                    endpoint, n, msg, prio, overall_timeout,
                    stream_factory=stream_factory,
                )
                for i, s in enumerate(write_sets):
                    if n in s:
                        set_success[i] += 1
            except Exception as e:  # noqa: BLE001
                errors.append(f"{n.hex()[:8]}: {e!r}")
                for i, s in enumerate(write_sets):
                    if n in s:
                        set_failed[i] += 1
            if sets_satisfied() or sets_hopeless():
                done_ev.set()

        tasks = [asyncio.create_task(one(n)) for n in all_nodes]
        try:
            await asyncio.wait_for(done_ev.wait(), overall_timeout + 5.0)
        except asyncio.TimeoutError:
            pass
        if not sets_satisfied():
            for t in tasks:
                t.cancel()
            got = min(set_success) if set_success else 0
            _quorum_fail(lbl, quorum, got, errors)
        # leftover requests continue in the background
        leftover = [t for t in tasks if not t.done()]
        if leftover:
            spawn(_drain(leftover))


async def _drain(tasks):
    await asyncio.gather(*tasks, return_exceptions=True)
