"""Per-peer health tracking + circuit breaker for the RPC layer.

The quorum machinery (rpc_helper.py) used to treat every peer as equally
healthy: a crashed node cost the full default timeout (up to 30 s) on
every call that touched it.  This module gives the RPC layer a memory:

  - per-peer EWMA of call success (1.0 = all succeeding) and of observed
    RTT, fed from every RpcHelper call outcome and from peering pings;
  - a circuit breaker per peer: CLOSED (normal) -> OPEN after
    `open_after` consecutive transport failures (calls fast-fail instead
    of burning a timeout) -> HALF_OPEN after `open_cooldown` seconds
    (a single probe call is let through) -> CLOSED on probe success,
    back to OPEN on probe failure;
  - adaptive per-peer timeouts derived from the RTT EWMA, so a call to a
    historically-1 ms peer fails in ~1 s, not 30.

Only TRANSPORT failures (timeout, connection loss, unreachable) feed the
breaker: a peer that answers with an application error (RemoteError) is
alive and counts as a transport success.

Observability: state transitions and fast-fails are counted in
utils/metrics (`rpc_breaker_transition_counter{peer,to}`,
`rpc_breaker_fastfail_counter{peer}`), the current state is exported as a
gauge (`rpc_peer_breaker_state{peer}`: 0=closed 1=half-open 2=open), and
`snapshot()` feeds the admin status endpoint.

Reference analog: none in the reference for the breaker itself (garage
relies on short rpc timeouts); the health-aware ordering extends
rpc_helper.rs:621's rtt ordering with liveness.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..utils.error import Error
from ..utils.metrics import registry

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class PeerUnavailable(Error):
    """Fast-fail: the peer's circuit breaker is open."""


@dataclass
class _Peer:
    state: str = CLOSED
    consecutive_failures: int = 0
    success_ewma: float = 1.0
    rtt_ewma: float | None = None
    opened_at: float = 0.0
    probe_inflight: bool = False
    transitions: int = 0
    successes: int = 0
    failures: int = 0
    # EC read attribution (rpc/traffic.py): per-peer piece_fetch
    # latency/bytes EWMAs feeding the slow-rank ranking item 1a's
    # hedged reads will key off.  Separate from rtt_ewma on purpose:
    # that one blends every RPC (pings, table ops); a slow DISK on a
    # peer shows up here and nowhere else.
    piece_fetches: int = 0
    piece_bytes: float = 0.0
    piece_lat_ewma: float | None = None
    piece_bytes_ewma: float | None = None


class PeerHealth:
    """Tracker + breaker state for all peers, from one node's viewpoint."""

    # breaker tuning (per-instance overridable; tests use small values).
    # The cooldown bounds how long a HEALED peer keeps being fast-failed:
    # after a real outage ends, nothing but a probe (or a background
    # ping) can close the breaker, and every fast-failed sync/queue
    # worker meanwhile sinks deeper into its own error backoff — a long
    # cooldown therefore extends the effective outage well past heal.
    # 5 s (the classic Hystrix default) keeps that extension small.
    open_after = 5  # consecutive transport failures before opening
    open_cooldown = 5.0  # seconds OPEN before letting a probe through
    ewma_alpha = 0.2  # weight of the newest sample
    sick_threshold = 0.5  # success EWMA below this = sick (ordering)

    # adaptive timeout: clamp(rtt_ewma * mult + slack, floor, default)
    timeout_rtt_mult = 8.0
    timeout_slack = 0.5  # seconds, covers handler work
    timeout_floor = 1.0  # never time out faster than this

    def __init__(self, our_id: bytes, clock=time.monotonic):
        self.our_id = our_id
        self.clock = clock
        self.peers: dict[bytes, _Peer] = {}

    def _peer(self, node: bytes) -> _Peer:
        p = self.peers.get(node)
        if p is None:
            p = self.peers[node] = _Peer()
        return p

    def _lbl(self, node: bytes) -> tuple:
        return (("peer", node.hex()[:16]),)

    def _transition(self, node: bytes, p: _Peer, to: str) -> None:
        if p.state == to:
            return
        p.state = to
        p.transitions += 1
        registry.incr(
            "rpc_breaker_transition_counter", self._lbl(node) + (("to", to),)
        )
        registry.set_gauge(
            "rpc_peer_breaker_state", self._lbl(node), _STATE_GAUGE[to]
        )

    # --- call gating ---------------------------------------------------------

    def acquire(self, node: bytes) -> bool:
        """Gate a call to `node`.  Raises PeerUnavailable (fast-fail) when
        the breaker is open; in half-open, admits a single probe and
        fast-fails the rest.  Returns True when THIS call claimed the
        half-open probe slot — only such calls may release() it."""
        if node == self.our_id:
            return False
        p = self._peer(node)
        if p.state == OPEN:
            if self.clock() - p.opened_at >= self.open_cooldown:
                self._transition(node, p, HALF_OPEN)
            else:
                registry.incr("rpc_breaker_fastfail_counter", self._lbl(node))
                raise PeerUnavailable(
                    f"peer {node.hex()[:16]} circuit open "
                    f"({p.consecutive_failures} consecutive failures)"
                )
        if p.state == HALF_OPEN:
            if p.probe_inflight:
                registry.incr("rpc_breaker_fastfail_counter", self._lbl(node))
                raise PeerUnavailable(
                    f"peer {node.hex()[:16]} half-open probe already in flight"
                )
            p.probe_inflight = True
            return True
        return False

    def release(self, node: bytes) -> None:
        """The probe call that CLAIMED the half-open slot (acquire
        returned True) ended without a success/failure verdict (e.g. it
        was cancelled): free the slot so the next probe can run.  Callers
        whose acquire returned False must not call this — they would free
        a slot someone else holds."""
        p = self.peers.get(node)
        if p is not None:
            p.probe_inflight = False

    # --- outcome feed --------------------------------------------------------

    def record_success(
        self, node: bytes, rtt: float | None = None, probe: bool = False
    ) -> None:
        """`probe`: this verdict comes from the call that claimed the
        half-open probe slot (acquire returned True)."""
        if node == self.our_id:
            return
        p = self._peer(node)
        p.consecutive_failures = 0
        p.successes += 1
        a = self.ewma_alpha
        p.success_ewma = (1 - a) * p.success_ewma + a
        if rtt is not None:
            p.rtt_ewma = (
                rtt if p.rtt_ewma is None else (1 - a) * p.rtt_ewma + a * rtt
            )
        if p.state != CLOSED:
            # half-open probe succeeded, or late evidence of life while
            # open (e.g. a peering ping, which bypasses the breaker)
            self._transition(node, p, CLOSED)
            p.probe_inflight = False  # any probe slot is void once closed
        elif probe:
            p.probe_inflight = False

    def record_failure(
        self,
        node: bytes,
        timed_out_after: float | None = None,
        probe: bool = False,
    ) -> None:
        """`timed_out_after`: set when the failure was a TIMEOUT after
        that many seconds — widens the peer's adaptive-timeout window
        TCP-RTO-style (a timeout says the true response time is above
        the window we allowed; double it for the next try; successes
        shrink it back through the EWMA).  Without this, a load spike
        that pushes responses past the adaptive window is metastable:
        every call times out, the window never re-learns, the breaker
        flaps open forever.

        `probe`: this verdict comes from the call that claimed the
        half-open probe slot.  In HALF_OPEN only the probe's own failure
        re-opens (and frees the slot) — stale verdicts from calls that
        started before the outage, or a concurrently-failing ping, must
        not hijack a probe still in flight."""
        if node == self.our_id:
            return
        p = self._peer(node)
        if timed_out_after is not None:
            widened = 2.0 * timed_out_after / self.timeout_rtt_mult
            p.rtt_ewma = max(p.rtt_ewma or 0.0, widened)
        p.consecutive_failures += 1
        p.failures += 1
        p.success_ewma = (1 - self.ewma_alpha) * p.success_ewma
        if p.state == HALF_OPEN:
            if probe:
                p.probe_inflight = False
                p.opened_at = self.clock()
                self._transition(node, p, OPEN)
        elif p.state == CLOSED and p.consecutive_failures >= self.open_after:
            p.opened_at = self.clock()
            self._transition(node, p, OPEN)

    def record_piece_fetch(
        self, node: bytes, secs: float, nbytes: int
    ) -> None:
        """One successful remote EC piece fetch from `node` (fed by
        block/manager.py `_fetch_piece`).  Failures don't land here —
        they feed the breaker via record_failure; the ranking flags
        sick/open peers ahead of any latency number anyway."""
        if node == self.our_id:
            return
        p = self._peer(node)
        a = self.ewma_alpha
        p.piece_fetches += 1
        p.piece_bytes += nbytes
        p.piece_lat_ewma = (
            secs
            if p.piece_lat_ewma is None
            else (1 - a) * p.piece_lat_ewma + a * secs
        )
        p.piece_bytes_ewma = (
            float(nbytes)
            if p.piece_bytes_ewma is None
            else (1 - a) * p.piece_bytes_ewma + a * nbytes
        )

    def fetch_latency_estimate(self, node: bytes) -> float | None:
        """Best available latency estimate (seconds) for one remote
        piece/block fetch from `node`: the piece-fetch EWMA when this
        node has fetched from it before (it folds in the peer's DISK,
        not just its transport), else the all-RPC rtt EWMA, else None.
        The hedged-read delay (block/manager.py) seeds from this."""
        p = self.peers.get(node)
        if p is None:
            return None
        if p.piece_lat_ewma is not None:
            return p.piece_lat_ewma
        return p.rtt_ewma

    def piece_fetch_ranking(self) -> list[dict]:
        """Slowest-first per-peer read attribution: sick / breaker-open
        peers rank ahead of everything (they are the slowest a read can
        get), then by piece-fetch latency EWMA descending.  Peers with
        neither signal are omitted."""
        rows = []
        for node, p in self.peers.items():
            sick = self.is_sick(node)
            if p.piece_fetches == 0 and not sick:
                continue
            rows.append(
                {
                    "peer": node.hex(),
                    "state": p.state,
                    "sick": sick,
                    "pieceFetches": p.piece_fetches,
                    "pieceBytes": int(p.piece_bytes),
                    "latMsecEwma": (
                        round(p.piece_lat_ewma * 1000, 3)
                        if p.piece_lat_ewma is not None
                        else None
                    ),
                    "bytesEwma": (
                        round(p.piece_bytes_ewma, 1)
                        if p.piece_bytes_ewma is not None
                        else None
                    ),
                    "successEwma": round(p.success_ewma, 4),
                }
            )
        rows.sort(
            key=lambda r: (
                0 if r["sick"] else 1,
                -(r["latMsecEwma"] or 0.0),
                r["peer"],
            )
        )
        return rows

    # --- consumers -----------------------------------------------------------

    def state_of(self, node: bytes) -> str:
        p = self.peers.get(node)
        return p.state if p else CLOSED

    def is_sick(self, node: bytes) -> bool:
        """Known-bad peers to deprioritize in read ordering: breaker not
        closed, or success rate collapsed."""
        p = self.peers.get(node)
        if p is None:
            return False
        return p.state != CLOSED or p.success_ewma < self.sick_threshold

    def rtt_of(self, node: bytes) -> float | None:
        p = self.peers.get(node)
        return p.rtt_ewma if p else None

    def adaptive_timeout(self, node: bytes, default: float) -> float:
        """Per-peer call timeout from the RTT EWMA, clamped to
        [timeout_floor, default].  Without RTT history: the default."""
        p = self.peers.get(node)
        if p is None or p.rtt_ewma is None:
            return default
        t = p.rtt_ewma * self.timeout_rtt_mult + self.timeout_slack
        return min(default, max(self.timeout_floor, t))

    def snapshot(self) -> dict[str, dict]:
        """Per-peer health for the admin status endpoint."""
        out: dict[str, dict] = {}
        for node, p in self.peers.items():
            out[node.hex()] = {
                "state": p.state,
                "successEwma": round(p.success_ewma, 4),
                "rttMsecEwma": (
                    round(p.rtt_ewma * 1000, 3) if p.rtt_ewma is not None else None
                ),
                "consecutiveFailures": p.consecutive_failures,
                "successes": p.successes,
                "failures": p.failures,
                "transitions": p.transitions,
            }
        return out
