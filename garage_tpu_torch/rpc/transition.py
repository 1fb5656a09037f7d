"""Rebalance observatory: layout-transition flight deck + federated
cluster event timeline.

Garage's defining claim is that layout changes need no consensus: the
`LayoutHistory` CRDT (rpc/layout/history.py) converges by gossip while
reads and writes keep flowing against every active version.  This module
is the narration layer for that window.  While layout versions diverge,
a `TransitionTracker` on every node tracks per-partition migration state
(pending / moving / synced), bytes moved attributed to (source → dest)
node pairs, a rebalance-throughput EWMA with an ETA, and the CRDT
convergence lag — and each node gossips its ack'd/synced layout version
in the telemetry digest (`lt.*` keys), so ANY node can report the
cluster's version spread and per-node staleness.  On completion the
tracker emits a structured `transition-report` flight event: the
artifact the grow/drain chaos campaign gates on.

The federated event timeline rides the same plane: every node banks
`flight.record_event` events locally (utils/flight.py); the admin
fan-out here merges each node's recent events into one causally-ordered
timeline by correcting per-node wall clocks with the NTP-style offsets
the status exchange estimates (rpc/system.py).  Ordering is only as
good as those offsets — which is why `cluster_node_clock_skew_ms` is a
first-class federated family with a `SKEW!` flag in `cluster top`.
"""

from __future__ import annotations

import asyncio
import logging
import statistics
import time

from ..utils.data import hex_of
from ..utils.metrics import registry as default_registry

logger = logging.getLogger("garage.transition")

# EWMA smoothing for the per-peer clock offset (rpc/system.py feeds one
# sample per status exchange, i.e. every ~10 s: heavy smoothing would
# take minutes to converge after a step change)
OFFSET_ALPHA = 0.3
# EWMA smoothing for rebalance throughput / sync-fraction rate
RATE_ALPHA = 0.3
# retained sync-fraction samples per transition (the report decimates
# further; the cap bounds a week-long stalled transition's memory)
CURVE_MAX = 256
# sync-fraction samples are taken at most this often (digest collection
# and admin polling both drive _sample; they must not double-count rate)
SAMPLE_MIN_INTERVAL = 1.0
# flight events retained per node for the federated timeline
EVENTS_MAX = 256

SEVERITIES = ("info", "warn", "critical")


def severity_rank(sev) -> int:
    """info=0 < warn=1 < critical=2; unknown strings rank as info."""
    try:
        return SEVERITIES.index(sev)
    except ValueError:
        return 0


def estimate_offset(t0: float, t_peer: float, t3: float) -> tuple[float, float]:
    """One-exchange NTP-style clock offset estimate.

    `t0`/`t3` are the local wall clock just before/after the RPC;
    `t_peer` is the peer's wall clock while handling it.  Assuming the
    network path is symmetric the peer stamped its clock at the local
    midpoint, so `offset = t_peer - (t0 + t3) / 2` (positive = the
    peer's clock runs AHEAD of ours).  Returns (offset, rtt) in
    seconds; the asymmetry error is bounded by rtt/2, which is why
    callers EWMA across exchanges instead of trusting one sample.
    """
    rtt = max(0.0, t3 - t0)
    return t_peer - (t0 + t3) / 2.0, rtt


def merge_timeline(per_node) -> list[dict]:
    """Merge per-node event lists into one skew-corrected timeline.

    `per_node` is a list of `(node_hex16, offset_secs, events)` where
    `offset_secs` is the querying node's estimate of that peer's clock
    offset (None for self/unknown → 0).  Each event's wall-clock
    `start` is mapped onto the querying node's clock
    (`t_local = t_peer - offset`), then the union is sorted by the
    corrected time.  Causal order is only guaranteed down to the
    residual skew — which the output carries per-event (`skewMs`) so a
    reader can see how much to trust a close ordering.
    """
    out = []
    for node, offset, events in per_node:
        off = float(offset or 0.0)
        for ev in events:
            try:
                start = float(ev.get("start"))
            except (TypeError, ValueError):
                continue
            out.append(
                {
                    "node": node,
                    "time": start - off,
                    "rawTime": start,
                    "skewMs": round(off * 1000.0, 3),
                    "name": ev.get("name"),
                    "severity": ev.get("severity", "info"),
                    "attrs": ev.get("attrs") or {},
                }
            )
    out.sort(key=lambda e: (e["time"], e["node"], e["name"] or ""))
    return out


def local_events(recorder, since: float = 0.0, min_severity: str = "info",
                 limit: int = EVENTS_MAX) -> list[dict]:
    """This node's banked flight events strictly newer than `since`
    (the node's OWN wall clock — callers skew-correct afterwards),
    at or above `min_severity`.  The event bank is the recorder's
    dedicated `events` ring, not the slow-request ring: a burst of slow
    requests must not evict the durability alert an operator is
    grepping for."""
    if recorder is None:
        return []
    floor = severity_rank(min_severity)
    evs = []
    for rec in list(getattr(recorder, "events", ())):
        if rec.get("start", 0.0) <= since:
            continue
        if severity_rank(rec.get("severity", "info")) < floor:
            continue
        evs.append(
            {
                "name": rec.get("name"),
                "start": rec.get("start"),
                "severity": rec.get("severity", "info"),
                "attrs": rec.get("attrs") or {},
            }
        )
    return evs[-limit:]


def _decimate(curve: list, keep: int = 64) -> list:
    """Thin a sync-fraction curve for the transition report (keep the
    endpoints; stride the middle)."""
    if len(curve) <= keep:
        return [list(p) for p in curve]
    step = (len(curve) - 1) / (keep - 1)
    idx = sorted({round(i * step) for i in range(keep)} | {len(curve) - 1})
    return [list(curve[i]) for i in idx]


class TransitionTracker:
    """Narrates one layout transition end to end on this node.

    Subscribes to the LayoutManager so it sees every CRDT merge: a
    transition OPENS when a second version with a ring assignment
    appears, and CLOSES when trim() retires the old one (back to a
    single active version) — at which point a `transition-report`
    flight event is emitted and kept as `last_report`.  While open,
    the block plane attributes every migrated byte to a (src → dst)
    pair via `note_transfer`, and `_sample()` (driven by digest
    collection / admin polling, rate-limited) maintains the
    sync-fraction curve, the throughput EWMA and the ETA.
    """

    def __init__(self, garage, registry=None):
        self.garage = garage
        self.registry = registry if registry is not None else default_registry
        self.clock = time.monotonic
        self.active = False
        self.from_version: int | None = None
        self.target_version: int | None = None
        self._open_mono: float | None = None
        self._open_wall: float | None = None
        # (src_hex16, dst_hex16) -> bytes moved during this transition
        self.pair_bytes: dict[tuple[str, str], int] = {}
        self.bytes_total = 0
        # partitions some migrated byte was attributed to ("moving")
        self.partitions_touched: set[int] = set()
        self.curve: list[tuple[float, float]] = []  # (elapsed_s, frac)
        self._thr_ewma: float | None = None  # bytes/s
        self._frac_rate: float | None = None  # sync fraction / s
        self._last_sample: tuple[float, float, int] | None = None
        self._max_burn = 0.0
        self._canary_failed = False
        self.last_report: dict | None = None
        self.reports = 0
        garage.layout_manager.subscribe(self._on_layout_change)
        self._on_layout_change()

    # --- layout-change state machine -----------------------------------------

    def _active_versions(self) -> int:
        h = self.garage.layout_manager.history
        return sum(1 for v in h.versions if v.ring_assignment)

    def _on_layout_change(self) -> None:
        # MUST stay cheap and synchronous: LayoutManager._notify runs on
        # the event loop for every CRDT delta during a transition.
        h = self.garage.layout_manager.history
        n_active = self._active_versions()
        if n_active >= 2 and not self.active:
            self._open(h)
        elif self.active and n_active <= 1:
            self._close()
        elif self.active:
            # a second apply landed mid-transition: retarget, keep the
            # accounting (the report spans the whole divergence window)
            self.target_version = h.current().version

    def _open(self, h) -> None:
        self.active = True
        active = [v for v in h.versions if v.ring_assignment]
        self.from_version = active[0].version
        self.target_version = h.current().version
        self._open_mono = self.clock()
        self._open_wall = time.time()
        self.pair_bytes = {}
        self.bytes_total = 0
        self.partitions_touched = set()
        self.curve = []
        self._thr_ewma = None
        self._frac_rate = None
        self._last_sample = None
        self._max_burn = 0.0
        self._canary_failed = False
        logger.info(
            "layout transition opened: v%s -> v%s",
            self.from_version, self.target_version,
        )

    def _close(self) -> None:
        from ..utils import flight

        self._sample(force=True)
        duration = self.clock() - (self._open_mono or self.clock())
        pairs = [
            {"src": s, "dst": d, "bytes": b}
            for (s, d), b in sorted(
                self.pair_bytes.items(), key=lambda kv: -kv[1]
            )
        ]
        report = {
            "version": self.target_version,
            "fromVersion": self.from_version,
            "openedAt": self._open_wall,
            "durationSecs": round(duration, 3),
            "bytesMoved": self.bytes_total,
            "pairs": pairs,
            "partitionsTouched": len(self.partitions_touched),
            "syncCurve": _decimate(self.curve),
            "sloBurnMax": round(self._max_burn, 3),
            "canaryOk": not self._canary_failed,
        }
        self.last_report = report
        self.reports += 1
        self.active = False
        severity = "warn" if (self._canary_failed or self._max_burn > 1.0) \
            else "info"
        import json as _json

        attrs = {
            k: (_json.dumps(v) if isinstance(v, (list, dict)) else v)
            for k, v in report.items()
        }
        try:
            flight.record_event("transition-report", attrs, severity=severity)
        # graft-lint: allow-swallow(the report is kept as last_report either way)
        except Exception:  # noqa: BLE001 — narration must not break layout
            logger.exception("transition-report event emission failed")
        logger.info(
            "layout transition closed: v%s in %.1fs, %d bytes moved",
            self.target_version, duration, self.bytes_total,
        )

    # --- byte attribution (block plane hooks) --------------------------------

    def note_transfer(self, src: bytes, dst: bytes, nbytes: int,
                      partition: int | None = None) -> None:
        """Attribute `nbytes` migrated from `src` to `dst`.  No-op
        outside a transition: steady-state fetches (reads, repair) are
        not rebalance traffic."""
        if not self.active or nbytes <= 0:
            return
        key = (hex_of(src)[:16], hex_of(dst)[:16])
        self.pair_bytes[key] = self.pair_bytes.get(key, 0) + int(nbytes)
        self.bytes_total += int(nbytes)
        if partition is not None:
            self.partitions_touched.add(int(partition))
        self.registry.incr(
            "layout_transition_pair_bytes_total",
            (("src", key[0]), ("dst", key[1])),
            by=int(nbytes),
        )

    # --- sampling ------------------------------------------------------------

    def sync_fraction(self) -> float:
        from ..block.durability import layout_transition

        return float(
            layout_transition(self.garage.layout_manager.history)["progress"]
        )

    def partition_states(self) -> dict:
        """Per-partition migration state counts under the newest
        version: `synced` (every assigned node's sync tracker covers
        it), `moving` (not synced, but bytes were attributed to it),
        `pending` (the rest)."""
        h = self.garage.layout_manager.history
        cur = h.current()
        if not cur.ring_assignment:
            return {"total": 0, "synced": 0, "moving": 0, "pending": 0}
        total = len(cur.ring_assignment)
        synced = moving = 0
        for p in range(total):
            nodes = cur.nodes_of_partition(p)
            if nodes and all(h.sync.get(n) >= cur.version for n in nodes):
                synced += 1
            elif p in self.partitions_touched:
                moving += 1
        return {
            "total": total,
            "synced": synced,
            "moving": moving,
            "pending": total - synced - moving,
        }

    def _sample(self, force: bool = False) -> None:
        if not self.active:
            return
        now = self.clock()
        if (
            not force
            and self._last_sample is not None
            and now - self._last_sample[0] < SAMPLE_MIN_INTERVAL
        ):
            return
        frac = self.sync_fraction()
        elapsed = now - (self._open_mono or now)
        if self._last_sample is not None:
            dt = now - self._last_sample[0]
            if dt > 0:
                thr = (self.bytes_total - self._last_sample[2]) / dt
                self._thr_ewma = (
                    thr if self._thr_ewma is None
                    else RATE_ALPHA * thr + (1 - RATE_ALPHA) * self._thr_ewma
                )
                fr = (frac - self._last_sample[1]) / dt
                if fr > 0:
                    self._frac_rate = (
                        fr if self._frac_rate is None
                        else RATE_ALPHA * fr
                        + (1 - RATE_ALPHA) * self._frac_rate
                    )
        self._last_sample = (now, frac, self.bytes_total)
        if len(self.curve) < CURVE_MAX and (
            not self.curve or frac != self.curve[-1][1] or force
        ):
            self.curve.append((round(elapsed, 2), frac))
        self._sample_slo()

    def _sample_slo(self) -> None:
        """SLO burn + canary verdicts DURING the window: 'did the
        rebalance hurt clients' is the question the report answers."""
        g = self.garage
        slo = getattr(g, "slo_tracker", None)
        if slo is not None:
            try:
                c = slo.compute()
                burn = max(
                    (float(o.get("burn_rate", 0.0)) for o in c.values()),
                    default=0.0,
                )
                self._max_burn = max(self._max_burn, burn)
            # graft-lint: allow-swallow(SLO sampling is an optional report enrichment)
            except Exception:  # noqa: BLE001
                logger.debug("slo sampling during transition failed",
                             exc_info=True)
        canary = getattr(g, "canary", None)
        if canary is not None and getattr(canary, "healthy", None) == 0.0:
            self._canary_failed = True

    # --- derived views -------------------------------------------------------

    def eta_secs(self) -> float | None:
        """Seconds until sync fraction 1.0 at the EWMA'd rate; None
        when idle or the rate hasn't established."""
        if not self.active or not self._frac_rate or self._last_sample is None:
            return None
        remaining = max(0.0, 1.0 - self._last_sample[1])
        if remaining == 0.0:
            return 0.0
        return round(remaining / self._frac_rate, 1)

    def clock_skew_secs(self) -> float | None:
        """This node's wall-clock skew vs the cluster: the median of
        the per-peer offsets the status exchange estimated (median, not
        mean — one peer with a broken clock must not smear everyone's
        skew estimate).  Positive = peers run ahead of us."""
        offs = [
            o["offset"]
            for o in getattr(self.garage.system, "clock_offsets", {}).values()
        ]
        if not offs:
            return None
        return statistics.median(offs)

    def digest_fields(self) -> dict:
        """The `lt` telemetry-digest section (gossiped to every peer in
        NodeStatus).  Keys are additive under DIGEST_VERSION 1; peers
        treat unknown/missing keys as absent."""
        g = self.garage
        h = g.layout_manager.history
        me = g.system.id
        self._sample()
        d = {
            "v": h.current().version,
            "ack": h.ack.get(me),
            "sync": h.sync.get(me),
            "act": self._active_versions(),
            "frac": round(self.sync_fraction(), 4),
            "rep": self.reports,
        }
        sk = self.clock_skew_secs()
        if sk is not None:
            d["sk"] = round(sk * 1000.0, 3)
        if self.active:
            d["mvb"] = self.bytes_total
            d["els"] = round(self.clock() - (self._open_mono or 0.0), 1)
            if self._thr_ewma is not None:
                d["thr"] = round(self._thr_ewma, 1)
            eta = self.eta_secs()
            if eta is not None:
                d["eta"] = eta
        return d

    def snapshot(self) -> dict:
        """This node's full local view (one shape for admin HTTP, admin
        RPC and the CLI — the one-serialization rule)."""
        self._sample()
        h = self.garage.layout_manager.history
        sk = self.clock_skew_secs()
        offsets = {}
        now = self.clock()
        for pid, o in getattr(
            self.garage.system, "clock_offsets", {}
        ).items():
            offsets[hex_of(pid)[:16]] = {
                "offsetMs": round(o["offset"] * 1000.0, 3),
                "rttMs": round(o["rtt"] * 1000.0, 3),
                "ageSecs": round(now - o["at"], 1),
            }
        return {
            "inTransition": self.active,
            "version": h.current().version,
            "fromVersion": self.from_version if self.active else None,
            "activeVersions": self._active_versions(),
            "syncFraction": round(self.sync_fraction(), 4),
            "partitions": self.partition_states(),
            "bytesMoved": self.bytes_total if self.active else 0,
            "pairs": [
                {"src": s, "dst": d, "bytes": b}
                for (s, d), b in sorted(
                    self.pair_bytes.items(), key=lambda kv: -kv[1]
                )
            ] if self.active else [],
            "throughputBytesPerSec": (
                round(self._thr_ewma, 1)
                if self.active and self._thr_ewma is not None
                else None
            ),
            "etaSecs": self.eta_secs(),
            "elapsedSecs": (
                round(self.clock() - (self._open_mono or 0.0), 1)
                if self.active
                else None
            ),
            "syncCurve": [list(p) for p in self.curve],
            "maxSloBurn": round(self._max_burn, 3),
            "canaryOk": not self._canary_failed,
            "lastReport": self.last_report,
            "clockSkewMs": round(sk * 1000.0, 3) if sk is not None else None,
            "clockOffsets": offsets,
        }


# --- federated responses (one serialization for HTTP/RPC/CLI) ----------------


def transition_response(garage) -> dict:
    """Local transition detail + every node's gossiped `lt` digest +
    the cluster aggregate (version spread, stale nodes, worst skew)."""
    from .telemetry_digest import _dig, _node_rows

    tt = getattr(garage, "transition_tracker", None)
    rows = _node_rows(garage.system)
    nodes = []
    acks, versions = [], []
    skew_worst = None
    for r in rows:
        lt = _dig(r, "lt")
        lt = lt if isinstance(lt, dict) else None
        nodes.append(
            {
                "id": r["id"],
                "isUp": r["isUp"],
                "isSelf": r.get("isSelf", False),
                "lt": lt,
            }
        )
        if lt:
            if isinstance(lt.get("ack"), (int, float)):
                acks.append(int(lt["ack"]))
            if isinstance(lt.get("v"), (int, float)):
                versions.append(int(lt["v"]))
            sk = lt.get("sk")
            if isinstance(sk, (int, float)) and (
                skew_worst is None or abs(sk) > abs(skew_worst)
            ):
                skew_worst = sk
    newest = max(versions) if versions else None
    spread = (newest - min(acks)) if versions and acks else 0
    stale = sorted(
        n["id"]
        for n in nodes
        if n["lt"]
        and newest is not None
        and isinstance(n["lt"].get("ack"), (int, float))
        and int(n["lt"]["ack"]) < newest
    )
    return {
        "node": hex_of(garage.system.id),
        "enabled": tt is not None,
        "local": tt.snapshot() if tt is not None else None,
        "cluster": {
            "nodes": nodes,
            "aggregate": {
                "newestVersion": newest,
                "versionSpread": spread,
                "staleNodes": stale,
                "clockSkewWorstMs": skew_worst,
                "clockSkewWarnMs": garage.config.admin.clock_skew_warn_msec,
                "nodesReporting": sum(1 for n in nodes if n["lt"]),
            },
        },
    }


async def cluster_events_response(
    garage, since: float = 0.0, min_severity: str = "info",
    timeout: float = 5.0,
) -> dict:
    """Fan out to every connected peer's event bank and merge the union
    with the local bank into one skew-corrected timeline.  A peer that
    fails/times out is reported in `nodesFailed`, never awaited past
    `timeout` — the timeline degrades to fewer nodes, not to an error."""
    sysd = garage.system
    me = hex_of(sysd.id)[:16]
    per_node = [
        (
            me,
            0.0,
            local_events(
                getattr(garage, "flight_recorder", None), since, min_severity
            ),
        )
    ]
    responded, failed = [me], []

    async def ask(pid):
        resp = await sysd.events_ep.call(
            pid,
            {"since": since, "sev": min_severity},
            timeout=timeout,
        )
        return resp.body

    peers = list(sysd.peering.connected_peers())
    results = await asyncio.gather(
        *[ask(pid) for pid in peers], return_exceptions=True
    )
    for pid, res in zip(peers, results):
        hexid = hex_of(pid)[:16]
        if isinstance(res, BaseException):
            logger.debug("event fan-out to %s failed: %r", hexid, res)
            failed.append(hexid)
            continue
        off = sysd.clock_offsets.get(pid, {}).get("offset", 0.0)
        per_node.append((hexid, off, res if isinstance(res, list) else []))
        responded.append(hexid)
    return {
        "node": hex_of(sysd.id),
        "since": since,
        "minSeverity": min_severity,
        "nodesResponding": sorted(responded),
        "nodesFailed": sorted(failed),
        "events": merge_timeline(per_node),
    }
