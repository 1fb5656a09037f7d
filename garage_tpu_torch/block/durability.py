"""Durability observatory: the cluster-wide redundancy ledger.

Garage's durability story is redundancy without consensus — EC/replica
placement plus Merkle anti-entropy and the repair plane — yet nothing
could answer the operator's FIRST question: *how many blocks are one
failure away from loss, and when will repair catch up?*  The scrub and
repair planes each see their own backlog; the telemetry plane
gossips those backlogs; but no surface joins the block refs against the
layout and liveness state into redundancy CLASSES.  This module is that
join — the observability prerequisite for the layout-change-under-fire
campaign ("the telemetry plane narrating recovery").

A `DurabilityScanner` worker incrementally walks the local rc tree
(every block this node still references) in tranquilized batches and
classifies each OWNED block by how many of its stripe's pieces are
believed reachable:

  healthy     all k+m pieces on live ranks
  degraded    k < live < k+m    (urgency-bucketed high/low via
                                 repair_plan.classify)
  at_risk     live == k         (one more failure loses data)
  unreadable  live < k

Liveness is LOCAL evidence, not a survey: this node's own ranks are
checked on disk; a remote rank counts live iff its node is connected
and not behind an OPEN circuit breaker (rpc/peer_health.py).  The
resync error set adds the orthogonal "stuck" dimension (blocks that
keep failing to heal, by error age).  A connected peer that silently
lost its disk is NOT detected here — that is the scrub/repair-survey
planes' job (block/repair_plan.py `Inv` RPCs); the ledger is the
always-on cheap view, the survey is the expensive exact one.

OWNERSHIP makes cluster sums exact: a block is counted by the first
LIVE node of its stripe assignment (rank 0 at steady state; the next
live rank takes over when earlier holders die), so summing per-node
ledgers over the digest gossip yields cluster totals without
double-counting.  Min-redundancy federates as min-over-nodes.

From the same pass the scanner derives:

  zone-loss exposure   per layout zone Z: how many owned blocks would
                       drop below k pieces if zone Z vanished
  repair ETA           EWMA of observed backlog drain (missing pieces
                       per second, across passes) + the live
                       RepairPlanner's own throughput, vs the backlog
  layout transition    fraction of partitions whose current-version
                       replicas have all reported sync (the progress
                       bar for a migration in flight)

Surfaces: digest `dur.*` keys federated through the digest gossip
(`rpc/telemetry_digest.py`), admin `GET /v1/cluster/durability`,
admin-RPC `durability` -> `cli cluster durability`, registry gauges
`durability_*` (id-labelled, registered by model/garage.py), and a
flight-recorder slow-ring EVENT whenever a block transitions into
`at_risk`/`unreadable` (utils/flight.py record_event).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import time

from ..utils.background import Worker, WorkerState
from ..utils.time_util import now_msec
from ..utils.tranquilizer import Tranquilizer
from .repair_plan import (
    DEFAULT_PIECE_EST,
    URGENCY_HIGH,
    URGENCY_LOW,
    classify,
)

logger = logging.getLogger("garage.block.durability")

DUR_HEALTHY = "healthy"
DUR_DEGRADED = "degraded"
DUR_AT_RISK = "at_risk"
DUR_UNREADABLE = "unreadable"
DUR_CLASSES = (DUR_HEALTHY, DUR_DEGRADED, DUR_AT_RISK, DUR_UNREADABLE)

# EWMA smoothing for the drain-rate / piece-size estimates
RATE_ALPHA = 0.3
# cap on the at_risk/unreadable hash set kept for transition detection;
# past it, new transitions still alert (conservatively: every at-risk
# block looks "new") but memory stays bounded
ALERT_SET_MAX = 262_144
# at most this many local piece files are size-sampled per batch (the
# byte-backlog estimate needs a piece-size EWMA, not a census)
SIZE_SAMPLES_PER_BATCH = 8

# gauge `id` label source: process-unique (several in-process nodes
# share the global registry — utils/background.py _gauge_ids pattern)
_gauge_ids = itertools.count(1)


def classify_block(live: int, k: int, width: int) -> str:
    """Redundancy class of a stripe with `live` of `width` pieces
    reachable, k needed to read."""
    if live >= width:
        return DUR_HEALTHY
    if live < k:
        return DUR_UNREADABLE
    if live == k:
        return DUR_AT_RISK
    return DUR_DEGRADED


def zone_exposed(live_by_zone: dict, live: int, k: int) -> list:
    """Zones whose loss would drop this stripe below k live pieces.
    Pure function: `live_by_zone` maps zone -> live pieces it holds."""
    return [z for z, c in live_by_zone.items() if c and live - c < k]


def layout_transition(history) -> dict:
    """Progress of the block plane toward the CURRENT layout version:
    a partition counts synced when every node of its current assignment
    has reported sync >= that version (the same trackers that gate
    version retirement, rpc/layout/history.py)."""
    cur = history.current()
    active = [v for v in history.versions if v.ring_assignment]
    if not cur.ring_assignment:
        return {
            "version": cur.version,
            "minStored": history.min_stored(),
            "activeVersions": len(active),
            "partitions": 0,
            "partitionsSynced": 0,
            "progress": 1.0,
        }
    total = len(cur.ring_assignment)
    synced = 0
    for p in range(total):
        nodes = cur.nodes_of_partition(p)
        if nodes and all(
            history.sync.get(n) >= cur.version for n in nodes
        ):
            synced += 1
    return {
        "version": cur.version,
        "minStored": history.min_stored(),
        "activeVersions": len(active),
        "partitions": total,
        "partitionsSynced": synced,
        # a transition is IN FLIGHT only while an older version is still
        # retained (trim retires it once every component reports sync);
        # a settled cluster reads 1.0 even before its trackers tick
        "progress": (
            1.0 if len(active) <= 1 else round(synced / total, 4)
        ),
    }


class ScanParams:
    """Mutable knobs shared between the composition root (config +
    BgVars setters) and the running scanner — `worker set
    durability-tranquility 4` applies on the next batch."""

    def __init__(
        self,
        tranquility: int = 2,
        scan_batch: int = 256,
        interval_secs: float = 60.0,
        stuck_error_secs: float = 900.0,
    ):
        self.tranquility = tranquility
        self.scan_batch = scan_batch
        self.interval_secs = interval_secs
        self.stuck_error_secs = stuck_error_secs


class DurabilityScanner(Worker):
    """The redundancy-ledger worker (see module docstring).  One per
    node, always constructed (the digest reads it), spawned by
    `Garage.spawn_workers` when `[durability] enabled`.  Tests and
    bench_repair drive `scan_pass()` directly for determinism."""

    def __init__(
        self,
        manager,
        params: ScanParams | None = None,
        planner_fn=None,
        clock=time.monotonic,
    ):
        self.manager = manager
        self.params = params or ScanParams()
        # the live RepairPlanner, if any (its throughput seeds the ETA
        # before two ledger passes have observed a drain)
        self.planner_fn = planner_fn or (lambda: None)
        self.clock = clock
        self.tranquilizer = Tranquilizer()
        self.gauge_id = str(next(_gauge_ids))
        self.passes = 0
        self._cursor: bytes | None = None  # None = no pass in progress
        self._cur: dict | None = None  # accumulating pass state
        self._published: dict | None = None  # last completed pass
        self._published_at: float | None = None
        self._drain_ewma: float | None = None  # missing pieces/sec
        self._piece_est: float | None = None  # bytes, sampled EWMA
        # hash -> class for blocks currently at_risk/unreadable: a block
        # WORSENING (at_risk -> unreadable) re-alerts, a block merely
        # staying bad does not
        self._alerted: dict[bytes, str] = {}
        self._kick = asyncio.Event()
        # a layout change restripes ownership and liveness: rescan now,
        # not at the next interval tick
        manager.system.layout_manager.subscribe(self._kick.set)

    # --- worker interface -----------------------------------------------------

    def name(self) -> str:
        return "durability_scan"

    def status(self):
        out = {
            "passes": self.passes,
            "scanning": self._cursor is not None,
        }
        p = self._published
        if p is not None:
            out.update(
                {
                    "total": p["total"],
                    "healthy": p["healthy"],
                    "degraded": p["degraded"],
                    "atRisk": p["atRisk"],
                    "unreadable": p["unreadable"],
                    "missingPieces": p["missingPieces"],
                    "etaSecs": self.repair_eta_secs(),
                }
            )
        return out

    def tranquility(self) -> int | None:
        return self.params.tranquility

    async def work(self):
        if self._cursor is None:
            due = (
                self._published_at is None
                or self.clock() - self._published_at
                >= self.params.interval_secs
                or self._kick.is_set()
            )
            if not due:
                return WorkerState.IDLE
            self._kick.clear()
            self._begin_pass()
        self.tranquilizer.reset()
        more = await self._scan_step()
        if not more:
            self._finish_pass()
            return WorkerState.IDLE
        delay = self.tranquilizer.tranquilize_delay(self.params.tranquility)
        return (WorkerState.THROTTLED, delay) if delay else WorkerState.BUSY

    async def wait_for_work(self) -> None:
        try:
            await asyncio.wait_for(
                self._kick.wait(),
                timeout=max(0.05, min(self.params.interval_secs / 4, 5.0)),
            )
        except asyncio.TimeoutError:
            pass

    async def scan_pass(self) -> dict:
        """Run ONE full ledger pass to completion (no pacing) and return
        the published snapshot — the deterministic path tests and
        bench_repair use instead of the worker loop."""
        if self._cursor is None:
            self._begin_pass()
        while await self._scan_step():
            pass
        self._finish_pass()
        assert self._published is not None
        return self._published

    # --- the pass -------------------------------------------------------------

    def _begin_pass(self) -> None:
        self._cursor = b""
        self._cur = {
            "total": 0,
            "healthy": 0,
            "degraded": 0,
            "at_risk": 0,
            "unreadable": 0,
            "urgency": {URGENCY_HIGH: 0, URGENCY_LOW: 0},
            "missing_pieces": 0,
            "local_missing": 0,
            "unplaceable": 0,
            "zone_exposed": {},
            "min_margin": None,
            "alert_hashes": {},
            "new_alerts": [],
            "t0": self.clock(),
        }

    def _geometry(self) -> tuple[int, int]:
        """(stripe width, pieces needed to read).  EC: (k+m, k); replica:
        (rf, 1) — any single live copy serves a read."""
        codec = self.manager.codec
        if codec.n_pieces > 1:
            return codec.n_pieces, codec.min_pieces
        lm = self.manager.system.layout_manager
        return lm.history.current().replication_factor, 1

    async def _scan_step(self) -> bool:
        """Classify one batch of rc-tree keys; returns False when the
        pass is complete."""
        from ..rpc.peer_health import OPEN

        mgr = self.manager
        cur = self._cur
        assert cur is not None
        layout = mgr.system.layout_manager.history.current()
        if not layout.ring_assignment:
            self._cursor = None
            return False
        width, k = self._geometry()
        ec = mgr.codec.n_pieces > 1
        self_id = mgr.system.id
        health = mgr.helper.health
        netapp = mgr.system.netapp

        hashes: list[bytes] = []
        cursor = self._cursor or b""
        for key, val in mgr.rc.tree.iter_range(start=cursor):
            cursor = key + b"\x00"
            if val and not val.startswith(b"del") and int.from_bytes(
                val[:8], "big"
            ) > 0:
                hashes.append(key)
            if len(hashes) >= max(1, int(self.params.scan_batch)):
                break
        else:
            cursor = None  # type: ignore[assignment]
        self._cursor = cursor
        if not hashes:
            return self._cursor is not None

        # placement + liveness snapshot (loop-side, pure memory reads)
        zone_of = {
            n: r.zone for n, r in layout.roles.items() if r.capacity is not None
        }
        # two liveness signals, deliberately distinct: a piece counts
        # reachable only if its node is connected AND not behind an open
        # breaker (fetchability from HERE); ownership keys on
        # connectivity alone — the breaker is a local verdict, and using
        # it for ownership would let this node claim blocks whose
        # connected owner still counts them (double-count)
        reach: dict[bytes, bool] = {}
        conn: dict[bytes, bool] = {}

        def is_reachable(n: bytes) -> bool:
            got = reach.get(n)
            if got is None:
                got = n == self_id or (
                    netapp.is_connected(n) and health.state_of(n) != OPEN
                )
                reach[n] = got
            return got

        def is_connected(n: bytes) -> bool:
            got = conn.get(n)
            if got is None:
                got = n == self_id or netapp.is_connected(n)
                conn[n] = got
            return got

        assign: dict[bytes, list[bytes]] = {}
        my_ranks: dict[bytes, list[int]] = {}
        for h in hashes:
            nodes = layout.nodes_of(h)[:width]
            if len(nodes) < width:
                cur["unplaceable"] += 1
                continue
            assign[h] = nodes
            my_ranks[h] = [i for i, n in enumerate(nodes) if n == self_id]

        # local piece presence: file checks leave the event loop
        to_check = [
            (h, ranks) for h, ranks in my_ranks.items() if ranks
        ]
        present, samples = await asyncio.to_thread(
            self._inspect_files, to_check, ec
        )
        for size in samples:
            self._piece_est = (
                float(size)
                if self._piece_est is None
                else RATE_ALPHA * size + (1 - RATE_ALPHA) * self._piece_est
            )

        for h, nodes in assign.items():
            have = present.get(h, set())
            cur["local_missing"] += sum(
                1 for r in my_ranks[h] if r not in have
            )
            # ownership: the first CONNECTED node of the stripe counts
            # this block, so per-node ledgers sum to exact cluster totals
            owner = next((n for n in nodes if is_connected(n)), None)
            if owner != self_id:
                continue
            live = 0
            by_zone: dict[str, int] = {}
            for r, n in enumerate(nodes):
                ok = (r in have) if n == self_id else is_reachable(n)
                if ok:
                    live += 1
                    z = zone_of.get(n)
                    if z is not None:
                        by_zone[z] = by_zone.get(z, 0) + 1
            cur["total"] += 1
            cls = classify_block(live, k, width)
            cur[cls] += 1
            missing = width - live
            cur["missing_pieces"] += missing
            margin = live - k
            if cur["min_margin"] is None or margin < cur["min_margin"]:
                cur["min_margin"] = margin
            if cls == DUR_DEGRADED:
                u = classify(missing, width - k)
                if u in cur["urgency"]:
                    cur["urgency"][u] += 1
            for z in zone_exposed(by_zone, live, k):
                cur["zone_exposed"][z] = cur["zone_exposed"].get(z, 0) + 1
            if cls in (DUR_AT_RISK, DUR_UNREADABLE):
                if len(cur["alert_hashes"]) < ALERT_SET_MAX:
                    cur["alert_hashes"][h] = cls
                if self._alerted.get(h) != cls:
                    cur["new_alerts"].append((h, cls))
        return self._cursor is not None

    def _inspect_files(
        self, to_check: list[tuple[bytes, list[int]]], ec: bool
    ) -> tuple[dict[bytes, set[int]], list[int]]:
        """Thread-side: which of OUR ranks' pieces exist on disk, plus a
        few piece-size samples for the byte-backlog estimate."""
        mgr = self.manager
        present: dict[bytes, set[int]] = {}
        samples: list[int] = []
        for h, ranks in to_check:
            have: set[int] = set()
            for r in ranks:
                found = mgr.find_block_file(h, piece=r if ec else 0)
                if found:
                    have.add(r)
                    if len(samples) < SIZE_SAMPLES_PER_BATCH:
                        try:
                            samples.append(os.path.getsize(found[0]))
                        except OSError:
                            pass
            present[h] = have
        return present, samples

    def _finish_pass(self) -> None:
        cur = self._cur
        assert cur is not None
        self._cursor = None
        self._cur = None
        now = self.clock()
        mgr = self.manager
        transient, stuck = mgr.resync.error_age_counts(
            self.params.stuck_error_secs
        )
        oldest = mgr.resync.oldest_error_age_secs()
        worst = (
            max(cur["zone_exposed"].items(), key=lambda kv: kv[1])
            if cur["zone_exposed"]
            else None
        )
        snap = {
            "total": cur["total"],
            "healthy": cur["healthy"],
            "degraded": cur["degraded"],
            "atRisk": cur["at_risk"],
            "unreadable": cur["unreadable"],
            "degradedByUrgency": dict(cur["urgency"]),
            "missingPieces": cur["missing_pieces"],
            "localMissingPieces": cur["local_missing"],
            "unplaceable": cur["unplaceable"],
            "minMargin": cur["min_margin"],
            "zoneExposed": dict(cur["zone_exposed"]),
            "worstZone": (
                {"zone": worst[0], "blocks": worst[1]} if worst else None
            ),
            "resyncErrors": {
                "transient": transient,
                "stuck": stuck,
                "oldestAgeSecs": (
                    round(oldest, 1) if oldest is not None else None
                ),
            },
            "layout": layout_transition(
                mgr.system.layout_manager.history
            ),
            "passSecs": round(now - cur["t0"], 3),
            "scannedAtMs": now_msec(),
        }
        prev, prev_at = self._published, self._published_at
        if prev is not None and prev_at is not None and now > prev_at:
            drained = prev["missingPieces"] - snap["missingPieces"]
            if drained > 0:
                sample = drained / (now - prev_at)
                self._drain_ewma = (
                    sample
                    if self._drain_ewma is None
                    else RATE_ALPHA * sample
                    + (1 - RATE_ALPHA) * self._drain_ewma
                )
        self._published = snap
        self._published_at = now
        self.passes += 1
        if cur["new_alerts"]:
            self._emit_alert(cur["new_alerts"], snap)
        self._alerted = cur["alert_hashes"]

    def _emit_alert(self, new_alerts: list, snap: dict) -> None:
        """Blocks TRANSITIONED into at_risk/unreadable this pass: one
        slow-ring event + one log line per pass, not per block."""
        from ..utils import flight

        examples = ",".join(h.hex()[:16] for h, _c in new_alerts[:3])
        worst = (
            DUR_UNREADABLE
            if any(c == DUR_UNREADABLE for _h, c in new_alerts)
            else DUR_AT_RISK
        )
        attrs = {
            "node": self.manager.system.id.hex()[:16],
            "newBlocks": len(new_alerts),
            "atRiskTotal": snap["atRisk"],
            "unreadableTotal": snap["unreadable"],
            "examples": examples,
        }
        try:
            flight.record_event(
                f"durability-alert:{worst}",
                attrs,
                severity=(
                    "critical" if worst == DUR_UNREADABLE else "warn"
                ),
            )
        except Exception as e:  # noqa: BLE001 — the ledger must not die on diagnostics
            logger.debug("durability alert event failed: %r", e)
        logger.warning(
            "durability: %d block(s) newly %s (at_risk=%d unreadable=%d, "
            "e.g. %s)", len(new_alerts), worst, snap["atRisk"],
            snap["unreadable"], examples,
        )

    # --- derived numbers ------------------------------------------------------

    def repair_eta_secs(self) -> float | None:
        """Seconds until the missing-piece backlog drains at the current
        repair throughput: observed cross-pass drain EWMA, or the live
        RepairPlanner's own rate before two passes have seen a drain.
        None = backlog with no observed progress (stalled/unknown)."""
        p = self._published
        if p is None:
            return None
        missing = p["missingPieces"]
        if missing <= 0:
            return 0.0
        rates = []
        if self._drain_ewma:
            rates.append(self._drain_ewma)
        planner = self.planner_fn()
        if planner is not None and not getattr(planner, "finished", True):
            plan = planner.plan
            elapsed = (now_msec() - plan.started_ms) / 1000.0
            if plan.repaired > 0 and elapsed > 0:
                rates.append(plan.repaired / elapsed)
        if not rates:
            return None
        return round(missing / max(rates), 1)

    def backlog_bytes(self) -> float:
        """Raises before the first completed pass (gauge contract: a
        dropped sample, never a fabricated zero backlog)."""
        p = self._published
        if p is None:
            raise ValueError("no completed durability pass yet")
        est = self._piece_est or float(DEFAULT_PIECE_EST)
        return float(p["missingPieces"]) * est

    def published_value(self, key: str) -> float:
        """Scrape-time gauge feed; raises before the first pass so the
        sample is dropped, never fabricated as 0."""
        p = self._published
        if p is None:
            raise ValueError("no completed durability pass yet")
        return float(p[key])

    def published_class(self, cls: str) -> float:
        key = {
            DUR_HEALTHY: "healthy",
            DUR_DEGRADED: "degraded",
            DUR_AT_RISK: "atRisk",
            DUR_UNREADABLE: "unreadable",
        }[cls]
        return self.published_value(key)

    def worst_zone_exposed(self) -> float:
        """Blocks the WORST single-zone loss would drop below k (0 when
        no zone is exposed); raises before the first pass."""
        p = self._published
        if p is None:
            raise ValueError("no completed durability pass yet")
        return float(p["worstZone"]["blocks"]) if p["worstZone"] else 0.0

    def layout_sync_fraction(self) -> float:
        p = self._published
        if p is None:
            raise ValueError("no completed durability pass yet")
        return float(p["layout"]["progress"])

    def scan_age_secs(self) -> float:
        if self._published_at is None:
            raise ValueError("no completed durability pass yet")
        return max(0.0, self.clock() - self._published_at)

    def ledger(self) -> dict:
        """The local half of `GET /v1/cluster/durability` (full detail,
        zone names included — JSON only, never metric labels)."""
        p = self._published
        return {
            "passes": self.passes,
            "scanning": self._cursor is not None,
            "snapshot": p,
            "repairEtaSecs": self.repair_eta_secs(),
            "backlogBytes": (
                round(self.backlog_bytes(), 1) if p is not None else None
            ),
            "drainPiecesPerSec": (
                round(self._drain_ewma, 3) if self._drain_ewma else None
            ),
            "ageSecs": (
                round(self.clock() - self._published_at, 1)
                if self._published_at is not None
                else None
            ),
        }

    def digest_fields(self) -> dict:
        """Compact `dur.*` block for the gossiped node digest
        (rpc/telemetry_digest.py; additive keys, DIGEST_VERSION stays
        1).  Counts are OWNED blocks -> cluster totals are sums; `minr`
        federates as min-over-nodes; `zl` is a small zone->count map
        (zones are operator-bounded; names stay out of metric labels)."""
        p = self._published
        if p is None:
            return {"age": None}
        return {
            "tot": p["total"],
            "h": p["healthy"],
            "dg": p["degraded"],
            "ar": p["atRisk"],
            "ur": p["unreadable"],
            "mp": p["missingPieces"],
            "lmp": p["localMissingPieces"],
            "minr": p["minMargin"],
            "eta": self.repair_eta_secs(),
            "bkb": round(self.backlog_bytes(), 1),
            "zx": (
                p["worstZone"]["blocks"] if p["worstZone"] else 0
            ),
            "zl": p["zoneExposed"],
            "lt": p["layout"]["progress"],
            "age": (
                round(self.clock() - self._published_at, 1)
                if self._published_at is not None
                else None
            ),
        }


# --- cluster rollup + the one serialization per endpoint ----------------------


def _num(v, default=None):
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def durability_response(garage) -> dict:
    """The one serialization of the durability observatory, shared by
    admin `GET /v1/cluster/durability` and the admin-RPC `durability`
    op (key casing cannot drift between transports).  Cluster rows come
    from the gossiped `dur.*` digest keys — any node answers for all;
    a digest-less old peer renders `durability: null`, never an error."""
    from ..rpc.telemetry_digest import _valid_digest

    system = garage.system
    system.expire_node_status()
    sc = getattr(garage, "durability_scanner", None)
    local = _valid_digest(garage.telemetry.collect()) or {}
    rows = [
        {
            "id": system.id.hex(),
            "isSelf": True,
            "isUp": True,
            "durability": local.get("dur"),
        }
    ]
    for pid, (pst, _ts) in sorted(system.node_status.items()):
        d = _valid_digest(pst.telemetry) or {}
        rows.append(
            {
                "id": pid.hex(),
                "isSelf": False,
                "isUp": system.netapp.is_connected(pid),
                "durability": d.get("dur"),
            }
        )
    # aggregate only CONNECTED nodes: a dead peer's last-gossiped row
    # (still shown in `nodes` until status expiry) claims the health it
    # had while alive, and its blocks are re-owned by the surviving
    # first-live ranks — summing both would double-count every stripe
    # the cluster just lost a rank of
    with_dur = [
        r
        for r in rows
        if r.get("isUp")
        and isinstance(r.get("durability"), dict)
        and r["durability"].get("tot") is not None
    ]

    def nsum(key: str) -> float:
        return sum(
            _num(r["durability"].get(key), 0.0) for r in with_dur
        )

    minrs = [
        v
        for r in with_dur
        if (v := _num(r["durability"].get("minr"))) is not None
    ]
    etas = [
        v
        for r in with_dur
        if (v := _num(r["durability"].get("eta"))) is not None
    ]
    zones: dict[str, float] = {}
    for r in with_dur:
        zl = r["durability"].get("zl")
        if isinstance(zl, dict):
            for z, c in zl.items():
                c = _num(c, 0.0)
                if c:
                    zones[str(z)] = zones.get(str(z), 0.0) + c
    total = nsum("tot")
    healthy = nsum("h")
    # the scanner object always exists (the digest reads it); "enabled"
    # must reflect whether the WORKER runs, or a disabled observatory
    # reads as a stuck one
    enabled = sc is not None and bool(
        getattr(garage.config.durability, "enabled", True)
    )
    return {
        "node": garage.node_id.hex(),
        "enabled": enabled,
        "local": sc.ledger() if sc is not None else None,
        "cluster": {
            "nodes": rows,
            "nodesReporting": len(with_dur),
            "aggregate": {
                "blocksTotal": total,
                "healthy": healthy,
                "degraded": nsum("dg"),
                "atRisk": nsum("ar"),
                "unreadable": nsum("ur"),
                "missingPieces": nsum("mp"),
                "backlogBytes": nsum("bkb"),
                "healthyFraction": (
                    round(healthy / total, 4) if total else None
                ),
                # the slowest node gates full redundancy; min margin is
                # the cluster's distance from data loss
                "minRedundancy": min(minrs) if minrs else None,
                "repairEtaSeconds": max(etas) if etas else None,
                # nodes with a backlog but NO eta (no observed drain, no
                # planner): "repair stalled" — a healthy node's 0.0 must
                # not mask these in the max above
                "repairEtaUnknownNodes": sum(
                    1
                    for r in with_dur
                    if _num(r["durability"].get("mp"), 0.0) > 0
                    and _num(r["durability"].get("eta")) is None
                ),
                "zoneExposure": zones,
            },
        },
    }
