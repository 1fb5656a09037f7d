"""Cluster telemetry plane: gossiped node digests + federated rollup.

PRs 2-3 made every *node* deeply observable; this module makes the
*cluster* observable from any single node.  Monarch-style [Adya et al.,
VLDB'20], each node pre-aggregates a compact versioned digest of its own
registries (S3 RED numbers, resync/repair backlog, event-loop lag,
worker errors, breaker states, TPU dispatch rate, uptime) and piggybacks
it on the existing anti-entropy `NodeStatus` exchange (`rpc/system.py`)
— no new gossip round, no scrape fan-out, tolerant of old peers that
don't send the field.  Any node can then answer for the whole cluster:

  - `rollup(garage)`         JSON rollup: per-node rows + aggregates +
                             outliers + SLO state (admin
                             `GET /v1/cluster/telemetry`, `cluster top`)
  - `render_cluster_metrics` federated Prometheus exposition of the
                             digest families with a `node` label
                             (admin `GET /metrics/cluster`)
  - `detect_outliers`        median-absolute-deviation flags for nodes
                             whose latency / error rate / loop lag
                             deviate from the cluster (also surfaced in
                             `ClusterHealth.outlier_nodes`)
  - `SloTracker`             `[admin] slo_*` availability + p99-latency
                             targets -> `slo_error_budget_remaining` /
                             `slo_burn_rate` gauges

Digest rows are rendered inline from the live gossip state (never
registered as per-node registry gauges), so an expired/departed node
disappears from the rollup the moment `rpc/system.py` ages its status
entry out — there is no stale-gauge unregistration to forget.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from statistics import median
from typing import Any

from ..utils import metrics as metrics_mod

logger = logging.getLogger("garage.telemetry")

DIGEST_VERSION = 1

# Outlier detection: per-metric (digest key path, MAD floor, absolute
# minimum).  One-sided — only deviating HIGH is sick.  The MAD floor
# keeps a tight cluster (MAD ~ 0) from flagging noise-level deviations;
# the absolute minimum keeps a healthy-but-not-identical node (p99 of
# 8 ms vs the cluster's 2 ms) from ever being flagged.
MAD_K = 3.5  # modified z-score cutoff (Iglewicz & Hoaglin's suggestion)
OUTLIER_METRICS: list[tuple[str, str, float, float]] = [
    ("s3_p99_seconds", "s3 p99 latency", 0.010, 0.050),
    ("s3_error_fraction", "s3 error rate", 0.010, 0.050),
    ("loop_lag_p99_seconds", "event-loop lag p99", 0.010, 0.050),
]


def _s3_5xx_total(registry) -> float:
    """Cumulative S3 5xx count — the ONE definition of what burns the
    availability budget, shared by the digest collector and the SLO
    tracker so the gossiped error rate and the budget can't diverge."""
    return registry.counter_family_sum(
        "api_s3_error_counter",
        lambda labels: any(
            k == "code" and v.startswith("5") for k, v in labels
        ),
    )


def _finite(v: float | None) -> float | None:
    """Clamp a histogram quantile to the largest finite bucket bound:
    family_quantile returns inf when the quantile lands in the overflow
    bucket, and an inf in the digest would serialize as the RFC-invalid
    JSON token `Infinity` on the admin endpoints."""
    if v is None:
        return None
    return min(v, metrics_mod.BUCKETS[-1])


class DigestCollector:
    """Assembles this node's telemetry digest from the live registries.

    Counter-derived rates (req/s, err/s, dispatches/s) are deltas over
    the interval since the previous collection; collections are cached
    for `min_interval` so the admin endpoints re-reading the local row
    don't shrink the rate window to nothing.  `registry` is injectable:
    production uses the process-global one, tests give each in-process
    node its own (several Garage instances share a process there).
    """

    min_interval = 1.0
    # counter rates are deltas over a FIXED window, not "since whenever
    # collect() last ran": admin endpoints and health() also trigger
    # collections, and advancing the baseline on each of those would
    # make the gossiped req/s depend on the scrape frequency (a burst
    # 4 s before a scrape-triggered collect would gossip rps=0)
    rate_window = 10.0

    def __init__(self, garage, registry=None, clock=time.monotonic,
                 observatory=None, tenant_observatory=None):
        self.garage = garage
        self.registry = registry if registry is not None else metrics_mod.registry
        # traffic observatory (rpc/traffic.py): injectable for the same
        # reason the registry is — the production singleton is process-
        # wide, and in-process multi-node tests want per-node numbers
        self.observatory = observatory
        # tenant observatory (rpc/tenant.py): same injection contract
        self.tenant_observatory = tenant_observatory
        self.clock = clock
        self.started_at = clock()
        self._prev: dict[str, float] | None = None
        self._prev_t: float | None = None
        self._rates: dict[str, float] | None = None
        self._cached: dict[str, Any] | None = None
        self._cached_t = 0.0

    # --- counter snapshot ----------------------------------------------------

    def _obs(self):
        if self.observatory is not None:
            return self.observatory
        from .traffic import observatory

        return observatory

    def _tobs(self):
        if self.tenant_observatory is not None:
            return self.tenant_observatory
        from .tenant import observatory

        return observatory

    def _counters(self) -> dict[str, float]:
        r = self.registry
        return {
            "s3_req": r.counter_family_sum("api_s3_request_counter"),
            "s3_err": _s3_5xx_total(r),
            "tpu_disp": r.counter_family_sum("tpu_codec_dispatch_total"),
            # traffic-observatory op total: rides the same windowed-rate
            # machinery so the gossiped trf.rps can't drift from s3.rps
            # methodology
            "trf_ops": float(self._obs().total_ops),
            # tenant-observatory op total: same windowed-rate machinery,
            # so the gossiped tn.rps shares the s3.rps methodology
            "tn_ops": float(self._tobs().total_ops),
        }

    def collect(self) -> dict[str, Any]:
        """The digest as a compact msgpack-friendly dict (documented in
        doc/monitoring.md "Digest field catalogue")."""
        now = self.clock()
        if self._cached is not None and now - self._cached_t < self.min_interval:
            return self._cached
        g = self.garage
        r = self.registry
        cur = self._counters()
        if self._prev is None:
            self._prev, self._prev_t = cur, now
        elif now - self._prev_t >= self.rate_window:
            dt = now - self._prev_t
            self._rates = {
                k: max(0.0, cur[k] - self._prev[k]) / dt for k in cur
            }
            self._prev, self._prev_t = cur, now
        rates = self._rates if self._rates is not None else dict.fromkeys(cur, 0.0)

        breakers = {"open": 0, "half-open": 0, "sick": 0}
        ph = getattr(g, "peer_health", None)
        if ph is not None:
            for node in list(ph.peers):
                st = ph.state_of(node)
                if st in ("open", "half-open"):
                    breakers[st] += 1
                if ph.is_sick(node):
                    breakers["sick"] += 1

        planner = getattr(g, "repair_planner", None)
        planner_live = planner is not None and not planner.finished
        repair_backlog = (
            # the ledger lives on the checkpointable plan state;
            # queue_length() is the planner's own backlog accessor
            planner.queue_length() or 0 if planner_live else 0
        )
        # urgency breakdown (block/repair_plan.py classify buckets): the
        # total backlog alone can't tell "10k low-urgency stripes" from
        # "10k one-failure-from-loss stripes" — the distinction the
        # durability observatory and `cluster top` triage on
        urg = (
            planner.backlog_by_urgency()
            if planner_live
            else {"critical": 0, "high": 0, "low": 0, "lost": 0}
        )
        resync_age = g.block_manager.resync.oldest_error_age_secs()

        from ..ops.telemetry import codec_snapshot, platforms_seen

        # codec X-ray (ops/telemetry.py): dispatch pad-waste, compile
        # accounting, host<->device overlap, batcher lane linger — the
        # same snapshot the admin /v1/codec endpoint serves, reduced to
        # its scalar summary for gossip
        cx = codec_snapshot(r)
        digest: dict[str, Any] = {
            "v": DIGEST_VERSION,
            "up": round(now - self.started_at, 3),
            "s3": {
                "rps": round(rates["s3_req"], 4),
                "eps": round(rates["s3_err"], 4),
                "req": cur["s3_req"],
                "err": cur["s3_err"],
                "p50": _finite(r.family_quantile("api_s3_request_duration", 0.5)),
                "p99": _finite(r.family_quantile("api_s3_request_duration", 0.99)),
            },
            "loop": {
                "p99": _finite(r.family_quantile("event_loop_lag_seconds", 0.99)),
                "blocked": r.counter_family_sum("event_loop_blocked_total"),
            },
            "work": {
                "errs": r.gauge_family_sum("worker_errors_total"),
            },
            "resync": {
                "q": g.block_manager.resync.queue_len(),
                "err": g.block_manager.resync.errors_len(),
                # oldest error AGE (secs): transient blip vs stuck block
                "age": round(resync_age, 1) if resync_age is not None else None,
            },
            "repair": {
                "backlog": repair_backlog,
                "cr": urg.get("critical", 0),
                "hi": urg.get("high", 0),
                "lo": urg.get("low", 0),
                "lost": urg.get("lost", 0),
            },
            "rpc": breakers,
            "tpu": {
                "dps": round(rates["tpu_disp"], 4),
                "plat": ",".join(platforms_seen()) or None,
            },
            # codec X-ray summary — "codec" keys are additive,
            # DIGEST_VERSION stays 1
            "codec": {
                "dsp": cx["dispatches"],
                "pw": cx["padWaste"],
                "ce": cx["compileEvents"],
                "cs": cx["compileSecs"],
                "ovl": cx["overlapEfficiency"],
                "ll99": cx["laneLingerP99"],
            },
        }
        # canary prober health (api/s3/canary.py): cumulative probes,
        # failures, probe p99 — all-zero on nodes without a prober, so
        # `cluster top` can tell "no canary" from "canary failing"
        from ..api.s3.canary import digest_fields as _canary_fields

        cn = _canary_fields(r)
        cn["p99"] = _finite(cn["p99"])
        # last-cycle verdict from the live worker (1 ok / 0 failing /
        # absent before the first cycle or without a prober): the
        # cumulative `err` count flags a node forever after one transient
        # blip — recency is what `cluster top`'s CANARY-FAIL keys off
        w = getattr(g, "canary", None)
        if w is not None and w.healthy is not None:
            cn["ok"] = w.healthy
        digest["canary"] = cn
        slo = getattr(g, "slo_tracker", None)
        if slo is not None:
            digest["slo"] = slo.digest_fields()
        # traffic observatory (rpc/traffic.py): op mix, hot bucket,
        # keyspace skew — "trf" keys are additive, DIGEST_VERSION stays 1
        digest["trf"] = self._obs().digest_fields(
            rates.get("trf_ops", 0.0)
        )
        # overload-control plane (api/overload.py + rpc/shedding.py):
        # ladder level + admission totals — a shedding node is visible
        # cluster-wide ("ovl" keys are additive, DIGEST_VERSION stays 1)
        ov = getattr(g, "overload", None)
        if ov is not None:
            ovl = ov.digest_fields()
            sh = getattr(g, "shedder", None)
            ovl["lvl"] = sh.level if sh is not None else 0
            digest["ovl"] = ovl
        # durability observatory (block/durability.py): redundancy-class
        # counts, min margin, repair ETA, zone exposure, layout-sync
        # progress — "dur" keys are additive, DIGEST_VERSION stays 1.
        # Counts are OWNED blocks, so the rollup's sums are exact.
        ds = getattr(g, "durability_scanner", None)
        if ds is not None:
            digest["dur"] = ds.digest_fields()
        # metadata plane: EFFECTIVE meta replication factor +
        # quorum sizes of the sharded tables, so a misconfigured meta RF
        # on any node is visible from every node ("meta" keys are
        # additive, DIGEST_VERSION stays 1).  Read from the live table
        # replication (not the config) so layout-driven fallback shows.
        rep = getattr(getattr(g, "object_table", None), "replication", None)
        if rep is not None and hasattr(rep, "effective_rf"):
            digest["meta"] = {
                "rf": int(rep.effective_rf()),
                "rq": int(rep.read_quorum()),
                "wq": int(rep.write_quorum()),
            }
        # rebalance observatory (rpc/transition.py): this node's layout
        # version / ack / sync trackers, transition progress and clock
        # skew — "lt" keys are additive, DIGEST_VERSION stays 1.  The
        # gossiped ack/sync versions are what let ANY node compute the
        # cluster's version spread and per-node staleness.
        tt = getattr(g, "transition_tracker", None)
        if tt is not None:
            digest["lt"] = tt.digest_fields()
        # tenant observatory (rpc/tenant.py): bounded top-N per-tenant
        # rows + node scalars — "tn" keys are additive, DIGEST_VERSION
        # stays 1.  Tenant key ids ride the JSON digest only; the
        # federated exposition renders just the numeric scalars.
        digest["tn"] = self._tobs().digest_fields(rates.get("tn_ops", 0.0))
        self._cached, self._cached_t = digest, now
        return digest


# --- SLO tracker --------------------------------------------------------------


class SloTracker:
    """Error-budget accounting for the S3 frontend against the `[admin]`
    `slo_availability_target` (percent of requests answered without a
    5xx) and `slo_latency_p99_target_msec` (percent of requests under
    the latency target — same availability percentage applies) over a
    rolling `slo_window_secs` window.

    compute() compares the oldest in-window snapshot of the cumulative
    counters with now, so the scrape rate doesn't change the math.
    Gauges (registered by model/garage.py):

      slo_error_budget_remaining{slo="availability"|"latency_p99"}
          1.0 = untouched budget, 0.0 = spent, negative = blown
      slo_burn_rate{slo=...}
          bad-fraction / allowed-fraction over the window; sustained
          > 1.0 means the budget will not survive the window
    """

    def __init__(self, registry=None, *, availability_target=99.9,
                 latency_target_msec=1000.0, window_secs=3600.0,
                 clock=time.monotonic):
        self.registry = registry if registry is not None else metrics_mod.registry
        self.target = min(float(availability_target), 100.0) / 100.0
        self.latency_target = float(latency_target_msec) / 1000.0
        self.window = float(window_secs)
        self.clock = clock
        # (t, requests, 5xx errors, latency-observed, latency-over)
        self._snaps: deque[tuple[float, float, float, int, int]] = deque()
        self._computed: tuple[float, dict] | None = None

    def _snapshot(self) -> tuple[float, float, float, int, int]:
        r = self.registry
        req = r.counter_family_sum("api_s3_request_counter")
        err = _s3_5xx_total(r)
        lat_n, lat_over = r.family_count_over(
            "api_s3_request_duration", self.latency_target
        )
        now = self.clock()
        snap = (now, req, err, lat_n, lat_over)
        # coalesce bursts (one /metrics scrape evaluates 4 SLO gauges =
        # 4 compute() calls): replace a sub-200ms-old tail instead of
        # appending, keeping the newest snapshot current while bounding
        # the deque; never replace the window's oldest entry
        if len(self._snaps) > 1 and now - self._snaps[-1][0] < 0.2:
            self._snaps[-1] = snap
        else:
            self._snaps.append(snap)
        while self._snaps and now - self._snaps[0][0] > self.window:
            self._snaps.popleft()
        return self._snaps[0]

    def compute(self) -> dict[str, dict[str, float]]:
        # one /metrics scrape evaluates four SLO gauge fns; a brief
        # result cache makes that one snapshot + one histogram merge
        now = self.clock()
        if self._computed is not None and now - self._computed[0] < 0.1:
            return self._computed[1]
        first = self._snapshot()
        last = self._snaps[-1]
        allowed = max(1.0 - self.target, 1e-9)

        def budget(total: float, bad: float) -> dict[str, float]:
            if total <= 0:
                return {"bad_fraction": 0.0, "burn_rate": 0.0,
                        "budget_remaining": 1.0, "window_total": 0.0,
                        "window_bad": 0.0}
            frac = bad / total
            return {
                "bad_fraction": frac,
                "burn_rate": frac / allowed,
                "budget_remaining": 1.0 - frac / allowed,
                "window_total": total,
                "window_bad": bad,
            }

        result = {
            "availability": budget(last[1] - first[1], last[2] - first[2]),
            "latency_p99": budget(last[3] - first[3], last[4] - first[4]),
        }
        self._computed = (now, result)
        return result

    def digest_fields(self) -> dict[str, Any]:
        c = self.compute()
        return {
            "target": round(self.target, 6),
            "lat_target": self.latency_target,
            "avail": {
                "rem": round(c["availability"]["budget_remaining"], 4),
                "burn": round(c["availability"]["burn_rate"], 4),
                "n": c["availability"]["window_total"],
                "bad": c["availability"]["window_bad"],
            },
            "lat": {
                "rem": round(c["latency_p99"]["budget_remaining"], 4),
                "burn": round(c["latency_p99"]["burn_rate"], 4),
                "n": c["latency_p99"]["window_total"],
                "bad": c["latency_p99"]["window_bad"],
            },
        }


# --- rollup -------------------------------------------------------------------


def _valid_digest(obj: Any) -> dict[str, Any] | None:
    """Gate a gossiped digest: only a dict stamped with OUR schema
    version is consumed.  A newer peer's v2 digest (rolling upgrade) or
    a malformed one degrades that node to a digest-less row — the
    federated endpoint must keep serving the rest of the cluster, not
    500 on float(<unexpected type>)."""
    if isinstance(obj, dict) and obj.get("v") == DIGEST_VERSION:
        return obj
    return None


def _node_rows(system) -> list[dict[str, Any]]:
    """Per-node rows: self (fresh local digest) + every unexpired
    node_status entry (digest may be None for old- or newer-version
    peers)."""
    system.expire_node_status()
    st = system.local_status()
    rows = [
        {
            "id": system.id.hex(),
            "hostname": st.hostname,
            "isSelf": True,
            "isUp": True,
            "ageSecs": 0.0,
            "metaDiskAvail": st.meta_disk_avail,
            "dataDiskAvail": st.data_disk_avail,
            "digest": _valid_digest(st.telemetry),
        }
    ]
    now = time.monotonic()
    for pid, (pst, ts) in sorted(system.node_status.items()):
        rows.append(
            {
                "id": pid.hex(),
                "hostname": pst.hostname,
                "isSelf": False,
                "isUp": system.netapp.is_connected(pid),
                "ageSecs": round(max(0.0, now - ts), 3),
                "metaDiskAvail": pst.meta_disk_avail,
                "dataDiskAvail": pst.data_disk_avail,
                "digest": _valid_digest(pst.telemetry),
            }
        )
    return rows


def _dig(row: dict, *path, default=None):
    cur = row.get("digest")
    for p in path:
        if not isinstance(cur, dict):
            return default
        cur = cur.get(p)
    return cur if cur is not None else default


def _metric_values(rows) -> dict[str, dict[str, float]]:
    """node id -> value per outlier metric (nodes without the datum are
    skipped for that metric, not defaulted — an old peer must not drag
    the median)."""
    out: dict[str, dict[str, float]] = {k: {} for k, *_ in OUTLIER_METRICS}
    for row in rows:
        if row.get("digest") is None:
            continue
        nid = row["id"]
        try:
            p99 = _dig(row, "s3", "p99")
            if p99 is not None:
                out["s3_p99_seconds"][nid] = float(p99)
            rps = _dig(row, "s3", "rps", default=0.0)
            eps = _dig(row, "s3", "eps", default=0.0)
            if rps or eps:
                # rps already includes errored requests (the request
                # counter increments before the handler runs), so the
                # error fraction is eps/rps — an all-5xx node must
                # score 1.0, not 0.5.  Noise floor: below ~3 errors per
                # rate window (0.3/s over 10 s) the fraction reads 0 —
                # one transient 500 in a low-traffic window must not
                # MAD-flag a node (healthy nodes stay in the population
                # at 0 so the detector keeps its median)
                out["s3_error_fraction"][nid] = (
                    min(1.0, float(eps) / max(float(rps), 1e-9))
                    if float(eps) >= 0.3
                    else 0.0
                )
            lag = _dig(row, "loop", "p99")
            if lag is not None:
                out["loop_lag_p99_seconds"][nid] = float(lag)
        except (TypeError, ValueError):
            # malformed values: skip the node, don't drag the median
            for per_node in out.values():
                per_node.pop(nid, None)
    return out


def detect_outliers(rows) -> dict[str, list[str]]:
    """node id -> reasons, via one-sided modified z-score (MAD) per
    metric.  Needs >= 3 nodes reporting a metric to say anything."""
    flagged: dict[str, list[str]] = {}
    values = _metric_values(rows)
    for key, label, mad_floor, abs_min in OUTLIER_METRICS:
        per_node = values[key]
        if len(per_node) < 3:
            continue
        med = median(per_node.values())
        mad = median(abs(v - med) for v in per_node.values())
        scale = max(1.4826 * mad, mad_floor)
        for nid, v in per_node.items():
            if v < abs_min:
                continue
            score = (v - med) / scale
            if score > MAD_K:
                flagged.setdefault(nid, []).append(
                    f"{label} {v:.3g} vs cluster median {med:.3g}"
                )
    return flagged


def outlier_node_ids(system) -> list[str]:
    """The outlier set alone (ClusterHealth.outlier_nodes feed).  Built
    from digests only — health() is called on every /metrics scrape,
    /v1/status and status CLI, and the full _node_rows pass would run
    local_status()'s two blocking disk_usage syscalls each time just to
    count outliers.  Digest collection itself is cached (~1 s)."""
    try:
        system.expire_node_status()
        rows: list[dict[str, Any]] = []
        if system.telemetry_collector is not None:
            rows.append(
                {
                    "id": system.id.hex(),
                    "digest": _valid_digest(system.telemetry_collector()),
                }
            )
        for pid, (pst, _ts) in system.node_status.items():
            rows.append(
                {"id": pid.hex(), "digest": _valid_digest(pst.telemetry)}
            )
        return sorted(detect_outliers(rows))
    except Exception as e:  # noqa: BLE001 — health() must never fail on telemetry
        logger.debug("outlier computation failed: %r", e)
        return []


def _num(v, default: float | None = None) -> float | None:
    """Tolerant numeric coercion: _valid_digest only gates the schema
    VERSION, so a buggy v1 peer can still put a string/dict where a
    number belongs — the aggregate paths must degrade, not 500."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _dsum(rows, *path) -> float:
    return sum(
        _num(_dig(r, *path, default=0.0), default=0.0) for r in rows
    )


def _tenant_hog_share(with_digest) -> tuple[float | None, int]:
    """`(cluster-wide top-1 tenant ops share, distinct tenants seen)`
    from the gossiped `tn.rows` sections (share is None until some node
    reports a tenant).  Summing the per-node rows BEFORE taking the max
    is the whole point: a tenant spread thin over 11 frontends looks
    modest on every node row yet tops the cluster table — this is the
    number the `cluster top` hog column and the HOG! flag key off."""
    totals: dict[str, float] = {}
    for r in with_digest:
        trows = _dig(r, "tn", "rows")
        if not isinstance(trows, list):
            continue
        for t in trows:
            if not isinstance(t, dict) or not isinstance(t.get("id"), str):
                continue
            totals[t["id"]] = totals.get(t["id"], 0.0) + (
                _num(t.get("ops"), 0.0) or 0.0
            )
    total = sum(totals.values())
    if not totals or total <= 0:
        return None, len(totals)
    return max(totals.values()) / total, len(totals)


def _cluster_slo(garage, with_digest) -> dict[str, Any] | None:
    """Request-weighted cluster SLO across every reporting node's
    window — shared by rollup() and the federated exposition (which must
    not pay for the full rollup, health scan included, per scrape)."""
    tr = getattr(garage, "slo_tracker", None)
    if tr is None:
        return None
    allowed = max(1.0 - tr.target, 1e-9)

    def agg(kind: str) -> dict[str, float]:
        total = _dsum(with_digest, "slo", kind, "n")
        bad = _dsum(with_digest, "slo", kind, "bad")
        frac = bad / total if total > 0 else 0.0
        return {
            "windowTotal": total,
            "windowBad": bad,
            "burnRate": frac / allowed,
            "budgetRemaining": 1.0 - frac / allowed,
        }

    return {
        "availabilityTarget": tr.target,
        "latencyP99TargetSecs": tr.latency_target,
        "windowSecs": tr.window,
        "availability": agg("avail"),
        "latencyP99": agg("lat"),
    }


def rollup(garage, rows=None, outliers=None) -> dict[str, Any]:
    """The one-stop cluster JSON (admin GET /v1/cluster/telemetry).
    `rows`/`outliers`: precomputed by a caller that already built them —
    each _node_rows pass costs two blocking disk_usage syscalls on the
    event loop, so don't repeat it."""
    if rows is None:
        rows = _node_rows(garage.system)
    if outliers is None:
        outliers = detect_outliers(rows)
    with_digest = [r for r in rows if r.get("digest") is not None]

    def dsum(*path) -> float:
        return _dsum(with_digest, *path)

    def dmax(*path) -> float | None:
        vals = [
            v
            for r in with_digest
            if (v := _num(_dig(r, *path))) is not None
        ]
        return max(vals) if vals else None

    def dmin(*path) -> float | None:
        vals = [
            v
            for r in with_digest
            if (v := _num(_dig(r, *path))) is not None
        ]
        return min(vals) if vals else None

    slo = _cluster_slo(garage, with_digest)
    hog_share, tenants_seen = _tenant_hog_share(with_digest)
    h = garage.system.health(outlier_nodes=sorted(outliers))
    return {
        "node": garage.node_id.hex(),
        "clusterHealth": h.__dict__,
        "nodes": rows,
        "nodesReporting": len(with_digest),
        "aggregate": {
            "s3RequestsPerSec": round(dsum("s3", "rps"), 4),
            "s3ErrorsPerSec": round(dsum("s3", "eps"), 4),
            "s3P99SecondsWorst": dmax("s3", "p99"),
            "loopLagP99SecondsWorst": dmax("loop", "p99"),
            "resyncQueue": dsum("resync", "q"),
            "resyncErrors": dsum("resync", "err"),
            "repairBacklog": dsum("repair", "backlog"),
            "workerErrors": dsum("work", "errs"),
            "breakersOpen": dsum("rpc", "open"),
            "tpuDispatchPerSec": round(dsum("tpu", "dps"), 4),
            # codec X-ray: dispatches sum exactly (per-node cumulative
            # counters); pad-waste and overlap are worst-over-nodes (the
            # triage question is "is ANY node wasting its accelerator"),
            # compile events/seconds sum (cluster-wide recompile burden)
            "codecDispatches": dsum("codec", "dsp"),
            "codecPadWasteWorst": dmax("codec", "pw"),
            "codecCompileEvents": dsum("codec", "ce"),
            "codecCompileSeconds": round(dsum("codec", "cs"), 4),
            "codecOverlapEfficiencyWorst": dmax("codec", "ovl"),
            "codecLaneLingerP99SecondsWorst": dmax("codec", "ll99"),
            # durability observatory: per-node counts are OWNED blocks,
            # so sums are exact cluster totals; min-redundancy is the
            # min over nodes (distance from data loss), ETA the max
            # (the slowest node gates full redundancy)
            "durabilityHealthy": dsum("dur", "h"),
            "durabilityDegraded": dsum("dur", "dg"),
            "durabilityAtRisk": dsum("dur", "ar"),
            "durabilityUnreadable": dsum("dur", "ur"),
            "durabilityMinRedundancy": dmin("dur", "minr"),
            "repairEtaSecondsWorst": dmax("dur", "eta"),
            # nodes with missing pieces but NO eta (stalled/unmeasured):
            # dmax drops their None, so a healthy node's 0.0 would
            # otherwise mask a repair that isn't draining at all
            "repairEtaUnknownNodes": sum(
                1
                for r in with_digest
                if (_num(_dig(r, "dur", "mp"), 0.0) or 0.0) > 0
                and _num(_dig(r, "dur", "eta")) is None
            ),
            # rebalance observatory: version spread = newest layout
            # version anyone knows minus the oldest ack anyone reports
            # (0 = converged); worst |skew| bounds the merged event
            # timeline's ordering error
            "layoutVersionSpread": (
                (dmax("lt", "v") or 0) - (dmin("lt", "ack") or 0)
                if dmax("lt", "v") is not None
                and dmin("lt", "ack") is not None
                else 0
            ),
            "layoutNodesInTransition": sum(
                1
                for r in with_digest
                if (_num(_dig(r, "lt", "act"), 0.0) or 0.0) >= 2
            ),
            "clockSkewWorstMs": max(
                (
                    abs(v)
                    for r in with_digest
                    if (v := _num(_dig(r, "lt", "sk"))) is not None
                ),
                default=None,
            ),
            "clockSkewWarnMs": garage.config.admin.clock_skew_warn_msec,
            # tenant observatory: worst cluster-wide tenant ops share
            # (per-node tn.rows summed by tenant id first), distinct
            # tenants seen (fair share = 1/tenantsSeen), and the
            # fair-share-multiple knob the HOG! flag compares against
            "tenantHogShare": hog_share,
            "tenantsSeen": tenants_seen,
            "tenantHogShareWarn": garage.config.admin.tenant_hog_share,
        },
        "outliers": outliers,
        "slo": slo,
        # newest banked device-probe wedge verdict, per box, so this is
        # the ANSWERING node's probe history — null where no probe ever
        # failed (the key keeps the reference's name on the wire)
        "tpuProbe": _probe_summary(),
    }


def _probe_summary():
    from ..ops.telemetry import probe_failure_summary

    return probe_failure_summary()


def codec_response(garage) -> dict:
    """The one serialization of the codec X-ray, shared by admin
    `GET /v1/codec`, the admin-RPC `codec` op and the `cluster codec` /
    `codec top` CLI (key casing cannot drift between transports).

    `local` is the full ops/telemetry.codec_snapshot — per-kernel pad
    accounting, per-cache compile events, per-lane linger — read from
    this node's own registry.  Cluster rows come from the gossiped
    `codec.*` digest keys, so any node answers for all; a digest-less
    old peer renders `codec: null`, never an error.  Rows are NOT
    filtered to connected peers: the fields are cumulative process
    counters, and a dead peer's last-known compile/pad numbers are
    still the right triage input (unlike durability, nothing here is
    re-owned on failure, so nothing double-counts)."""
    from ..ops.telemetry import codec_snapshot

    system = garage.system
    system.expire_node_status()
    local = _valid_digest(garage.telemetry.collect()) or {}
    rows = [
        {
            "id": system.id.hex(),
            "isSelf": True,
            "isUp": True,
            "codec": local.get("codec"),
        }
    ]
    for pid, (pst, _ts) in sorted(system.node_status.items()):
        d = _valid_digest(pst.telemetry) or {}
        rows.append(
            {
                "id": pid.hex(),
                "isSelf": False,
                "isUp": system.netapp.is_connected(pid),
                "codec": d.get("codec"),
            }
        )
    with_codec = [r for r in rows if isinstance(r.get("codec"), dict)]

    def nsum(key: str) -> float:
        return sum(_num(r["codec"].get(key), 0.0) or 0.0 for r in with_codec)

    def nmax(key: str) -> float | None:
        vals = [
            v
            for r in with_codec
            if (v := _num(r["codec"].get(key))) is not None
        ]
        return max(vals) if vals else None

    return {
        "node": garage.node_id.hex(),
        "local": codec_snapshot(garage.telemetry.registry),
        "cluster": {
            "nodes": rows,
            "nodesReporting": len(with_codec),
            "aggregate": {
                # sums are exact (cumulative per-process counters);
                # waste/overlap/linger take the worst node — the triage
                # question is "is ANY node wasting its accelerator"
                "dispatches": nsum("dsp"),
                "padWasteWorst": nmax("pw"),
                "compileEvents": nsum("ce"),
                "compileSeconds": round(nsum("cs"), 4),
                "overlapEfficiencyWorst": nmax("ovl"),
                "laneLingerP99SecondsWorst": nmax("ll99"),
            },
        },
    }


# --- federated exposition -----------------------------------------------------

# family -> (type, help, digest path or callable(row))
_CLUSTER_FAMILIES: list[tuple[str, str, Any]] = [
    ("cluster_node_up", "node connected from the answering node",
     lambda row: 1.0 if row["isUp"] else 0.0),
    ("cluster_node_status_age_seconds", "age of the node's last status",
     lambda row: row["ageSecs"]),
    ("cluster_node_uptime_seconds", "node uptime", ("up",)),
    ("cluster_node_s3_requests_per_second", "S3 request rate", ("s3", "rps")),
    ("cluster_node_s3_errors_per_second", "S3 5xx rate", ("s3", "eps")),
    ("cluster_node_s3_p50_seconds", "S3 latency p50", ("s3", "p50")),
    ("cluster_node_s3_p99_seconds", "S3 latency p99", ("s3", "p99")),
    ("cluster_node_event_loop_lag_p99_seconds", "event-loop lag p99",
     ("loop", "p99")),
    ("cluster_node_event_loop_blocked_total", "loop stall episodes",
     ("loop", "blocked")),
    ("cluster_node_worker_errors", "cumulative worker errors",
     ("work", "errs")),
    ("cluster_node_resync_queue_length", "resync backlog", ("resync", "q")),
    ("cluster_node_resync_errored_blocks", "resync error blocks",
     ("resync", "err")),
    ("cluster_node_resync_oldest_error_age_seconds",
     "age of the node's oldest resync error", ("resync", "age")),
    ("cluster_node_repair_backlog", "repair-plan ledger backlog",
     ("repair", "backlog")),
    ("cluster_node_repair_backlog_critical",
     "repair-plan stripes one failure from loss", ("repair", "cr")),
    ("cluster_node_breakers_open", "peers behind an open breaker",
     ("rpc", "open")),
    ("cluster_node_tpu_dispatch_per_second", "TPU codec dispatch rate",
     ("tpu", "dps")),
    ("cluster_node_canary_probes", "cumulative canary probe legs",
     ("canary", "ops")),
    ("cluster_node_canary_errors", "cumulative failed canary probe legs",
     ("canary", "err")),
    ("cluster_node_canary_p99_seconds", "canary probe latency p99",
     ("canary", "p99")),
    ("cluster_node_disk_avail_bytes", "free disk bytes (meta dir)",
     lambda row: (row.get("metaDiskAvail") or (None,))[0]),
    ("cluster_node_overload_ladder_level",
     "overload degradation-ladder level (0 = healthy)", ("ovl", "lvl")),
    ("cluster_node_shed_requests", "cumulative admission-shed requests",
     ("ovl", "shed")),
    ("cluster_node_in_flight_requests", "admitted requests in flight",
     ("ovl", "inf")),
    # traffic observatory (rpc/traffic.py): numeric trf digest fields
    # only — the hot bucket NAME stays in the JSON surfaces, never a
    # label (metrics-lint cardinality guard)
    ("cluster_node_traffic_ops_total",
     "cumulative observatory-recorded S3 ops", ("trf", "ops")),
    ("cluster_node_traffic_ops_per_second",
     "observatory op rate", ("trf", "rps")),
    ("cluster_node_traffic_read_fraction",
     "read share of object traffic (GET+HEAD over all object ops)",
     ("trf", "rdf")),
    ("cluster_node_traffic_bytes_total",
     "cumulative object payload bytes moved", ("trf", "by")),
    ("cluster_node_traffic_hot_bucket_ops_per_second",
     "approximate op rate of the node's hottest bucket", ("trf", "hbps")),
    ("cluster_node_traffic_zipf_skew",
     "estimated zipf exponent of the key popularity", ("trf", "zipf")),
    # durability observatory (block/durability.py): numeric dur digest
    # fields only — zone NAMES stay in /v1/cluster/durability JSON,
    # never a label (metrics-lint cardinality discipline)
    ("cluster_node_durability_blocks_total",
     "blocks owned and classified by the node's ledger", ("dur", "tot")),
    ("cluster_node_durability_blocks_healthy",
     "owned blocks with all k+m pieces on live ranks", ("dur", "h")),
    ("cluster_node_durability_blocks_degraded",
     "owned blocks with k < live pieces < k+m", ("dur", "dg")),
    ("cluster_node_durability_blocks_at_risk",
     "owned blocks one failure away from loss (live == k)",
     ("dur", "ar")),
    ("cluster_node_durability_blocks_unreadable",
     "owned blocks below k live pieces", ("dur", "ur")),
    ("cluster_node_durability_missing_pieces",
     "pieces missing across the node's owned blocks", ("dur", "mp")),
    ("cluster_node_durability_min_redundancy",
     "worst live-minus-k margin across owned blocks (min over nodes = "
     "the cluster's distance from data loss)", ("dur", "minr")),
    ("cluster_node_durability_repair_eta_seconds",
     "estimated seconds until the repair backlog drains", ("dur", "eta")),
    ("cluster_node_durability_backlog_bytes",
     "estimated bytes of missing redundancy", ("dur", "bkb")),
    ("cluster_node_durability_zone_exposed_blocks",
     "owned blocks a single worst-zone loss would drop below k",
     ("dur", "zx")),
    ("cluster_node_layout_sync_fraction",
     "fraction of partitions synced to the current layout version",
     ("dur", "lt")),
    # codec X-ray (ops/telemetry.py codec_snapshot): dispatch
    # pad-waste, compile accounting, transfer/compute overlap, batcher
    # lane linger — per-kernel breakdowns stay in /v1/codec JSON, only
    # node-level scalars federate
    ("cluster_node_codec_dispatch_total",
     "cumulative device codec dispatches", ("codec", "dsp")),
    ("cluster_node_codec_pad_waste",
     "fraction of dispatched rows that were bucket padding",
     ("codec", "pw")),
    ("cluster_node_codec_compile_events",
     "cumulative compile events (cache misses + first-shape lowerings)",
     ("codec", "ce")),
    ("cluster_node_codec_compile_seconds",
     "cumulative wall seconds spent compiling", ("codec", "cs")),
    ("cluster_node_codec_overlap_efficiency",
     "wall over transfer-plus-compute (1.0 = fully sequential phases)",
     ("codec", "ovl")),
    ("cluster_node_codec_lane_linger_p99_seconds",
     "batcher lane linger p99 (arrival to dispatch)", ("codec", "ll99")),
    # metadata plane: effective table replication factor +
    # quorum sizes — a node whose meta RF disagrees with the cluster
    # stands out on one federated scrape
    ("cluster_node_meta_replication_factor",
     "effective metadata-table replication factor", ("meta", "rf")),
    ("cluster_node_meta_read_quorum",
     "metadata-table read quorum", ("meta", "rq")),
    ("cluster_node_meta_write_quorum",
     "metadata-table write quorum", ("meta", "wq")),
    # rebalance observatory (rpc/transition.py): each node's layout
    # version / CRDT tracker positions + transition progress + the
    # NTP-style clock skew the federated event timeline depends on —
    # (src, dst) pair breakdowns stay in /v1/cluster/transition JSON
    # and the node-local `layout_transition_pair_bytes_total` counter
    ("cluster_node_layout_version",
     "newest layout version the node knows", ("lt", "v")),
    ("cluster_node_layout_ack_version",
     "layout version the node has acked (CRDT ack tracker)",
     ("lt", "ack")),
    ("cluster_node_layout_sync_version",
     "layout version the node has fully synced to (CRDT sync tracker)",
     ("lt", "sync")),
    ("cluster_node_layout_active_versions",
     "layout versions with a ring assignment (2+ = transition open)",
     ("lt", "act")),
    ("cluster_node_layout_transition_bytes_moved",
     "bytes moved by the node during the open layout transition",
     ("lt", "mvb")),
    ("cluster_node_layout_transition_throughput_bytes_per_second",
     "EWMA rebalance ingest throughput during the open transition",
     ("lt", "thr")),
    ("cluster_node_layout_transition_eta_seconds",
     "estimated seconds until the node sees sync fraction 1.0",
     ("lt", "eta")),
    ("cluster_node_clock_skew_ms",
     "median NTP-style wall-clock offset vs peers (positive = peers "
     "ahead); the merged event timeline's ordering error bound",
     ("lt", "sk")),
    # tenant observatory (rpc/tenant.py): numeric tn digest scalars
    # only — tenant key ids stay in /v1/cluster/tenants JSON, never a
    # label (the cardinality rule)
    ("cluster_node_tenant_tracked",
     "distinct tenant keys the node's sketch currently tracks",
     ("tn", "trk")),
    ("cluster_node_tenant_ops_total",
     "cumulative tenant-attributed S3 ops", ("tn", "ops")),
    ("cluster_node_tenant_ops_per_second",
     "tenant-attributed op rate", ("tn", "rps")),
    ("cluster_node_tenant_sheds_total",
     "cumulative admission sheds joined to a claimed tenant",
     ("tn", "shed")),
    ("cluster_node_tenant_top1_share",
     "ops share of the node's busiest tenant", ("tn", "top1")),
    ("cluster_node_tenant_worst_burn",
     "worst per-tenant SLO burn rate on the node (availability or "
     "latency dimension)", ("tn", "wburn")),
    ("cluster_node_tenant_claimed_mismatches_total",
     "requests whose pre-auth claimed key id disagreed with the "
     "SigV4-authenticated id", ("tn", "mm")),
]


def render_cluster_metrics(garage) -> str:
    """Prometheus exposition of the cluster digest with a `node` label —
    one scrape of any node federates the whole cluster.  Passes the
    metrics-lint parser (one TYPE per family, before its samples, no
    duplicate (name, labels))."""
    rows = _node_rows(garage.system)
    outliers = detect_outliers(rows)
    lines: list[str] = []

    def lbl(row) -> str:
        return '{node="%s"}' % row["id"][:16]

    for fam, help_, src in _CLUSTER_FAMILIES:
        samples = []
        for row in rows:
            if callable(src):
                v = src(row)
            else:
                if row.get("digest") is None:
                    continue  # old peer without the field: no sample
                v = _dig(row, *src)
            if v is None:
                continue
            try:
                samples.append(f"{fam}{lbl(row)} {float(v):g}")
            except (TypeError, ValueError):
                continue  # one weird value must not 500 the endpoint
        if samples:
            lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} gauge")
            lines.extend(samples)

    lines.append("# HELP cluster_node_outlier MAD-flagged sick node")
    lines.append("# TYPE cluster_node_outlier gauge")
    for row in rows:
        lines.append(
            f"cluster_node_outlier{lbl(row)} "
            f"{1 if row['id'] in outliers else 0}"
        )
    lines.append("# TYPE cluster_outlier_nodes gauge")
    lines.append(f"cluster_outlier_nodes {len(outliers)}")
    lines.append("# TYPE cluster_nodes_reporting gauge")
    lines.append(
        "cluster_nodes_reporting "
        f"{sum(1 for r in rows if r.get('digest') is not None)}"
    )

    slo = _cluster_slo(
        garage, [r for r in rows if r.get("digest") is not None]
    )
    if slo is not None:
        lines.append("# TYPE cluster_slo_error_budget_remaining gauge")
        lines.append("# TYPE cluster_slo_burn_rate gauge")
        for kind, key in (("availability", "availability"),
                          ("latency_p99", "latencyP99")):
            s = slo[key]
            lines.append(
                f'cluster_slo_error_budget_remaining{{slo="{kind}"}} '
                f'{s["budgetRemaining"]:g}'
            )
            lines.append(
                f'cluster_slo_burn_rate{{slo="{kind}"}} {s["burnRate"]:g}'
            )
    return "\n".join(lines) + "\n"
