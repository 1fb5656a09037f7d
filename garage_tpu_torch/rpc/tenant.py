"""Tenant observatory: cluster-wide per-tenant usage accounting, SLO
burn, and fairness rollup.

The overload plane admits and sheds per node, so a tenant hammering
every frontend gets N× its intended budget and no surface can show it —
tenant identity, token consumption, shed counts and SLO burn existed
only node-locally.  This module is the measurement plane the later
enforcement (cluster-global budgets, coordinated shedding) will key
off:

  - `TenantObservatory` — a process-wide singleton (PhaseAggregator /
    TrafficObservatory discipline: in-process test nodes share one S3
    frontend path, so per-node instances would double-count) fed by the
    S3 request path AFTER SigV4 verification with the AUTHENTICATED key
    id (op class, bytes in/out, latency into a per-tenant windowed p99),
    and by the admission controller with per-tenant shed counts (keyed
    by the CLAIMED id — the only identity that exists at shed time) and
    queue waits.  Cardinality-bounded by construction: a Space-Saving
    top-K over tenant ids gates which tenants get an exact row; under
    the cap every row is exact, over it the coldest tenant's row is
    evicted (utils/sketch.py upper-bound discipline).

  - per-tenant SLO classes: `[tenants]` config maps class name ->
    availability target + latency target + member key ids; each
    tenant's window counters drive SloTracker-style burn against its
    own class targets.

  - surfaces: a bounded `tn.*` digest section gossiped on the existing
    anti-entropy exchange (additive keys, DIGEST_VERSION stays 1),
    federated as admin `GET /v1/cluster/tenants` + admin-RPC `tenants`
    (cluster-summed per-tenant consumption, fairness stats, per-node
    failure list like `/v1/cluster/durability`), numeric-only
    `cluster_node_tenant_*` families on `/metrics/cluster` (tenant
    NAMES stay in JSON, never labels — the cardinality rule),
    CLI `cluster tenants`, a `hog` column in `cluster top`, and a
    rate-bounded `tenant-hog` warn flight event that lands in the
    skew-corrected `cluster events` timeline.
"""

from __future__ import annotations

import logging
import math
import time
from collections import deque

from ..utils import metrics as metrics_mod
from ..utils.sketch import SpaceSaving
from .traffic import OP_KINDS, classify_op  # noqa: F401 — shared op taxonomy

logger = logging.getLogger("garage.tenant")

# class assigned to any authenticated key not listed under a `[tenants]`
# class — its targets come from the `default` class when one is
# configured, else these built-ins (mirrors `[admin] slo_*` defaults)
DEFAULT_CLASS = "default"
DEFAULT_AVAILABILITY_TARGET = 99.9
DEFAULT_LATENCY_TARGET_MSEC = 1000.0

# per-tenant latency ring: enough samples for a stable p99 without
# unbounded growth (the cardinality bound already caps row count)
_LAT_SAMPLES = 256

_LN2 = math.log(2.0)


def class_for(config, key_id: str) -> tuple[str, float, float]:
    """Resolve a key id to its `(class name, availability target frac,
    latency target secs)` from the LIVE `[tenants]` config (tests and
    operators mutate config post-construction).  Unknown keys fall to
    the `default` class."""
    tenants = getattr(config, "tenants", None) or {}
    cls, tc = None, None
    for name, c in tenants.items():
        if key_id in (c.keys or ()):
            cls, tc = name, c
            break
    if tc is None:
        cls, tc = DEFAULT_CLASS, tenants.get(DEFAULT_CLASS)
    avail = (
        tc.availability_target if tc is not None
        else DEFAULT_AVAILABILITY_TARGET
    )
    lat_ms = (
        tc.latency_target_msec if tc is not None
        else DEFAULT_LATENCY_TARGET_MSEC
    )
    return cls, min(float(avail), 100.0) / 100.0, float(lat_ms) / 1000.0


class TenantObservatory:
    """Streaming per-process per-tenant usage summary.  All updates are
    O(1) dict/sketch arithmetic — safe on the request path, no I/O."""

    # rolling window for per-tenant burn (SloTracker discipline: the
    # oldest in-window snapshot vs now, so scrape rate can't change the
    # math); snapshots coalesce at 1 s so the deque stays bounded
    window = 600.0
    _snap_coalesce = 1.0

    def __init__(
        self,
        topk: int = 64,
        halflife: float | None = 600.0,
        clock=time.monotonic,
    ):
        self.topk = int(topk)
        self.halflife = halflife
        self.clock = clock
        self.enabled = False
        # per-CLASS exposition counters ride the process registry: class
        # names are config-declared (bounded), unlike tenant key ids
        # which never become labels.  Injectable for per-node tests.
        self.registry = metrics_mod.registry
        # key id -> class NAME for pre-auth sheds (set by model/garage.py
        # against its live config; None means "default")
        self.class_resolver = None
        self._reset_state()

    def _reset_state(self) -> None:
        # the sketch decides WHICH tenants deserve an exact row: every
        # tracked row's key is in sketch.counts, so len(rows) <= topk is
        # structural, and "hot" means hot NOW (decayed weights)
        self.sketch = SpaceSaving(
            self.topk, halflife=self.halflife, clock=self.clock
        )
        self.tenants: dict[str, dict] = {}
        self.mismatches = 0
        self.total_sheds = 0

    def reset(self) -> None:
        """Drop all accumulated state (test/bench isolation — the
        singleton outlives any one in-process node)."""
        self._reset_state()

    def reconfigure(self, topk: int, halflife: float | None) -> None:
        """Apply sizing knobs; resets state only when they changed (the
        sketch's capacity is baked into its eviction bound)."""
        if (int(topk), halflife) == (self.topk, self.halflife):
            return
        self.topk = int(topk)
        self.halflife = halflife
        self._reset_state()

    # --- row admission (the cardinality bound) -------------------------------

    def _new_row(self) -> dict:
        return {
            "ops": dict.fromkeys(OP_KINDS, 0),
            "bin": 0,       # request payload bytes (tenant -> cluster)
            "bout": 0,      # response payload bytes (cluster -> tenant)
            "lat": deque(maxlen=_LAT_SAMPLES),
            "shed": 0,
            "qw_n": 0,
            "qw_s": 0.0,
            "req": 0,       # cumulative requests (availability window)
            "err": 0,       # cumulative 5xx
            "lat_n": 0,     # cumulative latency-observed
            "lat_over": 0,  # cumulative over-target
            "cls": DEFAULT_CLASS,
            "avail_t": DEFAULT_AVAILABILITY_TARGET / 100.0,
            "lat_t": DEFAULT_LATENCY_TARGET_MSEC / 1000.0,
            # (t, req, err, lat_n, lat_over) window snapshots
            "snaps": deque(),
        }

    def _row(self, key_id: str, weight: float = 1.0) -> dict:
        """Admit `key_id` through the Space-Saving gate and return its
        exact row.  Over capacity the newcomer evicts the coldest
        tenant's row (its sketch count carries the upper bound); rows
        whose key fell out of the sketch are pruned so the row dict can
        never outgrow the sketch."""
        self.sketch.incr(key_id, weight)
        row = self.tenants.get(key_id)
        if row is None:
            row = self._new_row()
            self.tenants[key_id] = row
            if len(self.tenants) > len(self.sketch.counts):
                for k in list(self.tenants):
                    if k not in self.sketch.counts:
                        del self.tenants[k]
        return row

    # --- the S3 request-path hooks -------------------------------------------

    def record_request(
        self,
        key_id: str,
        op: str,
        bytes_in: int,
        bytes_out: int,
        secs: float,
        is_err: bool,
        queued_secs: float = 0.0,
        tenant_class: tuple[str, float, float] | None = None,
    ) -> None:
        """One admitted, AUTHENTICATED S3 request (shed 503s never get
        here — the overload plane's invariant; they arrive via
        record_shed keyed by the claimed id).  `tenant_class` is
        `class_for(...)`'s triple, resolved by the caller against its
        live config.  Must never raise: it runs in the request
        handler's finally."""
        if not self.enabled or not key_id:
            return
        row = self._row(key_id)
        if tenant_class is not None:
            row["cls"], row["avail_t"], row["lat_t"] = tenant_class
        row["ops"][op if op in row["ops"] else "other"] += 1
        row["bin"] += max(0, int(bytes_in or 0))
        row["bout"] += max(0, int(bytes_out or 0))
        row["lat"].append(secs)
        if queued_secs:
            row["qw_n"] += 1
            row["qw_s"] += queued_secs
        row["req"] += 1
        if is_err:
            row["err"] += 1
        row["lat_n"] += 1
        over = secs > row["lat_t"]
        if over:
            row["lat_over"] += 1
        # class-level counters (Grafana per-class burn panels): the
        # `class` label's value set is config-bounded and enrolled in
        # BOUNDED_LABEL_VALUES (script/dashboard_lint.py)
        lbl = (("class", row["cls"]),)
        self.registry.incr("api_tenant_class_requests_total", lbl)
        if is_err:
            self.registry.incr("api_tenant_class_errors_total", lbl)
        if over:
            self.registry.incr("api_tenant_class_over_latency_total", lbl)

    def record_shed(self, key_id: str) -> None:
        """One admission shed, keyed by the CLAIMED key id — the only
        identity that exists at shed time (pre-SigV4).  A pure-shed
        abuser must still surface, so sheds ride the same Space-Saving
        admission as requests."""
        if not self.enabled or not key_id:
            return
        self.total_sheds += 1
        self._row(key_id)["shed"] += 1
        cls = None
        if self.class_resolver is not None:
            try:
                cls = self.class_resolver(key_id)
            except Exception:  # noqa: BLE001
                # a broken resolver must not turn a shed into a crash
                cls = None  # graft-lint: allow-swallow(shed still counts, under the default class)
        self.registry.incr(
            "api_tenant_class_sheds_total",
            (("class", cls or DEFAULT_CLASS),),
        )

    def record_mismatch(self) -> None:
        """Claimed key id != authenticated key id (spoofed or mangled
        Credential): counted, never attributed to a tenant row."""
        if not self.enabled:
            return
        self.mismatches += 1

    # --- derived numbers ------------------------------------------------------

    @property
    def total_ops(self) -> int:
        return sum(sum(r["ops"].values()) for r in self.tenants.values())

    def _rate(self, count: float) -> float:
        """Approximate ops/s of a decayed sketch count (the decayed
        counter equilibrates at r * halflife / ln 2)."""
        if self.halflife:
            return count * _LN2 / self.halflife
        return 0.0

    def _p99(self, row: dict) -> float | None:
        lat = row["lat"]
        if not lat:
            return None
        s = sorted(lat)
        return s[min(len(s) - 1, int(0.99 * (len(s) - 1) + 0.999))]

    def _burn(self, row: dict) -> dict:
        """SloTracker-style burn for one tenant against its class
        targets: bad-fraction over the rolling window divided by the
        allowed fraction.  Returns window counts too so the federated
        rollup can re-derive an exact cluster-wide burn from sums."""
        now = self.clock()
        snaps = row["snaps"]
        cur = (now, row["req"], row["err"], row["lat_n"], row["lat_over"])
        if snaps and now - snaps[-1][0] < self._snap_coalesce:
            snaps[-1] = cur
        else:
            snaps.append(cur)
        while snaps and now - snaps[0][0] > self.window:
            snaps.popleft()
        first = snaps[0]
        a_n, a_bad = cur[1] - first[1], cur[2] - first[2]
        l_n, l_bad = cur[3] - first[3], cur[4] - first[4]
        # the window's boundary snapshot itself holds the oldest counts:
        # with a single snapshot the deltas are 0 (no window yet), so
        # fall back to the cumulative counters — a fresh tenant's first
        # errors must burn immediately, not after the coalesce interval
        if a_n == 0 and l_n == 0 and len(snaps) == 1:
            a_n, a_bad = cur[1], cur[2]
            l_n, l_bad = cur[3], cur[4]
        a_allowed = max(1.0 - row["avail_t"], 1e-9)
        l_allowed = a_allowed

        def burn(n, bad, allowed):
            return (bad / n) / allowed if n > 0 else 0.0

        ab = burn(a_n, a_bad, a_allowed)
        lb = burn(l_n, l_bad, l_allowed)
        return {
            "avail": round(ab, 4),
            "lat": round(lb, 4),
            "worst": round(max(ab, lb), 4),
            "an": a_n,
            "abad": a_bad,
            "ln": l_n,
            "lbad": l_bad,
        }

    # --- serializations -------------------------------------------------------

    def snapshot(self, top_n: int = 20) -> dict:
        """The local half of `GET /v1/cluster/tenants`: exact rows for
        the top-N tenants by decayed weight."""
        rows = []
        total = max(self.total_ops, 1)
        for key_id, c, e in self.sketch.top(top_n):
            row = self.tenants.get(key_id)
            if row is None:
                continue
            b = self._burn(row)
            ops_total = sum(row["ops"].values())
            p99 = self._p99(row)
            rows.append(
                {
                    "id": key_id,
                    "class": row["cls"],
                    "ops": ops_total,
                    "opMix": {k: v for k, v in row["ops"].items() if v},
                    "opsPerSec": round(self._rate(c), 4),
                    "share": round(ops_total / total, 4),
                    "bytesIn": row["bin"],
                    "bytesOut": row["bout"],
                    "p99Ms": round(p99 * 1000, 3) if p99 is not None else None,
                    "queueWaitMeanMs": (
                        round(row["qw_s"] / row["qw_n"] * 1000, 3)
                        if row["qw_n"]
                        else None
                    ),
                    "shed": row["shed"],
                    "burn": {
                        "availability": b["avail"],
                        "latency": b["lat"],
                        "worst": b["worst"],
                    },
                    "sketchWeight": round(c, 2),
                    "sketchError": round(e, 2),
                }
            )
        return {
            "trackedTenants": len(self.tenants),
            "totalOps": self.total_ops,
            "sheds": self.total_sheds,
            "claimedMismatches": self.mismatches,
            "tenants": rows,
            "decayHalflifeSecs": self.halflife,
            "windowSecs": self.window,
        }

    def digest_fields(self, rps: float = 0.0, top_n: int = 5) -> dict:
        """Compact `tn.*` block for the gossiped node digest (additive
        keys, DIGEST_VERSION stays 1).  `rps` is the collector's
        windowed op rate.  Bounded: scalar summary + top-N rows; tenant
        ids appear as JSON VALUES only, never metric labels."""
        total = max(self.total_ops, 1)
        rows = []
        wburn = 0.0
        top1 = 0.0
        for key_id, c, _e in self.sketch.top(top_n):
            row = self.tenants.get(key_id)
            if row is None:
                continue
            b = self._burn(row)
            wburn = max(wburn, b["worst"])
            ops_total = sum(row["ops"].values())
            top1 = max(top1, ops_total / total)
            rows.append(
                {
                    "id": key_id,
                    "cls": row["cls"],
                    "ops": ops_total,
                    "rps": round(self._rate(c), 4),
                    "by": row["bin"] + row["bout"],
                    "shed": row["shed"],
                    "burn": b["worst"],
                    "an": b["an"],
                    "abad": b["abad"],
                    "ln": b["ln"],
                    "lbad": b["lbad"],
                }
            )
        # worst burn must scan EVERY row, not just the top-N by weight:
        # a small tenant blowing its budget is exactly the signal
        for row in self.tenants.values():
            if len(rows) >= len(self.tenants):
                break
            wburn = max(wburn, self._burn(row)["worst"])
        return {
            "trk": len(self.tenants),
            "ops": self.total_ops,
            "rps": round(rps, 4),
            "shed": self.total_sheds,
            "mm": self.mismatches,
            "top1": round(top1, 4),
            "wburn": round(wburn, 4),
            "rows": rows,
        }


# process-wide observatory: the S3 frontends of every in-process node
# feed it (PhaseAggregator pattern — per-node instances would
# double-count through the shared request path)
observatory = TenantObservatory()

_refs = 0


def enable(topk: int | None = None, halflife: float | None = None) -> None:
    """Refcounted attach (every in-process Garage with `[admin]
    tenant_observatory` calls this at start).  Sizing knobs apply only
    on the 0 -> 1 transition — reconfiguring mid-flight would reset the
    rows under the other nodes."""
    global _refs
    if _refs == 0 and topk is not None:
        observatory.reconfigure(topk, halflife)
    _refs += 1
    observatory.enabled = True


def disable() -> None:
    global _refs
    _refs = max(0, _refs - 1)
    if _refs == 0:
        observatory.enabled = False


# --- cluster rollup + the one serialization per endpoint ----------------------


def _tenant_rows(garage) -> list[dict]:
    """Per-node `tn` digest rows from the gossip state.  A digest-less
    old peer renders a clean row with `tenant: null` — never an error,
    never dropped (the `/v1/cluster/durability` per-node-failure-list
    discipline)."""
    from .telemetry_digest import _valid_digest

    system = garage.system
    system.expire_node_status()
    local = _valid_digest(garage.telemetry.collect()) or {}
    rows = [
        {
            "id": system.id.hex(),
            "isSelf": True,
            "isUp": True,
            "tenant": local.get("tn"),
        }
    ]
    for pid, (pst, _ts) in sorted(system.node_status.items()):
        d = _valid_digest(pst.telemetry) or {}
        rows.append(
            {
                "id": pid.hex(),
                "isSelf": False,
                "isUp": system.netapp.is_connected(pid),
                "tenant": d.get("tn"),
            }
        )
    return rows


def _num(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


# rate bound for the tenant-hog flight event: one emission per tenant
# per this many seconds — the rollup runs on every scrape/CLI refresh
# and the timeline must not drown in repeats
_HOG_EVENT_MIN_INTERVAL = 60.0
_hog_last: dict[str, float] = {}


def _maybe_hog_event(garage, hog: dict) -> None:
    """Emit the `tenant-hog` warn flight event (rate-bounded per
    tenant), landing in the node's flight recorder and from there in
    the merged skew-corrected `cluster events` timeline."""
    now = time.monotonic()
    last = _hog_last.get(hog["id"])
    if last is not None and now - last < _HOG_EVENT_MIN_INTERVAL:
        return
    _hog_last[hog["id"]] = now
    try:
        from ..utils.flight import record_event

        record_event(
            "tenant-hog",
            {
                "tenant": hog["id"],
                "class": hog.get("class"),
                "share": round(hog["share"], 4),
                "fair_share": round(hog["fairShare"], 4),
                "multiple": round(hog["multiple"], 2),
                "warn_multiple": hog["warnMultiple"],
            },
            severity="warn",
        )
    except Exception as e:  # noqa: BLE001
        # graft-lint: allow-swallow(observability-of-observability: a broken flight recorder must not fail the tenants endpoint)
        logger.debug("tenant-hog event emission failed: %r", e)


def tenants_response(garage) -> dict:
    """The one serialization of the tenant observatory, shared by admin
    `GET /v1/cluster/tenants`, the admin-RPC `tenants` op and the
    `cluster tenants` CLI (key casing cannot drift between transports).

    Cluster rows come from the gossiped `tn.*` digest keys, so any node
    answers for all; the per-tenant table sums consumption across every
    reporting node's top-N rows, and cluster-wide burn is re-derived
    from the summed window counts (exact where the digests carry the
    tenant, a lower bound where a node's top-N cut dropped it)."""
    rows = _tenant_rows(garage)
    with_tn = [r for r in rows if isinstance(r.get("tenant"), dict)]

    # cluster-summed per-tenant table keyed by tenant id
    table: dict[str, dict] = {}
    for r in with_tn:
        for t in r["tenant"].get("rows") or []:
            if not isinstance(t, dict) or not t.get("id"):
                continue
            e = table.setdefault(
                str(t["id"]),
                {
                    "class": t.get("cls"),
                    "ops": 0.0,
                    "opsPerSec": 0.0,
                    "bytes": 0.0,
                    "shed": 0.0,
                    "an": 0.0,
                    "abad": 0.0,
                    "ln": 0.0,
                    "lbad": 0.0,
                    "burnMaxNode": 0.0,
                    "nodes": 0,
                },
            )
            e["class"] = t.get("cls") or e["class"]
            e["ops"] += _num(t.get("ops"))
            e["opsPerSec"] += _num(t.get("rps"))
            e["bytes"] += _num(t.get("by"))
            e["shed"] += _num(t.get("shed"))
            e["an"] += _num(t.get("an"))
            e["abad"] += _num(t.get("abad"))
            e["ln"] += _num(t.get("ln"))
            e["lbad"] += _num(t.get("lbad"))
            e["burnMaxNode"] = max(e["burnMaxNode"], _num(t.get("burn")))
            e["nodes"] += 1

    # cluster-wide burn per tenant from the summed window counts,
    # against the class targets as THIS node's config resolves them
    tenants_cfg = getattr(garage.config, "tenants", None) or {}
    tenant_list = []
    total_ops = sum(e["ops"] for e in table.values()) or 1.0
    for tid, e in table.items():
        tc = tenants_cfg.get(e["class"]) if e["class"] else None
        avail = (
            min(float(tc.availability_target), 100.0) / 100.0
            if tc is not None
            else DEFAULT_AVAILABILITY_TARGET / 100.0
        )
        allowed = max(1.0 - avail, 1e-9)
        ab = (e["abad"] / e["an"]) / allowed if e["an"] > 0 else 0.0
        lb = (e["lbad"] / e["ln"]) / allowed if e["ln"] > 0 else 0.0
        tenant_list.append(
            {
                "id": tid,
                "class": e["class"],
                "ops": e["ops"],
                "opsPerSec": round(e["opsPerSec"], 4),
                "bytes": e["bytes"],
                "shed": e["shed"],
                "share": round(e["ops"] / total_ops, 4),
                "nodesReporting": e["nodes"],
                "burn": {
                    "availability": round(ab, 4),
                    "latency": round(lb, 4),
                    "worst": round(max(ab, lb, e["burnMaxNode"]), 4),
                },
            }
        )
    tenant_list.sort(key=lambda t: (-t["ops"], t["id"]))

    # fairness stats over the cluster-summed consumption
    warn_multiple = garage.config.admin.tenant_hog_share
    n_tenants = len(tenant_list)
    shares = [t["share"] for t in tenant_list]
    fair = 1.0 / n_tenants if n_tenants else 0.0
    med = sorted(t["ops"] for t in tenant_list)[n_tenants // 2] if n_tenants else 0.0
    fairness = {
        "tenants": n_tenants,
        "fairShare": round(fair, 4),
        "top1Share": round(max(shares), 4) if shares else 0.0,
        "maxMedianRatio": (
            round(tenant_list[0]["ops"] / med, 2) if med > 0 else None
        ),
        "worstBurn": (
            round(max(t["burn"]["worst"] for t in tenant_list), 4)
            if tenant_list
            else 0.0
        ),
        "hogShareWarnMultiple": warn_multiple,
    }

    # hog verdict: the top tenant's cluster-wide share vs a fair-share
    # multiple — needs >= 2 tenants (a sole tenant owning 100% is not
    # hogging anything)
    hog = None
    if n_tenants >= 2 and tenant_list[0]["share"] > warn_multiple * fair:
        t0 = tenant_list[0]
        hog = {
            "id": t0["id"],
            "class": t0["class"],
            "share": t0["share"],
            "fairShare": fair,
            "multiple": round(t0["share"] / fair, 2) if fair else None,
            "warnMultiple": warn_multiple,
        }
        _maybe_hog_event(garage, hog)

    return {
        "node": garage.node_id.hex(),
        "enabled": _refs > 0,
        "local": observatory.snapshot(),
        "cluster": {
            "nodes": rows,
            "nodesReporting": len(with_tn),
            "aggregate": {
                "trackedTenants": (
                    max(_num(r["tenant"].get("trk")) for r in with_tn)
                    if with_tn
                    else 0
                ),
                "ops": sum(_num(r["tenant"].get("ops")) for r in with_tn),
                "opsPerSec": round(
                    sum(_num(r["tenant"].get("rps")) for r in with_tn), 4
                ),
                "sheds": sum(
                    _num(r["tenant"].get("shed")) for r in with_tn
                ),
                "claimedMismatches": sum(
                    _num(r["tenant"].get("mm")) for r in with_tn
                ),
            },
            "tenants": tenant_list,
            "fairness": fairness,
            "hog": hog,
        },
    }
