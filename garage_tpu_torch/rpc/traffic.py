"""Traffic heat observatory: streaming hot-object analytics, per-peer
read attribution, and replayable workload profiles.

The latency X-ray says which *phase* of a request was slow and
the cluster digest says which *node* is sick — but nothing could
say which *object* is hot, how skewed the keyspace is, what the
read/write mix looks like, or which peer is the slow rank on an EC GET.
A hot-object cache, hedged systematic reads and a workload generator
all need exactly those numbers first.

  - `TrafficObservatory` — a process-wide singleton (PhaseAggregator
    discipline: several in-process test nodes share one registry and
    one S3 frontend path, so per-node instances would double-count)
    fed by the S3 request path with (op, bucket, key, bytes, latency).
    Bounded memory by construction: Space-Saving top-K over object
    keys and buckets, a Count-Min sketch over the full keyspace, a
    log2 object-size histogram, per-op counters and streaming
    inter-arrival moments (utils/sketch.py).  NO per-key metrics
    families — hot-key data is served from the JSON endpoints only
    (the metrics-lint cardinality guard enforces this).

  - per-peer `piece_fetch` attribution rides the peer-health
    structures (rpc/peer_health.py `record_piece_fetch`): latency /
    bytes EWMAs per peer from the EC read path, surfacing the
    "slow rank" ranking hedged reads key off.

  - surfaces: admin `GET /v1/traffic` (top-K, mix, skew, slow peers,
    cluster rollup from the gossiped `trf.*` digest keys),
    `GET /v1/traffic/profile` (a REPLAYABLE workload profile: op mix,
    size distribution, popularity skew, inter-arrival stats — the
    contract item 5's generator consumes), admin-RPC + `cli cluster
    hot`, federated `cluster_node_traffic_*` families on
    `/metrics/cluster`, and a `hot` column in `cluster top`.
"""

from __future__ import annotations

import logging
import math
import time

from ..utils.sketch import CountMin, SpaceSaving, zipf_exponent

logger = logging.getLogger("garage.traffic")

# operation classes tracked by the observatory — CLOSED like the latency
# phase catalogue so the op-mix surface stays bounded
OP_KINDS = ("get", "put", "head", "delete", "list", "other")
READ_OPS = frozenset({"get", "head"})
WRITE_OPS = frozenset({"put", "delete"})

# object-size histogram bounds: pow2 bytes, 1 B .. 1 GiB (+overflow)
SIZE_BOUNDS = [2 ** i for i in range(31)]

_LN2 = math.log(2.0)


def classify_op(method: str, key: str, query) -> str:
    """S3 request -> op class.  `query` is the request's query mapping
    (only key membership is read)."""
    if method == "GET":
        return "get" if key else "list"
    if method == "HEAD":
        return "head"
    if method == "PUT":
        return "put"
    if method == "DELETE":
        return "delete"
    if method == "POST":
        if "delete" in query:
            return "delete"  # DeleteObjects
        if "uploads" in query or "uploadId" in query:
            # multipart initiate/complete: control-plane — the body is
            # an XML manifest, not object payload; counting it as a
            # "put" would inject ~1 KiB samples into the size histogram
            # the workload generator replays (the data moved through
            # the part PUTs, already recorded)
            return "other"
        return "put"  # PostObject browser form upload
    return "other"


class TrafficObservatory:
    """Streaming per-process S3 traffic summary.  All updates are O(1)
    dict/sketch arithmetic (lazy decay sweeps are O(capacity), at most
    ~16 per halflife) — safe on the request path, no numpy, no I/O."""

    def __init__(
        self,
        topk: int = 256,
        halflife: float | None = 600.0,
        clock=time.monotonic,
    ):
        self.topk = int(topk)
        self.halflife = halflife
        self.clock = clock
        self.enabled = False
        self._reset_state()

    def _reset_state(self) -> None:
        hl, clock = self.halflife, self.clock
        self.keys = SpaceSaving(self.topk, halflife=hl, clock=clock)
        self.buckets = SpaceSaving(
            max(16, self.topk // 4), halflife=hl, clock=clock
        )
        self.key_freq = CountMin(width=2048, depth=4, halflife=hl, clock=clock)
        self.ops: dict[str, int] = dict.fromkeys(OP_KINDS, 0)
        self.bytes_moved = 0
        # op -> [count, sum_secs, max_secs]
        self.latency: dict[str, list[float]] = {
            op: [0, 0.0, 0.0] for op in OP_KINDS
        }
        self.size_counts = [0] * (len(SIZE_BOUNDS) + 1)
        # streaming inter-arrival moments: n, sum dt, sum dt^2
        self._last_arrival: float | None = None
        self._ia = [0, 0.0, 0.0]
        self.started_at = clock()

    def reset(self) -> None:
        """Drop all accumulated state (test/bench isolation — the
        singleton outlives any one in-process node)."""
        self._reset_state()

    def reconfigure(self, topk: int, halflife: float | None) -> None:
        """Apply sizing knobs; resets state only when they changed (the
        sketches' geometry is baked into their arrays)."""
        if (int(topk), halflife) == (self.topk, self.halflife):
            return
        self.topk = int(topk)
        self.halflife = halflife
        self._reset_state()

    # --- the S3 request-path hook --------------------------------------------

    def record_http(
        self, method: str, bucket: str, key: str, query,
        nbytes: int, secs: float,
    ) -> None:
        """One admitted S3 request (shed 503s are not traffic — the
        overload plane's invariant).  Must never raise: it runs in the
        request handler's finally."""
        if not self.enabled:
            return
        op = classify_op(method, key, query)
        self.ops[op] += 1
        lat = self.latency[op]
        lat[0] += 1
        lat[1] += secs
        if secs > lat[2]:
            lat[2] = secs
        now = self.clock()
        if self._last_arrival is not None:
            dt = max(0.0, now - self._last_arrival)
            self._ia[0] += 1
            self._ia[1] += dt
            self._ia[2] += dt * dt
        self._last_arrival = now
        if bucket:
            self.buckets.incr(bucket)
            if key:
                composite = f"{bucket}/{key}"
                self.keys.incr(composite)
                self.key_freq.incr(composite)
        if nbytes and op in ("get", "put"):
            self.bytes_moved += nbytes
            i = min(
                max(0, (int(nbytes) - 1).bit_length()), len(SIZE_BOUNDS)
            )
            self.size_counts[i] += 1

    # --- derived numbers ------------------------------------------------------

    @property
    def total_ops(self) -> int:
        return sum(self.ops.values())

    def read_fraction(self) -> float | None:
        reads = sum(self.ops[o] for o in READ_OPS)
        writes = sum(self.ops[o] for o in WRITE_OPS)
        return (
            round(reads / (reads + writes), 4) if reads + writes else None
        )

    # fit the skew on the top-20 ranks only: deeper Space-Saving ranks
    # carry eviction-inflated counts (the error bound grows toward the
    # tail), which flattens the fitted slope toward uniform
    _ZIPF_RANKS = 20

    def _zipf(self, top: list[tuple[str, float, float]]) -> float | None:
        return zipf_exponent(
            [c for _k, c, _e in top[: self._ZIPF_RANKS]]
        )

    def _hot_bucket(self) -> tuple[str, float] | None:
        top = self.buckets.top(1)
        return (top[0][0], top[0][1]) if top else None

    def _hot_bucket_rate(self, count: float) -> float:
        """Approximate ops/s of a decayed count: at steady rate r the
        decayed counter equilibrates at r * halflife / ln 2 (the mean
        lifetime), so invert that.  Without decay: count / uptime."""
        if self.halflife:
            return count * _LN2 / self.halflife
        up = max(self.clock() - self.started_at, 1e-9)
        return count / up

    # --- serializations -------------------------------------------------------

    def snapshot(self, top_n: int = 20) -> dict:
        """The local half of `GET /v1/traffic`."""
        top_keys = self.keys.top(top_n)
        top_buckets = self.buckets.top(10)
        total = self.total_ops
        sizes = [
            {"le": SIZE_BOUNDS[i] if i < len(SIZE_BOUNDS) else None,
             "count": c}
            for i, c in enumerate(self.size_counts)
            if c
        ]
        key_total = max(self.keys.total, 1e-9)
        bucket_total = max(self.buckets.total, 1e-9)
        hot_objects = []
        for k, c, e in top_keys:
            b, _, rest = k.partition("/")
            hot_objects.append(
                {
                    "bucket": b,
                    "key": rest,
                    "count": round(c, 2),
                    "errorBound": round(e, 2),
                    "cmEstimate": round(self.key_freq.estimate(k), 2),
                    "share": round(c / key_total, 4),
                }
            )
        return {
            "totalOps": total,
            "opMix": dict(self.ops),
            "readFraction": self.read_fraction(),
            "bytesMoved": self.bytes_moved,
            "hotObjects": hot_objects,
            "hotBuckets": [
                {
                    "bucket": k,
                    "count": round(c, 2),
                    "share": round(c / bucket_total, 4),
                    "opsPerSec": round(self._hot_bucket_rate(c), 4),
                }
                for k, c, _e in top_buckets
            ],
            "sizeHistogram": sizes,
            "zipfS": self._zipf(top_keys),
            "latency": {
                op: {
                    "count": int(n),
                    "meanMs": round(s / n * 1000, 3) if n else None,
                    "maxMs": round(mx * 1000, 3),
                }
                for op, (n, s, mx) in self.latency.items()
                if n
            },
            "decayHalflifeSecs": self.halflife,
            "trackedKeys": len(self.keys),
        }

    def profile(self) -> dict:
        """The REPLAYABLE workload profile (`GET /v1/traffic/profile`):
        everything a generator needs to synthesize statistically-similar
        load — op mix, object-size distribution, popularity skew,
        inter-arrival stats.  Deliberately anonymous: shares and
        distributions, no tenant key names."""
        total = self.total_ops
        n, s, s2 = self._ia
        mean_ia = s / n if n else None
        if n > 1 and mean_ia:
            var = max(0.0, s2 / n - mean_ia * mean_ia)
            cv = round(math.sqrt(var) / mean_ia, 4)
        else:
            cv = None
        top = self.keys.top(50)
        key_total = max(self.keys.total, 1e-9)
        size_n = sum(self.size_counts) or 1
        return {
            "profileVersion": 1,
            "totalOps": total,
            "opMix": {
                op: round(c / total, 4) if total else 0.0
                for op, c in self.ops.items()
            },
            "readFraction": self.read_fraction(),
            "sizeDistribution": {
                "logTwoBuckets": [
                    {
                        "leBytes": (
                            SIZE_BOUNDS[i] if i < len(SIZE_BOUNDS) else None
                        ),
                        "fraction": round(c / size_n, 4),
                    }
                    for i, c in enumerate(self.size_counts)
                    if c
                ],
                "meanBytes": (
                    round(self.bytes_moved / size_n, 1)
                    if sum(self.size_counts)
                    else None
                ),
            },
            "popularity": {
                "zipfS": self._zipf(top),
                "topShares": [
                    round(c / key_total, 4) for _k, c, _e in top[:10]
                ],
                "trackedKeys": len(self.keys),
            },
            "interArrival": {
                "meanSecs": round(mean_ia, 6) if mean_ia else None,
                "cv": cv,
                "opsPerSec": (
                    round(1.0 / mean_ia, 4) if mean_ia else None
                ),
            },
            "decayHalflifeSecs": self.halflife,
        }

    def digest_fields(self, rps: float = 0.0) -> dict:
        """Compact `trf.*` block for the gossiped node digest
        (rpc/telemetry_digest.py; additive keys, DIGEST_VERSION stays
        1).  `rps` is the collector's windowed op rate."""
        reads = sum(self.ops[o] for o in READ_OPS)
        writes = sum(self.ops[o] for o in WRITE_OPS)
        hb = self._hot_bucket()
        out: dict = {
            "ops": self.total_ops,
            "rps": round(rps, 4),
            "rd": reads,
            "wr": writes,
            "ls": self.ops["list"],
            "by": self.bytes_moved,
            "rdf": self.read_fraction(),
            "zipf": self._zipf(self.keys.top(self._ZIPF_RANKS)),
        }
        if hb is not None:
            out["hb"] = hb[0]
            out["hbo"] = round(hb[1], 2)
            out["hbps"] = round(self._hot_bucket_rate(hb[1]), 4)
        return out


# process-wide observatory: the S3 frontends of every in-process node
# feed it and the registry it summarizes for is process-global — per-node
# instances would multiply every observation (PhaseAggregator pattern)
observatory = TrafficObservatory()

_refs = 0


def enable(topk: int | None = None, halflife: float | None = None) -> None:
    """Refcounted attach (every in-process Garage with `[admin]
    traffic_observatory` calls this at start).  Sizing knobs apply only
    on the 0 -> 1 transition — reconfiguring mid-flight would reset the
    sketches under the other nodes."""
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


def slow_peers(garage) -> list[dict]:
    """The slow-rank ranking from this node's viewpoint (peer-health
    piece-fetch EWMAs) — what item 1a's hedged reads will key off."""
    ph = getattr(garage, "peer_health", None)
    if ph is None:
        return []
    return ph.piece_fetch_ranking()


def _traffic_rows(garage) -> list[dict]:
    """Per-node `trf` digest rows from the gossip state.  A digest-less
    old peer (or a peer on a different digest version) renders a clean
    row with `traffic: null` — never an error, never dropped."""
    from .telemetry_digest import _valid_digest

    system = garage.system
    system.expire_node_status()
    local = _valid_digest(garage.telemetry.collect()) or {}
    rows = [
        {
            "id": system.id.hex(),
            "isSelf": True,
            "isUp": True,
            "traffic": local.get("trf"),
        }
    ]
    for pid, (pst, _ts) in sorted(system.node_status.items()):
        d = _valid_digest(pst.telemetry) or {}
        rows.append(
            {
                "id": pid.hex(),
                "isSelf": False,
                "isUp": system.netapp.is_connected(pid),
                "traffic": d.get("trf"),
            }
        )
    return rows


def _num(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def traffic_response(garage) -> dict:
    """The one serialization of the traffic observatory, shared by the
    admin HTTP endpoint and the admin-RPC op (key casing cannot drift
    between transports)."""
    rows = _traffic_rows(garage)
    with_trf = [r for r in rows if r.get("traffic")]
    hottest = None
    for r in with_trf:
        t = r["traffic"]
        if t.get("hb") is not None and (
            hottest is None or _num(t.get("hbo")) > _num(hottest["ops"])
        ):
            hottest = {
                "bucket": t["hb"],
                "ops": t.get("hbo"),
                "node": r["id"],
            }
    return {
        "node": garage.node_id.hex(),
        "enabled": _refs > 0,
        "local": observatory.snapshot(),
        "slowPeers": slow_peers(garage),
        "cluster": {
            "nodes": rows,
            "nodesReporting": len(with_trf),
            "aggregate": {
                "opsPerSec": round(
                    sum(_num(r["traffic"].get("rps")) for r in with_trf), 4
                ),
                "ops": sum(_num(r["traffic"].get("ops")) for r in with_trf),
                "bytesMoved": sum(
                    _num(r["traffic"].get("by")) for r in with_trf
                ),
            },
            "hotBucket": hottest,
        },
    }


def profile_response(garage) -> dict:
    return {
        "node": garage.node_id.hex(),
        "enabled": _refs > 0,
        **observatory.profile(),
    }
