"""Latency X-ray: phase-level critical-path attribution for the S3 data
plane.

Closing the EC write-latency gap needs to know *where* a request's
milliseconds go.  The tracer records spans and the flight recorder
retains slow traces; this module decomposes a request into phases and
measures how sequential the pipeline actually is:

  - a fixed **phase catalogue** (`PHASES`): every stage of the block
    write/read pipeline is wrapped in a `phase:<name>` span carrying a
    `phase` attribute from this catalogue — auth, chunk, encode, hash,
    fan-out, quorum wait, metadata commit on the PUT side; index read,
    piece fetch, decode, stream-out on the GET side.  The catalogue is
    closed on purpose: `{op,phase}` label cardinality is bounded and the
    metrics-lint tier-1 test fails on any combination outside it.

  - `critical_path()` walks a finished span tree and computes per-phase
    **exclusive** wall time: same-phase spans that overlap (the parallel
    piece fan-out) merge into one wall-clock interval — parallelism must
    not double-count — and a phase span's interval excludes descendant
    spans carrying a *different* phase.  `quorum_wait` additionally
    excludes the trace-global `fanout` union (the quorum wait *is* the
    send window; its exclusive time is the tail where every send is done
    but a quorum still isn't).  From those intervals it derives:

      coverage            union of all phase intervals / request wall —
                          how much of the request the catalogue explains
      overlap efficiency  wall / sum of phase times — 1.0 means the
                          phases ran back-to-back (fully sequential); below 1.0 the
                          pipeline genuinely overlaps
      critical-path share per-phase fraction of the attributed time

  - `PhaseAggregator`, a tracer span-end hook (attaching
    it enables span creation with no OTLP sink), feeds per-request phase
    times into `api_s3_phase_duration{op,phase}` histograms plus an
    `api_s3_overlap_efficiency{op}` EWMA gauge, and keeps a rolling
    window per op so `GET /v1/debug/latency` / `cli debug latency` can
    serve a live phase waterfall (p50/p95/p99 per phase, share, overlap
    efficiency) with zero external collectors.

The aggregator is a process-wide singleton (like the metrics registry it
feeds): several in-process test nodes share one tracer and one registry,
so per-node aggregators would multiply every observation by the node
count.  `enable()`/`disable()` refcount the tracer hook.
"""

from __future__ import annotations

import collections
import logging
import time

from .metrics import registry as _registry
from .tracing import NOOP_SPAN, tracer

logger = logging.getLogger("garage.latency")

# The CLOSED phase catalogue.  Adding a stage here is a reviewed schema
# change: doc/monitoring.md documents each phase and the metrics-lint
# test enforces that `api_s3_phase_duration` never exposes a label
# outside this tuple.
PHASES = (
    "auth",         # SigV4 verification + access-key fetch
    "chunk",        # reading/chunking the request body
    "codec_batch_wait",  # queue time in the codec batcher before dispatch
    "encode",       # EC piece encoding (or replica compression)
    "hash",         # content hashing (md5/sha/blake2) + SSE transform
    "fanout",       # piece/replica sends to the write set
    "quorum_wait",  # waiting for quorum beyond the send window
    "meta_commit",  # object/version/block-ref table commits
    "meta_coalesce_wait",  # queue time in the table insert coalescer
    "index_read",   # object/version/bucket metadata reads
    "piece_fetch",  # gathering block bytes / EC pieces
    "decode",       # EC decode + post-decode verification
    "stream_out",   # writing response bytes to the client
)
_PHASE_SET = frozenset(PHASES)

# Operation classes a request root may be stamped with (`mark_op`).
OPS = ("put", "get", "head", "delete", "upload_part")
_OP_SET = frozenset(OPS)

# Phases whose exclusive time excludes another phase's trace-global
# interval union even without a tree ancestry link: the EC quorum wait
# runs CONCURRENTLY with the sends it waits on (sibling spans, different
# tasks), and counting that window twice would fake pipeline overlap.
RESIDUAL_OF = {"quorum_wait": ("fanout",)}

ROOT_SPAN_NAME = "api:s3"


def phase_span(name: str):
    """A `phase:<name>` span from the fixed catalogue — the ONLY way
    instrumentation sites attach a phase attribute, so an ad-hoc name
    can't leak into the label space.  No-op when tracing is off; the
    catalogue check runs either way."""
    if name not in _PHASE_SET:
        raise ValueError(f"phase {name!r} not in the catalogue")
    if not tracer.enabled:
        return NOOP_SPAN
    return tracer.span("phase:" + name, phase=name)


def mark_op(op: str) -> None:
    """Stamp the operation class on the innermost open span — handlers
    call this at their top, where that span is the `api:s3` request
    root.  Unknown ops are dropped (bounded label space)."""
    if op not in _OP_SET:
        return
    s = tracer.current()
    if s is not None:
        s.attrs["op"] = op


# --- interval helpers ---------------------------------------------------------


def _merge(ivs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Overlapping/adjacent intervals -> disjoint sorted intervals."""
    if not ivs:
        return []
    ivs = sorted(ivs)
    out = [ivs[0]]
    for s, e in ivs[1:]:
        ls, le = out[-1]
        if s <= le:
            if e > le:
                out[-1] = (ls, e)
        else:
            out.append((s, e))
    return out


def _subtract(
    iv: tuple[int, int], cuts: list[tuple[int, int]]
) -> list[tuple[int, int]]:
    """Pieces of `iv` not covered by `cuts` (cuts disjoint + sorted)."""
    s, e = iv
    out = []
    for cs, ce in cuts:
        if ce <= s or cs >= e:
            continue
        if cs > s:
            out.append((s, cs))
        s = max(s, ce)
        if s >= e:
            break
    if s < e:
        out.append((s, e))
    return out


def _span_len(ivs: list[tuple[int, int]]) -> int:
    return sum(e - s for s, e in ivs)


# --- critical-path analysis ---------------------------------------------------


def critical_path(root, spans) -> dict:
    """Per-phase exclusive-time attribution over one finished span tree.

    `root`/`spans` are Span-like objects (`span_id`, `parent_id`,
    `start_ns`, `end_ns`, `attrs`); `spans` is every span of the trace
    (the root itself may or may not be included).  Returns::

        {"wallMs", "attributedMs", "sumMs", "coverage",
         "overlapEfficiency", "phases": {phase: {"ms", "share"}}}

    Semantics (asserted by tests/test_latency_xray.py):
      - same-phase spans merge on the wall clock first — N parallel
        fan-out RPCs taking 50 ms each over a 60 ms window contribute
        60 ms, not N*50;
      - a phase span excludes descendant spans carrying a different
        phase (nested stages are not counted twice);
      - `RESIDUAL_OF` phases additionally exclude their counterpart
        phases' trace-global union (see module docstring);
      - everything is clipped to the root's [start, end] window —
        background stragglers ending after the response don't inflate
        the request's attribution.
    """
    wall_ns = max(root.end_ns - root.start_ns, 1)
    children: dict[bytes, list] = {}
    for s in spans:
        if s.parent_id is not None:
            children.setdefault(s.parent_id, []).append(s)

    # raw per-phase interval unions (for RESIDUAL_OF and coverage)
    raw: dict[str, list[tuple[int, int]]] = {}
    phase_spans = []
    for s in spans:
        ph = s.attrs.get("phase")
        if ph not in _PHASE_SET:
            continue
        lo = max(s.start_ns, root.start_ns)
        hi = min(s.end_ns, root.end_ns)
        if hi <= lo:
            continue
        phase_spans.append((s, ph, (lo, hi)))
        raw.setdefault(ph, []).append((lo, hi))
    raw = {ph: _merge(ivs) for ph, ivs in raw.items()}

    exclusive: dict[str, list[tuple[int, int]]] = {}
    for s, ph, iv in phase_spans:
        # descendant spans with a DIFFERENT phase cut this span's interval
        cuts: list[tuple[int, int]] = []
        stack = [s.span_id]
        while stack:
            for c in children.get(stack.pop(), []):
                cph = c.attrs.get("phase")
                if cph in _PHASE_SET and cph != ph:
                    cuts.append((c.start_ns, c.end_ns))
                else:
                    stack.append(c.span_id)
        for other in RESIDUAL_OF.get(ph, ()):
            cuts.extend(raw.get(other, ()))
        pieces = _subtract(iv, _merge(cuts)) if cuts else [iv]
        exclusive.setdefault(ph, []).extend(pieces)

    phases_ns = {ph: _span_len(_merge(ivs)) for ph, ivs in exclusive.items()}
    phases_ns = {ph: ns for ph, ns in phases_ns.items() if ns > 0}
    total_ns = sum(phases_ns.values())
    covered_ns = _span_len(
        _merge([iv for ivs in exclusive.values() for iv in ivs])
    )
    return {
        "wallMs": round(wall_ns / 1e6, 3),
        "attributedMs": round(covered_ns / 1e6, 3),
        "sumMs": round(total_ns / 1e6, 3),
        "coverage": round(covered_ns / wall_ns, 4),
        "overlapEfficiency": (
            round(wall_ns / total_ns, 4) if total_ns else None
        ),
        # coverage-independent companion: attributed-union / sum.  1.0 =
        # the attributed phases are disjoint (sequential); below 1.0 they
        # genuinely overlap.  overlapEfficiency (wall / sum, the headline
        # metric) mixes in uncovered wall time — with coverage < 1 it can
        # read ~1.0 for a pipeline that does overlap; this one can't.
        "sequentiality": (
            round(covered_ns / total_ns, 4) if total_ns else None
        ),
        "phases": {
            ph: {
                "ms": round(ns / 1e6, 3),
                "share": round(ns / total_ns, 4),
            }
            for ph, ns in sorted(phases_ns.items(), key=lambda kv: -kv[1])
        },
    }


# --- rolling aggregation (the tracer hook) ------------------------------------


class PhaseAggregator:
    """Buffers spans per trace (SlowRequestRecorder pattern) and, when an
    `api:s3` root stamped with a catalogue op ends, runs critical_path()
    over its tree: histograms + EWMA gauge into the registry, the full
    result into a bounded per-op window for the waterfall endpoint."""

    SWEEP_EVERY = 512
    MAX_PENDING_TRACES = 1024
    # generous: a multi-hundred-MiB streamed GET emits several spans per
    # block (fetch/decode/stream_out + rpc layers).  A trace that still
    # overflows is marked truncated and NOT recorded — an absent sample
    # is honest, a waterfall missing its tail phases is corrupt.
    MAX_SPANS_PER_TRACE = 4096
    PENDING_TTL = 30.0
    WINDOW = 256  # retained analyses per op
    EWMA_ALPHA = 0.2

    def __init__(self, registry=None):
        self.registry = registry if registry is not None else _registry
        # trace id -> [last_touch_monotonic, [spans]]
        self.pending: dict[bytes, list] = {}
        self.recent: dict[str, collections.deque] = {}
        self.recorded = 0
        self._overlap_ewma: dict[str, float] = {}
        self._calls = 0

    def reset(self) -> None:
        """Drop buffered traces + the rolling window (test isolation —
        the singleton outlives any one in-process node)."""
        self.pending.clear()
        self.recent.clear()
        self._overlap_ewma.clear()
        self.recorded = 0

    # the tracer hook — called on the event loop for every finished span
    def on_span_end(self, span) -> None:
        self._calls += 1
        if self._calls % self.SWEEP_EVERY == 0:
            self._sweep()
        ent = self.pending.get(span.trace_id)
        if ent is None:
            if span.parent_id is None:
                # single-span trace (background table op, noise root):
                # nothing buffered, nothing to analyze
                self._maybe_record(span, [span])
                return
            if len(self.pending) >= self.MAX_PENDING_TRACES:
                self.pending.pop(next(iter(self.pending)), None)
            # [last_touch, spans, truncated]
            ent = self.pending[span.trace_id] = [time.monotonic(), [], False]
        ent[0] = time.monotonic()
        if len(ent[1]) < self.MAX_SPANS_PER_TRACE:
            ent[1].append(span)
        else:
            ent[2] = True
        if span.parent_id is None:
            ent = self.pending.pop(span.trace_id)
            if not ent[2]:
                self._maybe_record(span, ent[1])

    def _maybe_record(self, root, spans) -> None:
        if root.name != ROOT_SPAN_NAME:
            return
        op = root.attrs.get("op")
        if op not in _OP_SET:
            return
        try:
            result = critical_path(root, spans)
        except Exception as e:  # noqa: BLE001 — hooks must not fail spans
            logger.debug("critical_path failed: %r", e)
            return
        if not result["phases"]:
            return
        self._record(op, result)

    def _record(self, op: str, result: dict) -> None:
        r = self.registry
        for ph, st in result["phases"].items():
            if ph not in _PHASE_SET:  # defensive: bounded label space
                continue
            r.observe(
                "api_s3_phase_duration",
                (("op", op), ("phase", ph)),
                st["ms"] / 1000.0,
            )
        eff = result["overlapEfficiency"]
        if eff is not None:
            prev = self._overlap_ewma.get(op)
            ewma = (
                eff if prev is None
                else self.EWMA_ALPHA * eff + (1 - self.EWMA_ALPHA) * prev
            )
            self._overlap_ewma[op] = ewma
            r.set_gauge(
                "api_s3_overlap_efficiency", (("op", op),), round(ewma, 4)
            )
        dq = self.recent.get(op)
        if dq is None:
            dq = self.recent[op] = collections.deque(maxlen=self.WINDOW)
        dq.append(result)
        self.recorded += 1

    def _sweep(self) -> None:
        now = time.monotonic()
        for tid in [
            t for t, ent in self.pending.items()
            if now - ent[0] > self.PENDING_TTL
        ]:
            self.pending.pop(tid, None)

    # --- waterfall snapshot ---------------------------------------------------

    @staticmethod
    def _mean_of(records: list[dict], key: str) -> float:
        vals = [r[key] for r in records if r.get(key) is not None]
        return round(sum(vals) / len(vals), 4) if vals else 0.0

    @staticmethod
    def _pcts(vals: list[float]) -> dict[str, float]:
        vals = sorted(vals)

        def p(q: float) -> float:
            return vals[min(len(vals) - 1, int(q * len(vals)))]

        return {
            "p50": round(p(0.50), 3),
            "p95": round(p(0.95), 3),
            "p99": round(p(0.99), 3),
        }

    def snapshot(self) -> dict:
        """Rolling waterfall per op: wall/phase percentiles, aggregate
        critical-path share, coverage, overlap efficiency."""
        out: dict[str, dict] = {}
        for op, dq in self.recent.items():
            records = list(dq)
            if not records:
                continue
            per_phase: dict[str, list[float]] = {}
            for rec in records:
                for ph, st in rec["phases"].items():
                    per_phase.setdefault(ph, []).append(st["ms"])
            sum_all = sum(ms for v in per_phase.values() for ms in v)
            out[op] = {
                "count": len(records),
                "wallMs": self._pcts([r["wallMs"] for r in records]),
                "coverage": round(
                    sum(r["coverage"] for r in records) / len(records), 4
                ),
                "overlapEfficiency": self._mean_of(
                    records, "overlapEfficiency"
                ),
                "sequentiality": self._mean_of(records, "sequentiality"),
                "phases": {
                    ph: {
                        **self._pcts(vals),
                        "criticalPathShare": round(
                            sum(vals) / sum_all, 4
                        ) if sum_all else 0.0,
                    }
                    for ph, vals in sorted(
                        per_phase.items(), key=lambda kv: -sum(kv[1])
                    )
                },
            }
        return out


# process-wide aggregator: the registry it feeds is process-global, and
# several in-process nodes share one tracer — per-node instances would
# multiply every histogram observation by the node count
aggregator = PhaseAggregator()

_refs = 0


def enable() -> None:
    """Attach the aggregator hook (refcounted — every in-process Garage
    with `[admin] latency_xray` calls this at start)."""
    global _refs
    _refs += 1
    tracer.add_hook(aggregator.on_span_end)


def disable() -> None:
    global _refs
    _refs = max(0, _refs - 1)
    if _refs == 0:
        tracer.remove_hook(aggregator.on_span_end)


def latency_response() -> dict:
    """The one serialization of the latency-X-ray state, shared by the
    admin HTTP endpoint and the admin RPC op (the slow_response
    pattern: key casing cannot drift between transports)."""
    return {
        "enabled": _refs > 0,
        "phases": list(PHASES),
        "ops": aggregator.snapshot(),
    }
