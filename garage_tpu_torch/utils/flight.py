"""Flight recorder: node-local self-diagnostics.

Three coordinated tools that answer "why is this node slow?" from a
RUNNING daemon, with zero external collectors attached (the
`/debug/pprof` plane every production store grows; reference Garage
leans on tokio-console + metrics for the same questions):

  1. **Sampling profiler** — `profile(seconds, hz)` spawns a thread
     that samples `sys._current_frames()` (every thread's live stack)
     plus the asyncio task set at ~100 Hz, aggregates collapsed stacks,
     and renders them as folded-stack text (flamegraph.pl / speedscope
     paste format) or speedscope JSON.  Served from admin
     `GET /v1/debug/profile?seconds=N` and `cli ... debug profile`.
     Because the sampler is a *thread*, it keeps sampling even while
     the event loop is wedged — the wedge IS the profile.

  2. **Event-loop watchdog** — `EventLoopWatchdog` measures scheduling
     lag continuously (a self-rescheduling `call_later` beat feeds the
     `event_loop_lag_seconds` histogram) while a monitor thread detects
     stalls *in progress*: when the beat goes unserviced past the
     threshold it increments `event_loop_blocked_total`, samples the
     loop thread's current stack (the culprit, caught red-handed), and
     dumps every live asyncio task stack with its trace id (log
     correlation) to the log, rate-limited.

  3. **Slow-request flight recorder** — `SlowRequestRecorder` hooks
     `utils/tracing.py` span end and retains the span trees of the
     slowest recent requests (threshold + top-K ring buffer), served
     from `GET /v1/debug/slow` and `cli ... debug slow`.  Attaching the
     hook enables span creation even without an OTLP sink, so "what was
     that p99" is answerable post-hoc on any node.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import sys
import threading
import time

from .metrics import registry

# the profiler lives in its own module (utils/profiler.py);
# re-exported here unchanged so existing flight.profile(...) callers —
# admin HTTP, admin RPC, CLI, tests — keep working
from .profiler import (  # noqa: F401 — re-exports are this module's API
    ProfileResult,
    SamplingProfiler,
    _all_tasks,
    _format_frame,
    _task_frames,
    _task_label,
    _thread_stack,
    profile,
)

logger = logging.getLogger("garage.flight")


def _task_trace_id(task) -> str:
    """Trace id of the span active in a task, '' when none.

    `Task.get_context()` only exists on 3.12+ and the 3.10/3.11 C task
    exposes no `_context` either, so fall back to scanning the await
    chain's frame locals: every tracing call site binds its span
    contextmanager to a local (`cm` in netapp/rpc_helper, `s` under
    `with ... as s`), which makes the active span recoverable from a
    suspended task on any supported interpreter."""
    try:
        from .tracing import Span, _current

        getctx = getattr(task, "get_context", None)
        ctx = getctx() if getctx is not None else getattr(task, "_context", None)
        if ctx is not None:
            span = ctx.get(_current)
            if span is not None:
                return span.trace_id.hex()
        for fr in reversed(_task_frames(task)):  # innermost first
            for v in fr.f_locals.values():
                if isinstance(v, Span):
                    return v.trace_id.hex()
                # _GeneratorContextManager from tracer.span(): the Span
                # lives in the suspended generator frame as `s`
                gen_frame = getattr(getattr(v, "gen", None), "gi_frame", None)
                if gen_frame is not None:
                    s = gen_frame.f_locals.get("s")
                    if isinstance(s, Span):
                        return s.trace_id.hex()
        return ""
    # graft-lint: allow-swallow(best-effort trace-id recovery from frame locals)
    except Exception:  # noqa: BLE001
        return ""


# --- event-loop watchdog ------------------------------------------------------


class EventLoopWatchdog:
    """Continuous event-loop scheduling-lag monitor + stall detector.

    Loop side: a self-rescheduling `call_later(tick)` beat observes its
    own lag into the `event_loop_lag_seconds` histogram.  Thread side: a
    monitor wakes every `tick` and, when the beat is overdue by more
    than `threshold`, counts a stall (`event_loop_blocked_total`, once
    per episode) and dumps the loop thread's current stack plus every
    live asyncio task stack — while the loop is still wedged, which is
    the only moment the culprit is on-stack."""

    def __init__(
        self,
        threshold: float = 0.25,
        tick: float = 0.1,
        dump_interval: float = 30.0,
    ):
        self.threshold = float(threshold)
        self.tick = float(tick)
        self.dump_interval = float(dump_interval)
        # optional stall hook (utils/profiler.StallProfiler.on_stall when
        # `[admin] stall_profile` is on): called once per counted episode,
        # FROM THE MONITOR THREAD, while the loop is still wedged
        self.on_stall = None
        self._loop = None
        self._loop_ident: int | None = None
        self._handle = None
        self._thread: threading.Thread | None = None
        self._stopped = False
        self._stalled = False
        self._last_beat = 0.0
        self._expected = 0.0
        self._last_dump = 0.0

    def start(self, loop=None) -> None:
        self._loop = loop or asyncio.get_event_loop()
        self._loop_ident = threading.get_ident()
        now = time.monotonic()
        self._last_beat = now
        self._expected = now + self.tick
        self._handle = self._loop.call_later(self.tick, self._beat)
        self._thread = threading.Thread(
            target=self._monitor, name="garage-loop-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    # --- loop side: lag histogram --------------------------------------------

    def _beat(self) -> None:
        now = time.monotonic()
        lag = max(0.0, now - self._expected)
        registry.observe("event_loop_lag_seconds", (), lag)
        self._last_beat = now
        self._expected = now + self.tick
        if not self._stopped:
            self._handle = self._loop.call_later(self.tick, self._beat)

    # --- thread side: stall detection ----------------------------------------

    def _monitor(self) -> None:
        while not self._stopped:
            time.sleep(self.tick)
            overdue = time.monotonic() - self._last_beat - self.tick
            if overdue > self.threshold:
                if not self._stalled:
                    self._stalled = True
                    registry.incr("event_loop_blocked_total", ())
                    self._report(overdue)
                    if self.on_stall is not None:
                        try:
                            self.on_stall(overdue, self._loop, self._loop_ident)
                        # graft-lint: allow-swallow(stall diagnostics must never take the watchdog thread down)
                        except Exception:  # noqa: BLE001
                            pass
            else:
                self._stalled = False

    def _report(self, overdue: float) -> None:
        now = time.monotonic()
        if now - self._last_dump < self.dump_interval:
            logger.warning(
                "event loop blocked for %.0f ms (threshold %.0f ms); "
                "task dump suppressed (rate limit)",
                overdue * 1000, self.threshold * 1000,
            )
            return
        self._last_dump = now
        parts = [
            f"event loop blocked for {overdue * 1000:.0f} ms "
            f"(threshold {self.threshold * 1000:.0f} ms)"
        ]
        culprit = sys._current_frames().get(self._loop_ident)
        if culprit is not None:
            parts.append("blocked in (loop thread stack, innermost last):")
            parts.extend("    " + f for f in _thread_stack(culprit))
        tasks = _all_tasks(self._loop)
        parts.append(f"live asyncio tasks ({len(tasks)}):")
        for task in tasks:
            try:
                frames = _task_frames(task)
                tid = _task_trace_id(task)
                where = " <- ".join(
                    _format_frame(f) for f in reversed(frames)
                ) or "(running)"
                parts.append(
                    f"    {task.get_name()}"
                    + (f" trace={tid}" if tid else "")
                    + f": {where}"
                )
            # graft-lint: allow-swallow(task-dump is best-effort diagnostics mid-stall)
            except Exception:  # noqa: BLE001
                continue
        logger.warning("%s", "\n".join(parts))


# --- slow-request flight recorder ---------------------------------------------


class SlowRequestRecorder:
    """Bounded ring buffer of the span trees of recent slow requests.

    Registered as a tracer span-end hook (which by itself enables span
    creation — no OTLP sink needed).  Spans buffer per trace id; when a
    local root ends (no parent: the API request span on the serving
    node, or a manually-opened root), its subtree is extracted and, if
    the root exceeded `threshold_ms`, retained in a `top_k`-deep ring
    (most recent K slow requests; `snapshot()` orders by duration).
    Orphan trees — e.g. `rpc-handle:*` subtrees on a remote node whose
    root lives on the gateway — finalize via the expiry sweep instead."""

    SWEEP_EVERY = 512  # hook calls between pending-expiry sweeps
    MAX_PENDING_TRACES = 1024
    MAX_SPANS_PER_TRACE = 512
    PENDING_TTL = 30.0  # seconds a parentless subtree may linger

    # flight events retained for the federated cluster timeline
    # (rpc/transition.py) — a dedicated ring so a burst of slow
    # requests cannot evict the durability alert an operator needs
    EVENTS_TOP_K = 256

    def __init__(self, threshold_ms: float = 500.0, top_k: int = 64):
        self.threshold_ms = float(threshold_ms)
        self.top_k = int(top_k)
        self.records: collections.deque = collections.deque(maxlen=self.top_k)
        self.events: collections.deque = collections.deque(
            maxlen=self.EVENTS_TOP_K
        )
        # trace id -> [last_touch_monotonic, [spans]]
        self.pending: dict[bytes, list] = {}
        self.dropped = 0  # spans discarded by the per-trace cap
        self._calls = 0

    # the tracer hook — called on the event loop for every finished span
    def on_span_end(self, span) -> None:
        self._calls += 1
        if self._calls % self.SWEEP_EVERY == 0:
            self._sweep()
        ent = self.pending.get(span.trace_id)
        if ent is None:
            if len(self.pending) >= self.MAX_PENDING_TRACES:
                # evict the oldest-inserted trace (dict order, O(1) — no
                # full scan on the hot path), finalizing it the same way
                # the TTL sweep would: a slow subtree must not vanish
                # just because the node is busy
                self._expire(next(iter(self.pending)))
            ent = self.pending[span.trace_id] = [time.monotonic(), []]
        ent[0] = time.monotonic()
        if len(ent[1]) < self.MAX_SPANS_PER_TRACE:
            ent[1].append(span)
        else:
            self.dropped += 1
        if span.parent_id is None:
            self._finalize(span)

    def _finalize(self, root) -> None:
        ent = self.pending.get(root.trace_id)
        if ent is None:
            return
        tree, rest = _extract_tree(root, ent[1])
        if rest:
            ent[1] = rest
        else:
            del self.pending[root.trace_id]
        self._maybe_record(root, tree)

    def _maybe_record(self, root, tree) -> None:
        duration_ms = (root.end_ns - root.start_ns) / 1e6
        if duration_ms < self.threshold_ms:
            return
        self.records.append(_build_record(root, tree, duration_ms))

    def _sweep(self) -> None:
        """Expire parentless trees (remote `rpc-handle:*` subtrees, or
        abandoned spans): record the topmost span if it was slow."""
        now = time.monotonic()
        for tid in [
            t for t, ent in self.pending.items()
            if now - ent[0] > self.PENDING_TTL
        ]:
            self._expire(tid)

    def _expire(self, tid: bytes) -> None:
        """Finalize a pending trace that will never see a local root:
        the topmost local span (the one whose parent is remote or gone)
        stands in as the root."""
        ent = self.pending.pop(tid, None)
        if ent is None:
            return
        spans = ent[1]
        local_ids = {s.span_id for s in spans}
        tops = [s for s in spans if s.parent_id not in local_ids]
        if tops:
            root = max(tops, key=lambda s: s.end_ns - s.start_ns)
            self._maybe_record(root, spans)

    def snapshot(self) -> list[dict]:
        """Retained slow requests, slowest first."""
        return sorted(self.records, key=lambda r: -r["durationMs"])


def _extract_tree(root, spans) -> tuple[list, list]:
    """Split `spans` into (subtree under `root`, the rest).  Other local
    roots of the same trace keep buffering until they end or expire."""
    children: dict[bytes, list] = {}
    for s in spans:
        if s.parent_id is not None:
            children.setdefault(s.parent_id, []).append(s)
    tree, frontier = [root], [root.span_id]
    while frontier:
        kids = children.pop(frontier.pop(), [])
        tree.extend(kids)
        frontier.extend(k.span_id for k in kids)
    tree_ids = {id(s) for s in tree}
    return tree, [s for s in spans if id(s) not in tree_ids]


def _build_record(root, tree, duration_ms: float) -> dict:
    t0 = root.start_ns
    # phase waterfall (utils/latency.py): "why was THIS request
    # slow" answered per-phase, not just as a raw span tree
    try:
        from .latency import critical_path

        waterfall = critical_path(root, tree)
        if not waterfall["phases"]:
            waterfall = None
    # graft-lint: allow-swallow(waterfall is an optional enrichment of the slow record)
    except Exception:  # noqa: BLE001 — diagnostics must never raise
        waterfall = None
    return {
        "traceId": root.trace_id.hex(),
        "name": root.name,
        "start": root.start_ns / 1e9,
        "durationMs": round(duration_ms, 3),
        "ok": root.ok,
        "phases": waterfall,
        "attrs": {k: str(v) for k, v in root.attrs.items()},
        "spans": [
            {
                "name": s.name,
                "spanId": s.span_id.hex(),
                "parentSpanId": s.parent_id.hex()
                if s.parent_id
                else None,
                "startMs": round((s.start_ns - t0) / 1e6, 3),
                "durationMs": round((s.end_ns - s.start_ns) / 1e6, 3),
                "ok": s.ok,
                "attrs": {k: str(v) for k, v in s.attrs.items()},
            }
            for s in sorted(tree, key=lambda s: s.start_ns)
        ],
    }


class _SharedSpanFanout:
    """Process-wide span buffering shared by every ATTACHED recorder.

    Several in-process Garage nodes each run a flight recorder, but the
    tracer is process-global: registering every recorder as its own
    tracer hook made EVERY span buffer + finalize once per node — the
    single biggest event-loop cost under a concurrent S3 workload on an
    11-node in-process cluster (the span fan-out work scaled as
    nodes x spans, ~28% of total loop time in the EC PUT bench).  This
    is the SlowRequestRecorder analog of the PhaseAggregator singleton
    rule (utils/latency.py): buffer each span ONCE, extract each
    finished subtree ONCE, serialize a slow record ONCE, and hand the
    shared result to every attached recorder's ring.

    Recorders used directly as tracer hooks (tests, ad-hoc tooling)
    keep their standalone `on_span_end` path; `attach()`/`detach()` is
    how Garage wires them."""

    SWEEP_EVERY = SlowRequestRecorder.SWEEP_EVERY
    MAX_PENDING_TRACES = SlowRequestRecorder.MAX_PENDING_TRACES
    MAX_SPANS_PER_TRACE = SlowRequestRecorder.MAX_SPANS_PER_TRACE
    PENDING_TTL = SlowRequestRecorder.PENDING_TTL

    def __init__(self):
        self.recorders: list[SlowRequestRecorder] = []
        self.pending: dict[bytes, list] = {}
        self._calls = 0

    def attach(self, rec: SlowRequestRecorder) -> None:
        from .tracing import tracer

        if rec not in self.recorders:
            self.recorders.append(rec)
        if len(self.recorders) == 1:
            tracer.add_hook(self.on_span_end)

    def detach(self, rec: SlowRequestRecorder) -> None:
        from .tracing import tracer

        if rec in self.recorders:
            self.recorders.remove(rec)
        if not self.recorders:
            tracer.remove_hook(self.on_span_end)
            self.pending.clear()

    def on_span_end(self, span) -> None:
        self._calls += 1
        if self._calls % self.SWEEP_EVERY == 0:
            self._sweep()
        ent = self.pending.get(span.trace_id)
        if ent is None:
            if len(self.pending) >= self.MAX_PENDING_TRACES:
                self._expire(next(iter(self.pending)))
            ent = self.pending[span.trace_id] = [time.monotonic(), []]
        ent[0] = time.monotonic()
        if len(ent[1]) < self.MAX_SPANS_PER_TRACE:
            ent[1].append(span)
        else:
            for rec in self.recorders:
                rec.dropped += 1
        if span.parent_id is None:
            ent = self.pending.get(span.trace_id)
            if ent is None:
                return
            tree, rest = _extract_tree(span, ent[1])
            if rest:
                ent[1] = rest
            else:
                del self.pending[span.trace_id]
            self._record(span, tree)

    def _record(self, root, tree) -> None:
        duration_ms = (root.end_ns - root.start_ns) / 1e6
        record = None  # serialized at most once, shared by every ring
        for rec in self.recorders:
            if duration_ms < rec.threshold_ms:
                continue
            if record is None:
                record = _build_record(root, tree, duration_ms)
            rec.records.append(record)

    def _sweep(self) -> None:
        now = time.monotonic()
        for tid in [
            t for t, ent in self.pending.items()
            if now - ent[0] > self.PENDING_TTL
        ]:
            self._expire(tid)

    def _expire(self, tid: bytes) -> None:
        ent = self.pending.pop(tid, None)
        if ent is None:
            return
        spans = ent[1]
        local_ids = {s.span_id for s in spans}
        tops = [s for s in spans if s.parent_id not in local_ids]
        if tops:
            root = max(tops, key=lambda s: s.end_ns - s.start_ns)
            self._record(root, spans)


# the process-wide fanout (mirrors utils/latency.py `aggregator`)
span_fanout = _SharedSpanFanout()


def attach_recorder(rec: SlowRequestRecorder) -> None:
    """Register a recorder on the shared fanout (Garage.start)."""
    span_fanout.attach(rec)


def detach_recorder(rec: SlowRequestRecorder) -> None:
    span_fanout.detach(rec)


# severity ladder for flight events (rpc/transition.py ranks these for
# `--min-severity` filtering; unknown strings clamp to "info")
EVENT_SEVERITIES = ("info", "warn", "critical")


def record_event(name: str, attrs: dict, recorder=None,
                 severity: str = "info") -> None:
    """Append a synthetic EVENT record to the slow-request ring(s) and
    the dedicated event bank.

    Not a request: no span tree, zero duration, `ok: false` so the ring
    renderers surface it.  Used by planes that detect a state transition
    worth an operator's attention post-hoc — e.g. the durability
    observatory recording blocks entering `at_risk`/`unreadable`
    (block/durability.py), or the rebalance observatory's
    `transition-report` (rpc/transition.py).  `severity` is one of
    info/warn/critical and rides into `/v1/cluster/events` filtering.
    `recorder=None` fans out to every recorder attached to the shared
    span fanout (all in-process nodes); pass one explicitly for
    tests/ad-hoc tooling."""
    sev = severity if severity in EVENT_SEVERITIES else "info"
    rec = {
        "traceId": "",
        "name": name,
        "event": True,
        "severity": sev,
        "start": time.time(),
        "durationMs": 0.0,
        "ok": False,
        "phases": None,
        "attrs": {k: str(v) for k, v in attrs.items()},
        "spans": [],
    }
    registry.incr("flight_events_total", (("severity", sev),))
    targets = [recorder] if recorder is not None else list(span_fanout.recorders)
    for r in targets:
        r.records.append(rec)
        events = getattr(r, "events", None)
        if events is not None:
            events.append(rec)


def slow_response(recorder: "SlowRequestRecorder | None") -> dict:
    """The one serialization of the slow-request state, shared by the
    admin HTTP endpoint and the admin RPC op (so key casing cannot
    drift between the two transports)."""
    return {
        "enabled": recorder is not None,
        "thresholdMs": recorder.threshold_ms if recorder else None,
        "topK": recorder.top_k if recorder else None,
        "requests": recorder.snapshot() if recorder else [],
    }
