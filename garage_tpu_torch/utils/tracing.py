"""Span tracing with OTLP/HTTP export (reference: OpenTelemetry spans
around every RPC/API/table op, exported via OTLP when `admin.trace_sink`
is configured — src/garage/tracing_setup.rs:13-37, src/rpc/rpc_helper.rs:172-217).

Design: a contextvar carries the current span, so `with span("name"):`
nests correctly across asyncio task boundaries (contextvars propagate
into tasks).  Finished spans buffer in memory and a background flusher
POSTs them as OTLP/HTTP JSON (`/v1/traces`) to the sink.  When no sink is
configured the API is a near-zero-cost no-op — the hot paths stay hot.

Span ids follow W3C sizes: 16-byte trace id, 8-byte span id.

Cross-node propagation (Dapper-style): `tracer.inject()` serializes the
current span as a compact binary traceparent — 16-byte trace id + 8-byte
parent span id + 1 flag byte (0x01 = sampled), the W3C traceparent
fields without the hex framing — which the RPC layer carries inside the
request frame (`net/connection.py` meta key "tp").  The receiving node
calls `tracer.extract()` and opens its handler span with
`remote_parent=...`, so one S3 PUT against a multi-node cluster yields
ONE trace whose `rpc-handle:*` spans on remote nodes share the root
trace id.  Hot paths guard with `if tracer.enabled` and fall back to the
shared `NOOP_SPAN`, so a disabled tracer allocates no Span objects, no
attr dicts, and no traceparent bytes.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import os
import random
import time
from contextlib import contextmanager

logger = logging.getLogger("garage.tracing")

# span/trace ids only need uniqueness, not unpredictability; a seeded
# PRNG avoids two getrandom() syscalls per span on the hot path (the
# flight recorder keeps span creation on by default)
_ids = random.Random(int.from_bytes(os.urandom(16), "big") ^ os.getpid())

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "garage_current_span", default=None
)

MAX_BUFFER = 8192
FLUSH_INTERVAL = 3.0

TRACEPARENT_LEN = 16 + 8 + 1  # trace id + parent span id + flags
FLAG_SAMPLED = 0x01


class _NoopSpan:
    """Reusable, re-enterable no-op context manager: the disabled-tracing
    fast path.  Hot callers use `tracer.span(...) if tracer.enabled else
    NOOP_SPAN` so the disabled branch never builds span names or attrs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()


class RemoteParent:
    """A parent span living on another node, reconstructed from a
    traceparent.  Duck-typed to Span for the two fields a child reads."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: bytes, span_id: bytes, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "start_ns", "end_ns", "attrs", "ok",
    )

    def __init__(self, name: str, parent: "Span | RemoteParent | None", attrs: dict):
        self.name = name
        self.trace_id = (
            parent.trace_id if parent else _ids.getrandbits(128).to_bytes(16, "big")
        )
        self.span_id = _ids.getrandbits(64).to_bytes(8, "big")
        self.parent_id = parent.span_id if parent else None
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attrs = attrs
        self.ok = True


class Tracer:
    def __init__(self):
        self.sink: str | None = None
        self.service_name = "garage-tpu"
        self._buf: list[Span] = []
        self._task: asyncio.Task | None = None
        self._session = None
        # span-end hooks (utils/flight.py SlowRequestRecorder): attaching
        # one enables span creation even without an export sink, so the
        # flight recorder works with zero external collectors
        self._hooks: list = []

    @property
    def enabled(self) -> bool:
        return self.sink is not None or bool(self._hooks)

    def add_hook(self, fn) -> None:
        """Register fn(span), called once per finished span."""
        if fn not in self._hooks:
            self._hooks.append(fn)

    def remove_hook(self, fn) -> None:
        try:
            self._hooks.remove(fn)
        except ValueError:
            pass

    def configure(self, sink: str | None, service_name: str = "garage-tpu") -> None:
        self.sink = sink
        self.service_name = service_name
        if sink and self._task is None:
            try:
                self._task = asyncio.get_event_loop().create_task(self._flusher())
            except RuntimeError:
                pass  # no loop yet; caller may start() later

    async def start(self) -> None:
        if self.sink and (self._task is None or self._task.done()):
            self._task = asyncio.get_event_loop().create_task(self._flusher())

    async def stop(self) -> None:
        if self._task is not None:
            from .aio import reap

            await reap([self._task], log=logger, what="trace flusher")
            self._task = None
        await self._flush()
        if self._session is not None:
            await self._session.close()
            self._session = None

    @contextmanager
    def span(self, name: str, remote_parent: RemoteParent | None = None, **attrs):
        """Context manager for a traced operation.  Cheap no-op (no span
        object at all) when tracing is off.

        `remote_parent` (from `extract()`) parents the span across the
        wire.  When given it WINS over any context-inherited span: a
        handler task inherits the contextvars snapshot of the connection's
        recv loop (frozen at connection setup), so an in-context span
        there is stale; the traceparent the caller serialized is the
        truth.  On the local-dispatch shortcut both agree — the injected
        traceparent is the caller's current span."""
        if not self.enabled:
            yield None
            return
        parent = remote_parent or _current.get()
        s = Span(name, parent, attrs)
        token = _current.set(s)
        try:
            yield s
        except BaseException:
            s.ok = False
            raise
        finally:
            _current.reset(token)
            s.end_ns = time.time_ns()
            self._finish(s)

    def record(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """A finished span over an interval stamped elsewhere (`time.time_ns`),
        child of the current span: for a wait that no `with` block can
        cover, such as a hand-off between two threads.  Nothing when
        tracing is off."""
        if not self.enabled:
            return
        s = Span(name, _current.get(), attrs)
        s.start_ns, s.end_ns = start_ns, end_ns
        self._finish(s)

    @contextmanager
    def adopt(self, parent: "Span | None"):
        """Make `parent` the current span inside the block, whatever the
        context had: for work that a task serving many requests does on
        behalf of one of them, such as a batch dispatch filed under the
        request whose entry opened the batch."""
        token = _current.set(parent)
        try:
            yield
        finally:
            _current.reset(token)

    def _finish(self, s: Span) -> None:
        # export buffer fills only when a sink is configured; hooks
        # (flight recorder) see every span either way
        if self.sink is not None and len(self._buf) < MAX_BUFFER:
            self._buf.append(s)
        for hook in self._hooks:
            try:
                hook(s)
            except Exception as e:  # noqa: BLE001 — hooks must not fail spans
                logger.debug("span hook failed: %r", e)

    def current(self) -> Span | None:
        return _current.get()

    # --- cross-node propagation -----------------------------------------------

    def inject(self) -> bytes | None:
        """Serialize the current span for the wire: 16-byte trace id +
        8-byte span id + flags (W3C traceparent fields, binary).  None
        when tracing is off or no span is active — callers then omit the
        frame field entirely, keeping the disabled wire format identical."""
        if not self.enabled:
            return None
        s = _current.get()
        if s is None:
            return None
        return s.trace_id + s.span_id + bytes((FLAG_SAMPLED,))

    def extract(self, tp: bytes | None) -> RemoteParent | None:
        """Parse a traceparent produced by `inject()` on another node.
        Malformed or absent input yields None (the span becomes a local
        root — never an error: tracing must not fail requests)."""
        if not isinstance(tp, (bytes, bytearray)) or len(tp) != TRACEPARENT_LEN:
            return None
        tp = bytes(tp)
        return RemoteParent(tp[:16], tp[16:24], bool(tp[24] & FLAG_SAMPLED))

    # --- export ---------------------------------------------------------------

    async def _flusher(self) -> None:
        while True:
            await asyncio.sleep(FLUSH_INTERVAL)
            try:
                await self._flush()
            except Exception as e:  # noqa: BLE001 — tracing must never kill the daemon
                logger.debug("trace export failed: %r", e)

    async def _flush(self) -> None:
        if not self._buf or not self.sink:
            return
        spans, self._buf = self._buf, []
        import aiohttp

        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        url = self.sink.rstrip("/") + "/v1/traces"
        # chunked export: one giant POST can exceed a collector's request
        # size limit (aiohttp servers default to 1 MiB) and lose the whole
        # batch; ~500 spans stays comfortably under typical limits
        for i in range(0, len(spans), 500):
            payload = self._otlp(spans[i : i + 500])
            async with self._session.post(
                url, json=payload, timeout=aiohttp.ClientTimeout(total=10)
            ) as resp:
                if resp.status >= 400:
                    logger.debug("trace sink returned %d", resp.status)

    def _otlp(self, spans: list[Span]) -> dict:
        """OTLP/HTTP JSON encoding (trace ids hex, times in ns strings)."""

        def attr(k, v):
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            return {"key": k, "value": val}

        return {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [attr("service.name", self.service_name)]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "garage-tpu"},
                            "spans": [
                                {
                                    "traceId": s.trace_id.hex(),
                                    "spanId": s.span_id.hex(),
                                    **(
                                        {"parentSpanId": s.parent_id.hex()}
                                        if s.parent_id
                                        else {}
                                    ),
                                    "name": s.name,
                                    "kind": 1,
                                    "startTimeUnixNano": str(s.start_ns),
                                    "endTimeUnixNano": str(s.end_ns),
                                    "attributes": [
                                        attr(k, v) for k, v in s.attrs.items()
                                    ],
                                    "status": {"code": 1 if s.ok else 2},
                                }
                                for s in spans
                            ],
                        }
                    ],
                }
            ]
        }


# process-wide tracer (configured by the daemon from admin.trace_sink)
tracer = Tracer()


def span(name: str, **attrs):
    return tracer.span(name, **attrs)
