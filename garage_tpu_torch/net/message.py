"""Message priorities and request/response envelopes.

Reference: src/net/message.rs:49-58 (priorities), :62-89 (order tags),
:96-133 (typed Message with attached streams).
"""

from __future__ import annotations

import itertools
from typing import Any, AsyncIterator

# Request priorities: lower value = more urgent.  The secondary flag lets a
# class of traffic yield to its own primaries (reference message.rs:49-58).
PRIO_HIGH = 0
PRIO_NORMAL = 1
PRIO_BACKGROUND = 2
PRIO_SECONDARY = 0x10  # OR-able flag


def prio_level(prio: int) -> int:
    """Scheduling bucket: 2*class + secondary-bit (6 buckets total)."""
    return 2 * (prio & 0x0F) + (1 if prio & PRIO_SECONDARY else 0)


N_PRIO_LEVELS = 6


class OrderTag:
    """Orders chunks of several responses within one logical stream
    (reference message.rs:62-89): all messages tagged with the same
    `stream` id are delivered to the app in increasing `seq` order.
    Used by the block-read pipeline to prefetch blocks concurrently but
    deliver bytes in order."""

    __slots__ = ("stream", "seq")

    def __init__(self, stream: int, seq: int):
        self.stream = stream
        self.seq = seq

    @classmethod
    def stream_of(cls, sid: int) -> "OrderTagStream":
        return OrderTagStream(sid)

    def to_obj(self) -> list[int]:
        return [self.stream, self.seq]

    @classmethod
    def from_obj(cls, obj) -> "OrderTag | None":
        return None if obj is None else cls(obj[0], obj[1])


class OrderTagStream:
    def __init__(self, sid: int):
        self.sid = sid
        self._next = 0

    def order(self) -> OrderTag:
        t = OrderTag(self.sid, self._next)
        self._next += 1
        return t


_next_sid = itertools.count(1)


def new_order_stream() -> OrderTagStream:
    """Process-unique ordered sub-stream (one per GET pipeline)."""
    return OrderTagStream(next(_next_sid))


class Req:
    """An RPC request: msgpack-able body + optional attached byte stream.

    `traceparent` (utils/tracing.py inject() bytes) rides the request
    frame's meta so the serving node can parent its handler span under
    the caller's trace — None (the common case with tracing off) adds
    nothing to the wire."""

    def __init__(
        self,
        body: Any,
        stream: AsyncIterator[bytes] | None = None,
        order_tag: OrderTag | None = None,
        traceparent: bytes | None = None,
    ):
        self.body = body
        self.stream = stream
        self.order_tag = order_tag
        self.traceparent = traceparent


class Resp:
    """An RPC response: body + optional attached byte stream."""

    def __init__(
        self,
        body: Any,
        stream: AsyncIterator[bytes] | None = None,
        order_tag: OrderTag | None = None,
    ):
        self.body = body
        self.stream = stream
        self.order_tag = order_tag
