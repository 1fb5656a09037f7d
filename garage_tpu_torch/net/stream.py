"""Byte streams attached to RPC messages (reference src/net/stream.rs:20).

A ByteStream is any `AsyncIterator[bytes]`.  `StreamWriter` is the
receiving-side bridge: the connection feeds chunks in, the application
consumes them as an async iterator; errors and cancellation propagate.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator


class StreamError(Exception):
    pass


_END = object()


class StreamWriter:
    """In-memory bridge between the connection reader task and the
    application consuming an attached stream.

    `feed` never blocks (the connection's single recv loop must keep
    serving other multiplexed requests even if one stream's consumer is
    slow or absent).  The primary backpressure is CREDIT-BASED flow
    control (connection.py): the peer stops sending once its
    STREAM_WINDOW of credit runs out, and `on_consume(n)` — called as the
    application drains bytes — is how the connection grants more.  The
    `max_buffer` overflow failure remains as a safety net against peers
    that ignore credit."""

    def __init__(self, max_buffer: int = 16 * 1024 * 1024, on_consume=None):
        self.q: asyncio.Queue = asyncio.Queue()
        self.max_buffer = max_buffer
        self.on_consume = on_consume
        self._buffered = 0
        self._closed = False

    async def feed(self, chunk: bytes) -> None:
        if self._closed:
            return
        self._buffered += len(chunk)
        if self._buffered > self.max_buffer:
            await self.close("stream buffer overflow (consumer too slow)")
            return
        self.q.put_nowait(chunk)

    async def close(self, error: str | None = None) -> None:
        if not self._closed:
            self._closed = True
            self.q.put_nowait(StreamError(error) if error else _END)

    def reader(self) -> AsyncIterator[bytes]:
        async def gen():
            while True:
                item = await self.q.get()
                if item is _END:
                    return
                if isinstance(item, StreamError):
                    raise item
                self._buffered -= len(item)
                if self.on_consume is not None and item:
                    self.on_consume(len(item))
                yield item

        return gen()


async def read_stream_to_end(stream: AsyncIterator[bytes]) -> bytes:
    parts = []
    async for chunk in stream:
        parts.append(chunk)
    return b"".join(parts)


async def stream_from_bytes(data: bytes, chunk: int = 64 * 1024) -> AsyncIterator[bytes]:
    for i in range(0, len(data), chunk):
        yield data[i : i + chunk]


def bytes_stream(data: bytes, chunk: int = 64 * 1024) -> AsyncIterator[bytes]:
    return stream_from_bytes(data, chunk)
