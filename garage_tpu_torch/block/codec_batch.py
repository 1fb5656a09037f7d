"""CodecBatcher: cross-request coalescing of foreground EC codec work.

N concurrent PUTs that each encode their blocks one by one would send N
single-block dispatches to the card.  This batcher sits in front of the
codec as two LANES sharing one set of knobs:

  - the **encode lane**: concurrent `encode()` calls queue their blocks
    and share ONE fused encode + BLAKE3 dispatch
    (`EcCodec.encode_batch_hashed`, power-of-two batch buckets);

  - the **decode lane**: degraded-mode GETs — a data shard missing, a
    real reconstruction needed — queue their gathered pieces and share
    one grouped reconstruction dispatch (`EcCodec.decode_batch`).

Shared behavior per lane:

  - a lone request flushes after a bounded linger (`linger_msec`,
    default 2 ms), while a full batch (`max_blocks` / `max_bytes`)
    flushes immediately;

  - the dispatch itself runs in a worker thread (`asyncio.to_thread`),
    so the codec math never blocks the event loop.  The worker thread
    launches on its current stream, the device's default stream, and
    waits there for its kernels before it copies the results back;

  - a dispatch error fails only that batch's waiters; a cancelled
    request abandons its entry without poisoning the other requests
    coalesced into the same dispatch.

Phase attribution (utils/latency.py): the submitting request records
`codec_batch_wait` (queue time until its dispatch starts) separately
from `encode`/`decode` (the dispatch itself).  With the tracer on, a
dispatch's `codec:*` spans are children of the span of the request
whose entry heads its batch.

Metric families (the reference package's names):

  block_codec_batch_size          blocks per coalesced encode dispatch (H)
  block_codec_batch_dispatch_total{flush}  encode dispatches by flush
                                  reason (full | linger)
  block_codec_batch_decode_dispatch_total{flush}  decode-lane dispatches
  block_codec_batch_coalesced_total  blocks that shared a dispatch
                                  with at least one other block
  block_codec_batch_queue_depth{id}  blocks waiting in a lane (G)
  block_codec_batch_lane_linger{lane,flush}  seconds each block sat in
                                  its lane from submit to dispatch start
  block_codec_stage_duration{op,stage="handoff"}  (ops/telemetry.py)
                                  each returned dispatch's wait for its
                                  worker thread to start it plus its wait
                                  for the loop to resume it; `op` is the
                                  lane's name
"""

from __future__ import annotations

import asyncio
import contextvars
import itertools
import logging
import time

from ..ops import telemetry
from ..utils.aio import reap, spawn_supervised
from ..utils.error import Error
from ..utils.latency import phase_span
from ..utils.metrics import SIZE_BUCKETS, registry
from ..utils.tracing import tracer

logger = logging.getLogger("garage.block.codec_batch")

registry.set_buckets("block_codec_batch_size", SIZE_BUCKETS)

# gauge `id` source: process-wide (several in-process nodes share the
# registry; per-node ids would collide)
_gauge_ids = itertools.count(1)


class _Entry:
    __slots__ = ("payload", "nbytes", "arrived", "span", "started", "fut")

    def __init__(self, payload, nbytes: int):
        self.payload = payload
        self.nbytes = nbytes
        self.arrived = time.monotonic()
        # the submitting request's span: a dispatch that this entry heads
        # files its `codec:*` spans under it
        self.span = tracer.current()
        # set when this entry's dispatch begins (ends codec_batch_wait)
        self.started = asyncio.Event()
        self.fut: asyncio.Future = asyncio.get_running_loop().create_future()


class _Lane:
    """One coalescing queue (encode or decode) reading the batcher's
    live knobs on every flush.  `dispatch_fn(payloads, impl)` is the
    SYNC codec entry point, run via asyncio.to_thread; `phase` is the
    latency phase the post-wait dispatch time lands in."""

    def __init__(self, batcher: "CodecBatcher", name: str, phase: str,
                 dispatch_fn, size_metrics: bool):
        self.batcher = batcher
        self.name = name
        self.phase = phase
        self.dispatch_fn = dispatch_fn
        # decode gets its own dispatch counter so coalescing tests and
        # panels can tell the lanes apart; size/coalesced histograms stay
        # encode-only (the decode volume split already lives in
        # `block_codec_blocks_total{op="decode",...}`)
        self.size_metrics = size_metrics
        self.dispatch_counter = (
            "block_codec_batch_dispatch_total"
            if name == "encode"
            else f"block_codec_batch_{name}_dispatch_total"
        )
        self.pending: list[_Entry] = []
        self.pending_bytes = 0
        self.wake = asyncio.Event()
        self.task: asyncio.Task | None = None
        self.gauge_key = (
            "block_codec_batch_queue_depth",
            (("id", str(next(_gauge_ids))),),
        )
        registry.register_gauge(
            *self.gauge_key, lambda: float(len(self.pending))
        )

    # --- submit side ----------------------------------------------------------

    async def submit(self, payload, nbytes: int):
        if self.batcher._closed:
            raise Error("codec batcher is closed")
        entry = _Entry(payload, nbytes)
        self.pending.append(entry)
        self.pending_bytes += nbytes
        self.wake.set()
        if self.task is None:
            # the flusher serves every later request too, so it starts in
            # a context of its own, not a copy of this request's
            self.task = contextvars.Context().run(
                spawn_supervised, self._run(), name=f"codec-batcher-{self.name}"
            )
        try:
            with phase_span("codec_batch_wait"):
                await entry.started.wait()
            with phase_span(self.phase):
                return await entry.fut
        except asyncio.CancelledError:
            # a request cancelled mid-batch abandons its slot; the
            # dispatch (if already in flight) completes for the OTHER
            # waiters, and `_take`/`_dispatch` skip the cancelled future
            entry.fut.cancel()
            raise

    # --- flusher --------------------------------------------------------------

    def _batch_full(self) -> bool:
        return (
            len(self.pending) >= self.batcher.max_blocks
            or self.pending_bytes >= self.batcher.max_bytes
        )

    async def _run(self) -> None:
        while not self.batcher._closed:
            if not self.pending:
                self.wake.clear()
                # re-check: a submit() may have queued between the
                # pending check and the clear
                if not self.pending:
                    await self.wake.wait()
                continue
            flush = "full"
            if not self._batch_full():
                # linger anchored at the HEAD entry's arrival: entries
                # that queued while a previous dispatch was running have
                # already waited their window and flush immediately
                deadline = (
                    self.pending[0].arrived + self.batcher.linger_msec / 1e3
                )
                flush = "linger"
                while True:
                    self.wake.clear()
                    if self._batch_full():  # re-check after the clear
                        flush = "full"
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        await asyncio.wait_for(self.wake.wait(), remaining)
                    except asyncio.TimeoutError:
                        break
            await self._dispatch(self._take(), flush)

    def _take(self) -> list[_Entry]:
        """Drain up to max_blocks/max_bytes of live entries (cancelled
        waiters are dropped here, before they cost a dispatch slot)."""
        batch: list[_Entry] = []
        size = 0
        while self.pending and len(batch) < self.batcher.max_blocks:
            if batch and size + self.pending[0].nbytes > self.batcher.max_bytes:
                break
            e = self.pending.pop(0)
            self.pending_bytes -= e.nbytes
            if e.fut.cancelled():
                e.started.set()
                continue
            batch.append(e)
            size += e.nbytes
        return batch

    async def _dispatch(self, batch: list[_Entry], flush: str) -> None:
        if not batch:
            return
        now = time.monotonic()
        linger_lbl = (("lane", self.name), ("flush", flush))
        for e in batch:
            e.started.set()
            registry.observe(
                "block_codec_batch_lane_linger", linger_lbl, now - e.arrived
            )
        if self.size_metrics:
            registry.observe(
                "block_codec_batch_size", (), float(len(batch))
            )
        registry.incr(self.dispatch_counter, (("flush", flush),))
        if len(batch) > 1 and self.size_metrics:
            registry.incr("block_codec_batch_coalesced_total", by=len(batch))
        handoff = telemetry.Handoff(
            self.name, len(batch), sum(e.nbytes for e in batch)
        )
        # the dispatch's spans are filed under the request whose entry
        # heads the batch, the one the lane's linger waited for
        with tracer.adopt(batch[0].span):
            try:
                # the sync batch dispatch is handed to a worker thread — the
                # loop keeps serving other requests while the codec math runs
                results = await asyncio.to_thread(
                    handoff.run, self.dispatch_fn, [e.payload for e in batch],
                    self.batcher.impl,
                )
            except Exception as e:  # noqa: BLE001 — fails THIS batch's waiters
                for ent in batch:
                    if not ent.fut.done():
                        ent.fut.set_exception(
                            Error(f"batched codec dispatch failed: {e!r}")
                        )
                return
            except BaseException:
                # flusher cancelled mid-dispatch (close() during node stop):
                # this batch was already drained out of `pending`, so close()
                # can't fail its futures — do it here or every waiter of the
                # in-flight batch hangs forever on `await entry.fut`
                for ent in batch:
                    if not ent.fut.done():
                        ent.fut.set_exception(
                            Error("codec batcher closed mid-dispatch")
                        )
                raise
            handoff.resumed()
        for ent, res in zip(batch, results):
            if not ent.fut.done():  # a waiter may have been cancelled
                ent.fut.set_result(res)

    async def close(self) -> None:
        for e in self.pending:
            e.started.set()
            if not e.fut.done():
                e.fut.set_exception(Error("codec batcher is closed"))
        self.pending.clear()
        self.pending_bytes = 0
        if self.task is not None:
            await reap(
                [self.task], log=logger,
                what=f"codec-batcher {self.name} flusher",
            )
            self.task = None
        registry.unregister_gauge(*self.gauge_key)


class CodecBatcher:
    """Short-linger queues coalescing concurrent block encodes (and
    degraded-read decodes) into batched codec dispatches.  One instance
    per node; each lane's flusher task spawns lazily on first use and is
    reaped by `close()`."""

    def __init__(
        self,
        codec,
        *,
        linger_msec: float = 2.0,
        max_blocks: int = 64,
        max_bytes: int = 64 * 1024 * 1024,
        impl: str = "auto",
    ):
        self.codec = codec
        # live-tunable: read on every flush, shared by both lanes
        self.linger_msec = float(linger_msec)
        self.max_blocks = int(max_blocks)
        self.max_bytes = int(max_bytes)
        # the codec's backend policy (`[block] batch_impl`; block/codec/ec.py)
        self.impl = impl
        self._closed = False
        self._encode = _Lane(
            self, "encode", "encode", codec.encode_batch_hashed,
            size_metrics=True,
        )
        # late-bound so a codec without decode_batch (stub codecs in
        # tests) still constructs; a decode() against one fails only
        # that call's batch
        self._decode = _Lane(
            self, "decode", "decode",
            lambda items, impl: self.codec.decode_batch(items, impl),
            size_metrics=False,
        )

    async def encode(self, data: bytes) -> tuple[list[bytes], list[bytes] | None]:
        """Queue one block; returns (pieces, piece_hashes | None) once
        its coalesced dispatch completes.  Runs in the caller's task, so
        the phase spans land on the caller's trace."""
        return await self._encode.submit(data, len(data))

    async def decode(self, pieces: dict[int, bytes], block_len: int) -> bytes:
        """Queue one degraded-read reconstruction; returns the plaintext
        block once its coalesced `decode_batch` dispatch completes."""
        return await self._decode.submit(
            (pieces, block_len), sum(len(p) for p in pieces.values())
        )

    async def close(self) -> None:
        """Fail pending waiters, reap the flushers, drop the gauges
        (registered at creation, unregistered at close)."""
        self._closed = True
        self._encode.wake.set()
        self._decode.wake.set()
        await self._encode.close()
        await self._decode.close()
