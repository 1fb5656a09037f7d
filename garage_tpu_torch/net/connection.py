"""Multiplexed RPC connection: chunked frames with priority QoS.

Wire protocol inside the encrypted channel (my design; the reference's
equivalent is src/net/send.rs:17-110 chunk framing + round-robin scheduler):

  frame = [kind u8][flags u8][id u32][payload...]      (<= 16 KiB payload)
  kinds: 1=REQ_META 2=RESP_META 3=BODY 4=STREAM 5=CANCEL
  flags: FIN=1 (last chunk of body/stream), ERR=2 (response is an error)

A message is sent as META, then BODY chunks (FIN on last), then — if a
byte stream is attached — STREAM chunks (FIN on last, possibly empty).

The send scheduler keeps one queue of in-flight message generators per
priority level and interleaves chunks round-robin within a level, always
draining higher-priority levels first: a huge BACKGROUND resync transfer
adds at most one chunk of latency to a HIGH quorum RPC on the same
connection — this is the QoS that keeps repair from starving PUT/GET.

Stream flow control is CREDIT-BASED (reference analog: kuska/netapp has
none; this mirrors HTTP/2 WINDOW_UPDATE): each attached stream starts
with STREAM_WINDOW bytes of send credit; the receiver grants more
(CREDIT frames, u32 bytes) as the consuming application actually reads.
A sender that runs out of credit PARKS its message — it stops occupying
the scheduler without blocking other messages — and resumes when credit
arrives, so a slow stream consumer backpressures its producer instead of
overflowing the receiver's buffer.
"""

from __future__ import annotations

import asyncio
import heapq
import logging
import struct
from typing import Any, AsyncIterator, Awaitable, Callable

from ..utils.serde import pack as _pack, unpack as _unpack
from .handshake import FramedBox
from .message import N_PRIO_LEVELS, PRIO_NORMAL, Req, Resp, prio_level
from .stream import StreamWriter

logger = logging.getLogger("garage.net")

CHUNK = 16 * 1024
STREAM_WINDOW = 1024 * 1024  # initial per-stream send credit
GRANT_BATCH = 256 * 1024  # receiver grants credit in batches this big

K_REQ_META = 1
K_RESP_META = 2
K_BODY = 3
K_STREAM = 4
K_CANCEL = 5
K_CREDIT = 6
K_WAIT = 0  # internal sentinel: generator parked awaiting stream credit

F_FIN = 1
F_ERR = 2


class RemoteError(Exception):
    pass


class ConnectionClosed(Exception):
    pass


class _Outgoing:
    """One message being sent: frames yielded chunk by chunk."""

    __slots__ = ("frames", "rid", "aborted", "owns_credit", "tag", "level")

    def __init__(
        self, frames, rid: int, owns_credit: bool = False,
        tag: tuple | None = None, level: int = 0,
    ):
        self.frames = frames  # async iterator of (kind, flags, id, payload)
        self.rid = rid
        self.aborted = False
        # True only for the message that registered _out_credit[rid]:
        # control frames (CREDIT grants, CANCELs) share the rid and must
        # not tear the credit down when they finish
        self.owns_credit = owns_credit
        # order-tag key + seq for sender-side stream serialization
        self.tag = tag  # ((mine, sid), seq) or None
        self.level = level


class _StreamCredit:
    """Sender-side credit for one attached stream."""

    __slots__ = ("avail", "parked")

    def __init__(self, initial: int = STREAM_WINDOW):
        self.avail = initial
        self.parked: tuple[int, _Outgoing] | None = None  # (level, out)

    def grant(self, n: int, conn: "Connection") -> None:
        self.avail += n
        if self.parked is not None and self.avail > 0:
            lvl, out = self.parked
            self.parked = None
            conn._send_queues[lvl].put_nowait(out)
            conn._send_wakeup.set()


async def _frames_of(
    kind_meta: int,
    rid: int,
    meta: dict,
    body: bytes,
    stream: AsyncIterator[bytes] | None,
    credit: _StreamCredit | None = None,
):
    """Async generator of frames for one message.  When stream credit is
    exhausted it yields a K_WAIT sentinel instead of blocking — the send
    loop parks the message so other traffic keeps flowing."""
    yield (kind_meta, 0, rid, _pack(meta))
    if body or stream is None:
        n = max(1, (len(body) + CHUNK - 1) // CHUNK)
        for i in range(n):
            part = body[i * CHUNK : (i + 1) * CHUNK]
            fin = F_FIN if i == n - 1 else 0
            yield (K_BODY, fin, rid, part)
    else:
        yield (K_BODY, F_FIN, rid, b"")
    if stream is not None:
        pending = b""
        async for chunk in stream:
            pending += chunk
            while len(pending) >= CHUNK:
                while credit is not None and credit.avail <= 0:
                    yield (K_WAIT, 0, rid, b"")
                if credit is not None:
                    credit.avail -= CHUNK
                yield (K_STREAM, 0, rid, pending[:CHUNK])
                pending = pending[CHUNK:]
        while credit is not None and pending and credit.avail <= 0:
            yield (K_WAIT, 0, rid, b"")
        if credit is not None:
            credit.avail -= len(pending)
        yield (K_STREAM, F_FIN, rid, pending)


class Connection:
    """One authenticated, multiplexed peer connection (either direction)."""

    def __init__(
        self,
        box: FramedBox,
        handler: Callable[[str, bytes, Req], Awaitable[Resp]] | None,
        on_close: Callable[["Connection"], None] | None = None,
        initiator: bool = False,
    ):
        self.box = box
        self.peer_id: bytes = box.peer_id
        self.handler = handler
        self.on_close = on_close
        # Request ids must not collide between the two directions of the
        # connection: the dialing side uses odd rids, the accepting side
        # even, and frames are routed by rid parity.
        self.initiator = initiator
        self._next_id = 1 if initiator else 2
        self._send_queues: list[asyncio.Queue] = [
            asyncio.Queue() for _ in range(N_PRIO_LEVELS)
        ]
        self._send_wakeup = asyncio.Event()
        # in-flight requests we sent: id -> (resp future, stream writer slot)
        self._pending: dict[int, dict] = {}
        # in-flight requests we are receiving: id -> partial state
        self._incoming: dict[int, dict] = {}
        # send credit for streams we are transmitting, by rid
        self._out_credit: dict[int, _StreamCredit] = {}
        # stream-bearing messages currently circulating in the send
        # queues, by rid — so a peer CANCEL can abort them mid-flight
        # (they are reachable neither via _pending nor via credit.parked)
        self._active_out: dict[int, _Outgoing] = {}
        # ordered sub-streams (reference src/net/message.rs:62-89): among
        # same-tag messages pending at once, transmit ONE at a time in
        # ascending seq order, so a prefetch pipeline's responses stream
        # back-to-back instead of interleaving.  Keyed by (mine, sid) —
        # our requests and our responses echoing the REMOTE's sids must
        # not share a namespace.  (mine, sid) -> {"active", "waiting"}
        self._order: dict[tuple, dict] = {}
        self._tasks: list[asyncio.Task] = []
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def start(self) -> None:
        self._tasks.append(asyncio.create_task(self._send_loop()))
        self._tasks.append(asyncio.create_task(self._recv_loop()))

    # --- sending -------------------------------------------------------------

    async def call(
        self,
        endpoint: str,
        req: Req,
        prio: int = PRIO_NORMAL,
        timeout: float | None = 30.0,
    ) -> Resp:
        """Send a request, await the response (body complete; stream may
        continue arriving afterwards)."""
        if self._closed:
            raise ConnectionClosed("connection closed")
        rid = self._next_id
        self._next_id += 2
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[rid] = {"fut": fut}
        meta = {
            "ep": endpoint,
            "prio": prio,
            "hs": req.stream is not None,
            "ot": req.order_tag.to_obj() if req.order_tag else None,
        }
        if req.traceparent is not None:
            # distributed tracing: the serving node parents its handler
            # span under ours (absent when tracing is off — the wire
            # format is byte-identical to the untraced one)
            meta["tp"] = req.traceparent
        credit = None
        if req.stream is not None:
            credit = self._out_credit[rid] = _StreamCredit()
        frames = _frames_of(
            K_REQ_META, rid, meta, _pack(req.body), req.stream, credit
        )
        out = await self._enqueue(
            prio, frames, rid, owns_credit=credit is not None,
            order_tag=req.order_tag,
        )
        self._pending[rid]["out"] = out
        try:
            if timeout is not None:
                return await asyncio.wait_for(fut, timeout)
            return await fut
        except (asyncio.TimeoutError, asyncio.CancelledError):
            self._abort_out(rid)  # stop transmitting remaining chunks
            self._pending.pop(rid, None)
            await self._enqueue(0, _one_frame(K_CANCEL, 0, rid, b""), rid)
            raise

    def _rid_is_mine(self, rid: int) -> bool:
        return (rid & 1) == (1 if self.initiator else 0)

    def _abort_out(self, rid: int) -> None:
        """Stop transmitting rid's message (half-close): mark it aborted —
        whether it is a request we sent (_pending), a response stream
        mid-transmission (_active_out), or PARKED on stream credit (which
        needs a requeue so the send loop finalizes it) — otherwise the
        producer generator and credit entry leak until the connection
        closes."""
        credit = self._out_credit.get(rid)
        p = self._pending.get(rid)
        out = p.get("out") if p else None
        if out is not None:
            out.aborted = True
        active = self._active_out.get(rid)
        if active is not None:
            active.aborted = True
        if credit is not None and credit.parked is not None:
            lvl, parked_out = credit.parked
            credit.parked = None
            parked_out.aborted = True
            self._send_queues[lvl].put_nowait(parked_out)
            self._send_wakeup.set()

    async def _enqueue(
        self, prio: int, frames, rid: int, owns_credit: bool = False,
        order_tag=None,
    ) -> _Outgoing:
        lvl = prio_level(prio)
        tag = None
        if order_tag is not None:
            tag = ((self._rid_is_mine(rid), order_tag.stream), order_tag.seq)
        out = _Outgoing(frames, rid, owns_credit=owns_credit, tag=tag, level=lvl)
        if owns_credit:
            self._active_out[rid] = out
        if tag is not None:
            ent = self._order.setdefault(tag[0], {"active": False, "waiting": []})
            if ent["active"]:
                heapq.heappush(ent["waiting"], (tag[1], rid, out))
                return out
            ent["active"] = True
        self._send_queues[lvl].put_nowait(out)
        self._send_wakeup.set()
        return out

    def _order_release(self, out: _Outgoing) -> None:
        """The tagged message finished (sent fully, aborted, or errored):
        start the smallest-seq waiter, or retire the stream state.  Never
        waits for seqs that were never enqueued — a gap (cancelled
        request) cannot wedge the stream."""
        if out.tag is None:
            return
        out.tag, key = None, out.tag[0]  # guard double release
        ent = self._order.get(key)
        if ent is None:
            return
        if ent["waiting"]:
            _seq, _rid, nxt = heapq.heappop(ent["waiting"])
            self._send_queues[nxt.level].put_nowait(nxt)
            self._send_wakeup.set()
        else:
            del self._order[key]

    async def _send_loop(self) -> None:
        try:
            while not self._closed:
                out = None
                for q in self._send_queues:
                    if not q.empty():
                        out = q.get_nowait()
                        lvl = self._send_queues.index(q)
                        break
                if out is None:
                    self._send_wakeup.clear()
                    await self._send_wakeup.wait()
                    continue
                if out.aborted:
                    # caller gave up: drop remaining chunks and release the
                    # producer generator + its credit entry
                    try:
                        await out.frames.aclose()
                    except Exception as e:  # noqa: BLE001
                        logger.debug(
                            "closing aborted stream rid %d: %r", out.rid, e
                        )
                    if out.owns_credit:
                        self._out_credit.pop(out.rid, None)
                        self._active_out.pop(out.rid, None)
                    self._order_release(out)
                    continue
                # send ONE chunk of this message, then rotate it to the back
                # of its level queue (round-robin within priority)
                try:
                    frame = await out.frames.__anext__()
                except StopAsyncIteration:
                    if out.owns_credit:
                        self._out_credit.pop(out.rid, None)
                        self._active_out.pop(out.rid, None)
                    self._order_release(out)
                    continue
                except Exception as e:  # stream producer failed mid-message
                    logger.warning(
                        "stream producer error on rid %d: %r", out.rid, e
                    )
                    # terminate the half-sent message so the peer's handler
                    # isn't left waiting on a stream that never ends
                    self.box.send_frame(
                        struct.pack("<BBI", K_CANCEL, 0, out.rid)
                    )
                    await self.box.drain()
                    # if it was our own request, fail the caller immediately
                    p = self._pending.pop(out.rid, None)
                    if p:
                        fut = p.get("fut")
                        if fut and not fut.done():
                            fut.set_exception(e)
                        if p.get("writer"):
                            await p["writer"].close(f"request aborted: {e}")
                    # the message is dead: release its credit bookkeeping
                    # like the aborted/exhausted branches do
                    if out.owns_credit:
                        self._out_credit.pop(out.rid, None)
                        self._active_out.pop(out.rid, None)
                    self._order_release(out)
                    continue
                kind, flags, rid, payload = frame
                if kind == K_WAIT:
                    # out of stream credit: park; a CREDIT frame requeues it
                    credit = self._out_credit.get(rid)
                    if credit is None or credit.avail > 0:
                        self._send_queues[lvl].put_nowait(out)  # raced a grant
                    else:
                        credit.parked = (lvl, out)
                    continue
                self.box.send_frame(
                    struct.pack("<BBI", kind, flags, rid) + payload
                )
                await self.box.drain()
                if out.tag is not None:
                    # preemption (reference send.rs:135): if a SMALLER seq
                    # of this ordered stream arrived while we streamed,
                    # park this message and let the earlier one take over
                    ent = self._order.get(out.tag[0])
                    if (
                        ent is not None
                        and ent["waiting"]
                        and ent["waiting"][0][0] < out.tag[1]
                    ):
                        heapq.heappush(
                            ent["waiting"], (out.tag[1], out.rid, out)
                        )
                        _s, _r, nxt = heapq.heappop(ent["waiting"])
                        self._send_queues[nxt.level].put_nowait(nxt)
                        continue
                self._send_queues[lvl].put_nowait(out)
        except asyncio.CancelledError:
            # close() cancelled us: teardown runs in the finally, then
            # the cancel propagates so the task ends *cancelled* (a
            # swallowed cancel made close()'s reap believe the loop
            # finished on its own — cancel safety)
            raise
        except (ConnectionResetError, BrokenPipeError):
            pass
        except Exception as e:
            logger.warning("send loop error: %r", e)
        finally:
            # shielded: a cancel landing while teardown itself is
            # suspended must not abandon it half-way (pending RPC
            # futures would never resolve and breakers stay pinned
            # open for the whole adaptive timeout)
            await asyncio.shield(self._teardown())

    # --- receiving -----------------------------------------------------------

    async def _recv_loop(self) -> None:
        try:
            while not self._closed:
                frame = await self.box.recv_frame()
                kind, flags, rid = struct.unpack("<BBI", frame[:6])
                payload = frame[6:]
                if kind == K_REQ_META:
                    self._incoming[rid] = {
                        "meta": _unpack(payload),
                        "body": [],
                        "writer": None,
                    }
                elif kind == K_RESP_META:
                    p = self._pending.get(rid)
                    if p is not None:
                        p["meta"] = _unpack(payload)
                        p["body"] = []
                elif kind == K_BODY:
                    await self._on_body(rid, flags, payload)
                elif kind == K_STREAM:
                    await self._on_stream(rid, flags, payload)
                elif kind == K_CREDIT:
                    credit = self._out_credit.get(rid)
                    if credit is not None:
                        (n,) = struct.unpack("<I", payload)
                        credit.grant(n, self)
                elif kind == K_CANCEL:
                    self._abort_out(rid)  # stop any stream we send on rid
                    if self._rid_is_mine(rid):
                        # peer aborted its response (e.g. stream producer
                        # failed server-side)
                        p = self._pending.pop(rid, None)
                        if p:
                            fut = p.get("fut")
                            if fut and not fut.done():
                                fut.set_exception(RemoteError("cancelled by peer"))
                            if p.get("writer"):
                                await p["writer"].close("cancelled by peer")
                    else:
                        st = self._incoming.pop(rid, None)
                        if st:
                            # close the stream first so a handler blocked on
                            # it fails with a StreamError, then cancel
                            if st.get("writer"):
                                await st["writer"].close("cancelled by peer")
                            if st.get("task"):
                                st["task"].cancel()
        except asyncio.CancelledError:
            raise  # see _send_loop: teardown in finally, end cancelled
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception as e:
            logger.warning("recv loop error: %r", e)
        finally:
            # shielded for the same reason as _send_loop's teardown
            await asyncio.shield(self._teardown())

    async def _on_body(self, rid: int, flags: int, payload: bytes) -> None:
        if not self._rid_is_mine(rid):
            # request being received (we are the serving side of this rid)
            st = self._incoming.get(rid)
            if st is None:
                return
            st["body"].append(payload)
            if flags & F_FIN:
                body = _unpack(b"".join(st["body"]))
                writer = StreamWriter(on_consume=self._granter(rid))
                st["writer"] = writer
                if not st["meta"].get("hs"):
                    await writer.close()  # no attached stream coming
                req = Req(
                    body,
                    stream=writer.reader(),
                    traceparent=st["meta"].get("tp"),
                )
                st["task"] = asyncio.create_task(self._run_handler(rid, st, req))
            return
        p = self._pending.get(rid)  # response being received (calling side)
        if p is None:
            return
        p.setdefault("body", []).append(payload)
        if flags & F_FIN:
            body = _unpack(b"".join(p["body"]))
            writer = StreamWriter(on_consume=self._granter(rid))
            p["writer"] = writer
            meta = p.get("meta", {})
            fut: asyncio.Future = p["fut"]
            # half-close: once the peer has answered, any still-unsent tail
            # of OUR request stream is useless — stop transmitting it
            # (otherwise a handler that answered early leaves our producer
            # parked on credit forever)
            self._abort_out(rid)
            if meta.get("err"):
                if not fut.done():
                    fut.set_exception(RemoteError(meta["err"]))
                self._pending.pop(rid, None)
                return
            if not meta.get("hs"):
                await writer.close()
                self._pending.pop(rid, None)
            if not fut.done():
                fut.set_result(Resp(body, stream=writer.reader()))

    async def _on_stream(self, rid: int, flags: int, payload: bytes) -> None:
        if self._rid_is_mine(rid):
            p = self._pending.get(rid)
            target = p.get("writer") if p else None
        else:
            st = self._incoming.get(rid)
            target = st.get("writer") if st else None
        if target is None:
            return
        if payload:
            await target.feed(payload)
        if flags & F_FIN:
            await target.close()
            if self._rid_is_mine(rid):
                self._pending.pop(rid, None)  # response fully received

    def _granter(self, rid: int):
        """Batched credit grants for a stream we are receiving: called by
        the StreamWriter as the application consumes bytes."""
        acc = 0

        def on_consume(n: int) -> None:
            nonlocal acc
            acc += n
            if acc >= GRANT_BATCH and not self._closed:
                grant, acc = acc, 0
                self._send_queues[0].put_nowait(
                    _Outgoing(
                        _one_frame(K_CREDIT, 0, rid, struct.pack("<I", grant)),
                        rid,
                    )
                )
                self._send_wakeup.set()

        return on_consume

    async def _run_handler(self, rid: int, st: dict, req: Req) -> None:
        from .message import OrderTag

        meta = st["meta"]
        # response streams ride the request's order tag (or an explicit
        # one the handler sets): a tagged GET prefetch pipeline's blocks
        # transmit one at a time, in seq order
        ot = OrderTag.from_obj(meta.get("ot"))
        try:
            resp = await self.handler(meta["ep"], self.peer_id, req)
            if resp.order_tag is not None:
                ot = resp.order_tag
            rmeta = {
                "err": None,
                "hs": resp.stream is not None,
                "ot": ot.to_obj() if ot else None,
            }
            credit = None
            if resp.stream is not None:
                credit = self._out_credit[rid] = _StreamCredit()
            frames = _frames_of(
                K_RESP_META, rid, rmeta, _pack(resp.body), resp.stream, credit
            )
        except asyncio.CancelledError:
            # peer abort (K_CANCEL) or teardown cancelled the handler:
            # drop the request state, then end *cancelled* so the
            # supervisor sees a cancelled task, not a completed one
            self._incoming.pop(rid, None)
            raise
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            logger.debug("handler error for %s: %r", meta.get("ep"), e)
            frames = _frames_of(
                K_RESP_META, rid, {"err": f"{type(e).__name__}: {e}"}, _pack(None), None
            )
        await self._enqueue(
            meta.get("prio", PRIO_NORMAL), frames, rid,
            owns_credit=rid in self._out_credit,
            order_tag=ot,
        )
        self._incoming.pop(rid, None)

    # --- teardown ------------------------------------------------------------

    async def _teardown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for rid, p in list(self._pending.items()):
            fut = p.get("fut")
            if fut and not fut.done():
                fut.set_exception(ConnectionClosed("connection lost"))
            w = p.get("writer")
            if w:
                await w.close("connection lost")
        self._pending.clear()
        for rid, st in list(self._incoming.items()):
            if st.get("task"):
                st["task"].cancel()
            if st.get("writer"):
                await st["writer"].close("connection lost")
        self._incoming.clear()
        self._out_credit.clear()
        self._active_out.clear()
        self._send_wakeup.set()
        try:
            self.box.writer.close()
        except Exception as e:  # noqa: BLE001
            logger.debug("transport close during teardown: %r", e)
        if self.on_close:
            self.on_close(self)

    async def close(self) -> None:
        from ..utils.aio import reap

        for t in self._tasks:
            t.cancel()
        await self._teardown()
        # drain the send/recv loops, consuming their outcomes (a loop
        # that died of a real error logs it at debug instead of leaking
        # an unretrieved-exception warning)
        await reap(self._tasks, log=logger, what="connection loop")


async def _one_frame(kind, flags, rid, payload):
    yield (kind, flags, rid, payload)
