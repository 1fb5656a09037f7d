"""K2V RPC: causal-timestamp allocation + quorum insert + distributed polls.

Reference src/model/k2v/rpc.rs — an insert is routed to ONE storage node
of the item's partition (the first reachable in latency order), which
allocates the DVVS dot under a local per-item lock and then fans the
merged item out to the other replicas through the normal table path.

Polls are DISTRIBUTED (reference rpc.rs:206-262 poll_item, :264-367
poll_range): the poller fans the poll out to ALL storage nodes of the
partition and needs a read quorum of responses — a write that landed on a
different replica than the poller is still observed, because that replica
answers the poll directly; no anti-entropy round-trip is needed.  Range
polls carry a RangeSeenMarker (seen.py) so each node can compute which of
its items the client hasn't seen.
"""

from __future__ import annotations

import asyncio
import logging

from ...net.message import PRIO_HIGH, PRIO_NORMAL, Req, Resp
from ...utils.aio import reap
from ...utils.error import Error
from .item_table import CausalContext, K2VItem
from .seen import RangeSeenMarker

logger = logging.getLogger("garage.k2v")

POLL_RANGE_EXTRA_DELAY = 0.2  # wait a beat for stragglers after quorum


class SubscriptionManager:
    """Local pub/sub of item updates: per-item and per-partition channels
    (reference src/model/k2v/sub.rs)."""

    def __init__(self):
        self.item_subs: dict[tuple, list[asyncio.Queue]] = {}
        self.part_subs: dict[tuple, list[asyncio.Queue]] = {}

    def notify(self, item: K2VItem) -> None:
        ikey = (item.bucket_id, item.partition_key, item.sort_key)
        pkey = (item.bucket_id, item.partition_key)
        for q in self.item_subs.get(ikey, []):
            q.put_nowait(item)
        for q in self.part_subs.get(pkey, []):
            q.put_nowait(item)

    def subscribe_item(self, bucket_id, pk, sk) -> "_Sub":
        return _Sub(self.item_subs, (bucket_id, pk, sk))

    def subscribe_partition(self, bucket_id, pk) -> "_Sub":
        return _Sub(self.part_subs, (bucket_id, pk))


class _Sub:
    def __init__(self, registry: dict, key):
        self._registry = registry
        self._key = key
        self.queue: asyncio.Queue = asyncio.Queue()

    def __enter__(self) -> "_Sub":
        self._registry.setdefault(self._key, []).append(self.queue)
        return self

    def __exit__(self, *exc) -> None:
        subs = self._registry.get(self._key, [])
        if self.queue in subs:
            subs.remove(self.queue)
        if not subs:
            self._registry.pop(self._key, None)

    async def recv(self, deadline: float) -> K2VItem | None:
        remaining = deadline - asyncio.get_event_loop().time()
        if remaining <= 0:
            return None
        try:
            return await asyncio.wait_for(self.queue.get(), remaining)
        except asyncio.TimeoutError:
            return None


class K2VRpcHandler:
    def __init__(self, garage):
        self.garage = garage
        self.sub = SubscriptionManager()
        garage.k2v_item_table.schema.sub_manager = self.sub
        self.endpoint = garage.netapp.endpoint("k2v/rpc")
        self.endpoint.set_handler(self._handle)
        # node-global dot-allocation clock (reference rpc.rs TIMESTAMP_KEY)
        self._ts_tree = garage.k2v_item_table.data.db.open_tree("k2v_local_ts")
        # fixed-size lock pool: serializes dot allocation per item without
        # accumulating one lock per key forever
        self._locks = [asyncio.Lock() for _ in range(256)]

    # --- public API (called by the HTTP layer) --------------------------------

    def _storage_nodes(self, bucket_id: bytes, pk: str) -> list[bytes]:
        h = self.garage.k2v_item_table.schema.partition_hash(
            bucket_id + pk.encode()
        )
        return self.garage.k2v_item_table.replication.read_nodes(h)

    def _read_quorum(self) -> int:
        return self.garage.k2v_item_table.replication.read_quorum()

    async def insert(
        self,
        bucket_id: bytes,
        pk: str,
        sk: str,
        causal: CausalContext | None,
        value: bytes | None,
    ) -> None:
        """Route to a storage node of the partition for dot allocation."""
        nodes = self.garage.helper_rpc.request_order(
            self._storage_nodes(bucket_id, pk)
        )
        errors = []
        msg = [
            "Insert",
            bucket_id,
            pk,
            sk,
            causal.serialize() if causal else None,
            value,
        ]
        for n in nodes:
            try:
                await self.endpoint.call(n, msg, prio=PRIO_HIGH)
                return
            except Exception as e:  # noqa: BLE001
                errors.append(f"{n.hex()[:8]}: {e!r}")
        raise Error(f"k2v insert failed on all nodes: {errors}")

    async def insert_batch(self, bucket_id: bytes, items: list) -> None:
        """items: [(pk, sk, causal | None, value | None)] — fanned out
        concurrently (bounded) instead of one round-trip per item."""
        sem = asyncio.Semaphore(16)

        async def one(pk, sk, causal, value):
            async with sem:
                await self.insert(bucket_id, pk, sk, causal, value)

        await asyncio.gather(*[one(*it) for it in items])

    async def poll_item(
        self, bucket_id: bytes, pk: str, sk: str, causal: CausalContext, timeout: float
    ) -> K2VItem | None:
        """Fan the poll out to every replica of the partition; merge what
        comes back (reference rpc.rs:206-262).  None on timeout."""
        nodes = self._storage_nodes(bucket_id, pk)
        quorum = self._read_quorum()
        msg = ["PollItem", bucket_id, pk, sk, causal.serialize(), timeout]
        tasks = [
            asyncio.create_task(
                self.endpoint.call(n, msg, prio=PRIO_NORMAL, timeout=timeout + 10)
            )
            for n in nodes
        ]
        merged: K2VItem | None = None
        oks = errs = 0
        try:
            deadline = asyncio.get_event_loop().time() + timeout + 5
            pending = set(tasks)
            while pending:
                remaining = deadline - asyncio.get_event_loop().time()
                if remaining <= 0:
                    break
                done, pending = await asyncio.wait(
                    pending, timeout=remaining,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                for t in done:
                    if t.exception():
                        errs += 1
                        continue
                    oks += 1
                    body = t.result().body
                    if body is not None:
                        item = self.garage.k2v_item_table.schema.decode_entry(body)
                        if merged is None:
                            merged = item
                        else:
                            merged.merge(item)
                # a positive answer means the item changed: return as soon
                # as a quorum confirms we polled enough replicas
                if merged is not None and oks >= quorum:
                    break
                if errs > len(nodes) - quorum:
                    raise Error(f"poll_item: {errs} replicas failed")
        finally:
            # cancel stragglers AND consume every outcome: a replica that
            # failed between our last wait and the cancel would otherwise
            # leak an unretrieved exception (orphan-task triage)
            await reap(tasks, log=logger, what="poll_item rpc")
        if oks < quorum:
            # silently-hanging replicas count against quorum too: a
            # sub-quorum answer (or timeout) must not masquerade as an
            # authoritative "nothing changed"
            raise Error(
                f"poll_item: only {oks}/{quorum} replicas responded"
            )
        return merged

    async def poll_range(
        self,
        bucket_id: bytes,
        pk: str,
        start: str | None,
        end: str | None,
        prefix: str | None,
        seen_str: str | None,
        timeout: float,
    ) -> tuple[dict[str, K2VItem], str] | None:
        """Distributed range poll (reference rpc.rs:264-367).  Returns
        (new items by sort key, next seen marker), or None when nothing
        new arrived before the timeout (only possible with a marker)."""
        seen = RangeSeenMarker()
        if seen_str is not None:
            decoded = RangeSeenMarker.decode(seen_str)
            if decoded is None:
                raise ValueError("invalid seenMarker")
            seen = decoded
        seen.restrict(start, end, prefix)

        nodes = self._storage_nodes(bucket_id, pk)
        quorum = self._read_quorum()
        msg = ["PollRange", bucket_id, pk, start, end, prefix, seen_str, timeout]
        tasks = {
            asyncio.create_task(
                self.endpoint.call(n, msg, prio=PRIO_NORMAL, timeout=timeout + 10)
            )
            for n in nodes
        }

        resps: list[tuple[bytes, list[K2VItem]]] = []
        errors: list[str] = []
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout + 2
        pending = set(tasks)
        try:
            while pending:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                done, pending = await asyncio.wait(
                    pending, timeout=remaining,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                for t in done:
                    if t.exception():
                        errors.append(repr(t.exception()))
                        continue
                    node, rows = t.result().body
                    resps.append(
                        (
                            bytes(node),
                            [
                                self.garage.k2v_item_table.schema.decode_entry(r)
                                for r in rows
                            ],
                        )
                    )
                if len(resps) >= quorum:
                    # brief grace period for stragglers: their data shrinks
                    # the seen marker we hand back (reference rpc.rs:305-317)
                    deadline = min(
                        deadline, loop.time() + POLL_RANGE_EXTRA_DELAY
                    )
        finally:
            await reap(tasks, log=logger, what="poll_range rpc")
        if len(resps) < quorum:
            # errored AND silently-hanging replicas both count against the
            # read quorum — advancing the seen marker off a sub-quorum view
            # would skip writes held only by the unreachable replicas
            raise Error(
                f"poll_range: only {len(resps)}/{quorum} replicas "
                f"responded (errors: {errors})"
            )

        new_items: dict[str, K2VItem] = {}
        for node, items in resps:
            seen.mark_seen_node_items(node, items)
            for item in items:
                if item.sort_key in new_items:
                    new_items[item.sort_key].merge(item)
                else:
                    new_items[item.sort_key] = item
        if not new_items and seen_str is not None:
            return None
        return dict(sorted(new_items.items())), seen.encode()

    # --- rpc ------------------------------------------------------------------

    async def _handle(self, from_id: bytes, req: Req) -> Resp:
        op = req.body
        if op[0] == "Insert":
            bucket_id, pk, sk = bytes(op[1]), op[2], op[3]
            causal = CausalContext.parse(op[4]) if op[4] else None
            value = bytes(op[5]) if op[5] is not None else None
            await self._local_insert(bucket_id, pk, sk, causal, value)
            return Resp(None)
        if op[0] == "PollItem":
            bucket_id, pk, sk = bytes(op[1]), op[2], op[3]
            causal = CausalContext.parse(op[4])
            item = await self._local_poll_item(bucket_id, pk, sk, causal, float(op[5]))
            return Resp(item.to_obj() if item is not None else None)
        if op[0] == "PollRange":
            bucket_id, pk = bytes(op[1]), op[2]
            start, end, prefix, seen_str = op[3], op[4], op[5], op[6]
            items = await self._local_poll_range(
                bucket_id, pk, start, end, prefix, seen_str, float(op[7])
            )
            return Resp([self.garage.node_id, [i.to_obj() for i in items]])
        raise Error(f"unknown k2v rpc op {op[0]!r}")

    def _node_timestamp(self) -> int:
        """This node's persisted monotonic dot-allocation clock (reference
        rpc.rs local_timestamp_tree): max(persisted, wall clock ms)."""
        from ...utils.time_util import now_msec

        stored = self._ts_tree.get(b"ts")
        prev = int.from_bytes(stored, "big") if stored else 0
        return max(prev, now_msec())

    def _bump_node_timestamp(self, t: int) -> None:
        self._ts_tree.insert(b"ts", t.to_bytes(8, "big"))

    async def _local_insert(self, bucket_id, pk, sk, causal, value) -> None:
        table = self.garage.k2v_item_table
        key = bucket_id + pk.encode() + b"\x00" + sk.encode()
        from ...utils.data import blake2sum

        lock = self._locks[blake2sum(key)[0]]
        async with lock:  # graft-lint: allow-lock-await(causal RMW: the sharded item lock must span read-merge-write or concurrent inserts lose causality)
            existing = await table.get(bucket_id + pk.encode(), sk.encode())
            item = existing or K2VItem(bucket_id, pk, sk)
            new_t = item.update(
                self.garage.node_id, causal, value, self._node_timestamp()
            )
            self._bump_node_timestamp(new_t)
            await table.insert(item)

    async def _local_poll_item(
        self, bucket_id, pk, sk, causal: CausalContext, timeout: float
    ) -> K2VItem | None:
        """Replica-side poll: answer when the LOCAL copy advances past the
        token (reference rpc.rs:449-471)."""
        deadline = asyncio.get_event_loop().time() + min(timeout, 600.0)
        with self.sub.subscribe_item(bucket_id, pk, sk) as sub:
            item = await self.garage.k2v_item_table.get_local(
                bucket_id + pk.encode(), sk.encode()
            )
            while True:
                if item is not None and _newer_than(item, causal):
                    return item
                item = await sub.recv(deadline)
                if item is None:
                    return None

    async def _local_poll_range(
        self, bucket_id, pk, start, end, prefix, seen_str, timeout: float
    ) -> list[K2VItem]:
        """Replica-side range poll (reference rpc.rs:473-507): with a seen
        marker, block until something the client hasn't seen appears; with
        none, return the current state immediately (initial snapshot)."""
        if seen_str is None:
            return await self._range_snapshot(
                bucket_id, pk, start, end, prefix, RangeSeenMarker()
            )
        seen = RangeSeenMarker.decode(seen_str)
        if seen is None:
            raise Error("invalid seenMarker")
        deadline = asyncio.get_event_loop().time() + min(timeout, 600.0)
        with self.sub.subscribe_partition(bucket_id, pk) as sub:
            new_items = await self._range_snapshot(
                bucket_id, pk, start, end, prefix, seen
            )
            while not new_items:
                item = await sub.recv(deadline)
                if item is None:
                    return []
                if (
                    (start is None or item.sort_key >= start)
                    and (end is None or item.sort_key < end)
                    and (prefix is None or item.sort_key.startswith(prefix))
                    and seen.is_new_item(item)
                ):
                    new_items.append(item)
            return new_items

    async def _range_snapshot(
        self, bucket_id, pk, start, end, prefix, seen: RangeSeenMarker
    ) -> list[K2VItem]:
        """Items of the local range the marker hasn't seen (tombstones
        included — deletions are events too)."""
        out = []
        begin = max(start or "", prefix or "")
        cursor = begin.encode() if begin else None
        while True:
            batch = await self.garage.k2v_item_table.get_range_local(
                bucket_id + pk.encode(), cursor, None, 1000
            )
            if not batch:
                return out
            for item in batch:
                sk = item.sort_key
                if end is not None and sk >= end:
                    return out
                if prefix is not None and not sk.startswith(prefix):
                    if sk > prefix:
                        return out
                    continue
                if seen.is_new_item(item):
                    out.append(item)
            if len(batch) < 1000:
                return out
            cursor = batch[-1].sort_key.encode() + b"\x00"


def _newer_than(item: K2VItem, causal: CausalContext) -> bool:
    vv = item.causal_context().vv
    for node, t in vv.items():
        if t > causal.vv.get(node, 0):
            return True
    return False
