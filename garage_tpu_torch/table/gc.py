"""3-phase tombstone garbage collection.

Reference src/table/gc.rs:33-120 and the safety argument in
doc/book/design/internals.md:79-128: a tombstone may only disappear once
every storage node holds it (otherwise a node that missed the deletion
could resurrect the entry via anti-entropy).  Therefore, after a 24 h
delay (tombstone was quorum-written long ago):

  1. push the tombstone value to ALL storage nodes — all must ack
  2. send DeleteIfEqualHash(key, value_hash) to ALL storage nodes — the
     delete is skipped anywhere the value changed in the meantime
  3. drop the gc_todo entry

RPC ops on `table/<name>/gc`:
  ["U", [values...]]   apply tombstone values
  ["D", [[key, value_hash]...]]   delete-if-equal-hash
"""

from __future__ import annotations

import asyncio
import logging

from ..net.message import PRIO_BACKGROUND, Req, Resp
from ..utils.background import Worker, WorkerState
from ..utils.data import blake2sum
from ..utils.time_util import now_msec

logger = logging.getLogger("garage.table.gc")

GC_BATCH = 32
RETRY_DELAY_MS = 10 * 60 * 1000  # failed GC retries in 10 min


class TableGc:
    def __init__(self, table):
        self.table = table
        self.data = table.data
        self.endpoint = table.system.netapp.endpoint(
            f"table/{table.schema.table_name}/gc"
        )
        self.endpoint.set_handler(self._handle)

    async def _handle(self, from_id: bytes, req: Req) -> Resp:
        op = req.body
        if op[0] == "U":
            for v in op[1]:
                self.data.update_entry(bytes(v))
            return Resp(None)
        if op[0] == "D":
            for k, vh in op[1]:
                self.data.delete_if_equal_hash(bytes(k), bytes(vh))
            return Resp(None)
        raise ValueError(f"unknown gc op {op[0]!r}")

    async def gc_round(self) -> int:
        """Collect one batch of due tombstones; returns number collected."""
        now = now_msec()
        batch: list[tuple[bytes, bytes, bytes]] = []  # (todo_key, key, vhash)
        for tk, vhash in self.data.gc_todo.iter_range():
            deadline = int.from_bytes(tk[:8], "big")
            if deadline > now:
                break
            key = tk[8:]
            cur = self.data.store.get(key)
            if cur is None or blake2sum(cur) != vhash:
                # entry changed or already gone: obsolete todo item
                self.data.gc_todo.remove(tk)
                continue
            batch.append((tk, key, bytes(vhash)))
            if len(batch) >= GC_BATCH:
                break
        if not batch:
            return 0

        # group by storage node set
        by_nodes: dict[tuple, list[tuple[bytes, bytes, bytes]]] = {}
        for tk, key, vhash in batch:
            nodes = tuple(self.table.replication.storage_nodes(key[:32]))
            by_nodes.setdefault(nodes, []).append((tk, key, vhash))

        collected = 0
        for nodes, items in by_nodes.items():
            values = [self.data.store.get(k) for _tk, k, _vh in items]
            values = [v for v in values if v is not None]
            try:
                # phase 1: every storage node must hold the tombstone
                await self._call_all(list(nodes), ["U", values])
                # phase 2: delete everywhere (incl. locally) if unchanged
                await self._call_all(
                    list(nodes), ["D", [[k, vh] for _tk, k, vh in items]]
                )
            except Exception as e:  # noqa: BLE001
                logger.debug("gc round failed, will retry: %r", e)
                for tk, key, vhash in items:
                    self.data.gc_todo.remove(tk)
                    retry_at = now_msec() + RETRY_DELAY_MS
                    self.data.gc_todo.insert(
                        retry_at.to_bytes(8, "big") + key, vhash
                    )
                continue
            # phase 3: forget
            for tk, _k, _vh in items:
                self.data.gc_todo.remove(tk)
            collected += len(items)
        return collected

    async def _call_all(self, nodes: list[bytes], msg) -> None:
        """All nodes must succeed (GC requires full acknowledgement)."""
        results = await self.table.helper.call_many(
            self.endpoint, nodes, msg, prio=PRIO_BACKGROUND, timeout=60.0
        )
        errs = [r for _n, r in results if isinstance(r, Exception)]
        if errs:
            raise errs[0]

    def worker(self) -> Worker:
        return _GcWorker(self)


class _GcWorker(Worker):
    def __init__(self, gc: TableGc):
        self.gc = gc

    def name(self) -> str:
        return f"gc:{self.gc.table.schema.table_name}"

    def status(self):
        return {"queued": len(self.gc.data.gc_todo)}

    async def work(self):
        n = await self.gc.gc_round()
        return WorkerState.BUSY if n else WorkerState.IDLE

    async def wait_for_work(self) -> None:
        await asyncio.sleep(60.0)
