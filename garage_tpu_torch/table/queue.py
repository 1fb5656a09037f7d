"""Insert-queue worker: batches async local inserts into quorum writes
(reference src/table/queue.rs:15-44)."""

from __future__ import annotations

import asyncio
import logging

from ..utils.background import Worker, WorkerState

logger = logging.getLogger("garage.table.queue")

BATCH = 100


class InsertQueueWorker(Worker):
    def __init__(self, table):
        self.table = table

    def name(self) -> str:
        return f"queue:{self.table.schema.table_name}"

    def status(self):
        return {"queued": len(self.table.data.insert_queue)}

    async def work(self):
        keys, entries = [], []
        for k, v in self.table.data.insert_queue.iter_range():
            keys.append(k)
            entries.append(self.table.data.decode(v))
            if len(entries) >= BATCH:
                break
        if not entries:
            return WorkerState.IDLE
        await self.table.insert_many(entries)  # errors => supervisor backoff
        for k in keys:
            self.table.data.insert_queue.remove(k)
        return WorkerState.BUSY

    async def wait_for_work(self) -> None:
        await asyncio.sleep(1.0)
