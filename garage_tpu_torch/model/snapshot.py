"""Metadata DB snapshots (reference src/model/snapshot.rs:17-35).

`garage meta snapshot` (admin op) and the optional automatic interval
produce consistent copies of the metadata database under
`<metadata_dir>/snapshots/<timestamp>/`; the two most recent are kept.
"""

from __future__ import annotations

import asyncio
import logging
import os
import re
import shutil
import time

from ..utils.background import Worker, WorkerState

logger = logging.getLogger("garage.snapshot")

KEEP = 2


def take_snapshot(garage) -> str:
    # metadata_snapshots_dir knob (reference config.rs:35): snapshots can
    # live on a different volume than the live metadata
    base = garage.config.metadata_snapshots_dir or os.path.join(
        garage.config.metadata_dir, "snapshots"
    )
    # db.snapshot below blocks by design — the engine's connection is not
    # thread-safe, so the whole snapshot pass runs on the loop; offloading
    # just the mkdir/rotation around it would be theater
    # graft-lint: allow-blocking(snapshot pass blocks by design, db conn not thread-safe)
    os.makedirs(base, exist_ok=True)
    name = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    dest = os.path.join(base, name)
    garage.db.snapshot(dest)
    # rotate: keep the most recent KEEP.  Only touch entries matching our
    # timestamp naming — metadata_snapshots_dir may be a shared volume and
    # rotation must never delete foreign data.
    snaps = sorted(
        e for e in os.listdir(base) if re.fullmatch(r"\d{8}T\d{6}Z", e)
    )
    for old in snaps[:-KEEP]:
        # graft-lint: allow-blocking(rotation rides the already-blocking snapshot pass)
        shutil.rmtree(os.path.join(base, old), ignore_errors=True)
    logger.info("metadata snapshot written to %s", dest)
    return dest


class SnapshotWorker(Worker):
    """Automatic periodic snapshots (metadata_auto_snapshot_interval)."""

    def __init__(self, garage):
        self.garage = garage
        self.interval_ms = garage.config.metadata_auto_snapshot_interval
        self.last = 0.0

    def name(self) -> str:
        return "meta_snapshot"

    async def work(self):
        if not self.interval_ms:
            return WorkerState.DONE
        now = time.monotonic()
        if now - self.last < max(self.interval_ms / 1000.0, 600):
            return WorkerState.IDLE
        self.last = now
        try:
            take_snapshot(self.garage)
        except NotImplementedError:
            return WorkerState.DONE  # memory engine: nothing to snapshot
        return WorkerState.IDLE

    async def wait_for_work(self) -> None:
        await asyncio.sleep(60.0)
