"""Scrub / repair / rebalance workers (reference src/block/repair.rs).

RepairWorker  — walk the whole rc table and queue every block for resync;
                one-shot, spawned by the CLI `repair blocks` command.
ScrubWorker   — continuously read + verify every block file on disk
                (tranquilized pacing; corrupted files are quarantined and
                queued for re-fetch).  Progress (cursor) is persisted so
                restarts resume.  The EC scrub batches piece hashing
                through kernel K2 on the codec's device.
RebalanceWorker — move block files to their new primary directory after a
                multi-drive layout change; one-shot, spawned by the CLI
                `repair rebalance` command.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

import numpy as np
import torch

from .. import _native
from ..ops.ec_cuda import blake3_supported_len
from ..ops.hash_cuda import blake3_batch
from ..utils.background import Worker, WorkerState
from ..utils.migrate import Migratable
from ..utils.persister import Persister
from ..utils.tranquilizer import Tranquilizer

logger = logging.getLogger("garage.block.repair")

SCRUB_BATCH = 16
SCRUB_REST_SECS = 3600.0  # between two passes


def _device_hashes(device: torch.device, batch: np.ndarray) -> np.ndarray:
    """BLAKE3 of each row of `batch` (n, L) through kernel K2 on `device`
    (the plain version on the CPU) -> (n, 32) uint8."""
    # graft-lint: allow-recompile(the scrub hashes at most SCRUB_BATCH rows of one piece length a step; K2 builds nothing per shape)
    return blake3_batch(torch.from_numpy(batch).to(device)).cpu().numpy()


class RepairWorker(Worker):
    """Re-examine every known block (one-shot).

    Replica mode queues everything through the resync loop.  EC mode takes
    the batched path: blocks whose local piece is missing are repaired in
    groups of EC_REPAIR_BATCH through BlockCodec.reconstruct_batch — one
    grouped device dispatch per erasure pattern."""

    EC_REPAIR_BATCH = 256

    def __init__(self, manager):
        self.manager = manager
        self.cursor: bytes | None = b""
        self.queued = 0
        self.rebuilt = 0

    def name(self) -> str:
        return "block_repair"

    def status(self):
        return {
            "queued": self.queued,
            "rebuilt": self.rebuilt,
            "done": self.cursor is None,
        }

    async def work(self):
        if self.cursor is None:
            return WorkerState.DONE
        ec = self.manager.codec.n_pieces > 1
        n = 0
        batch: list[bytes] = []
        for key, _v in self.manager.rc.tree.iter_range(start=self.cursor):
            if ec:
                batch.append(key)
            else:
                self.manager.resync.queue_block(key)
            self.cursor = key + b"\x00"
            self.queued += 1
            n += 1
            if n >= (self.EC_REPAIR_BATCH if ec else 100):
                break
        if not n:
            self.cursor = None
            return WorkerState.BUSY
        if ec and batch:
            # same round function + metric families as the repair planner
            # (block/repair_plan.py), so `repair blocks` rounds land in
            # repair_plan_batch_size / repair_plan_blocks_total too
            from .repair_plan import drive_bulk

            self.rebuilt += await drive_bulk(self.manager, batch)
        return WorkerState.BUSY


class ScrubPersisted(Migratable):
    VERSION_MARKER = b"GT0scrub"

    def __init__(self, cursor: bytes = b"", tranquility: int = 4, corruptions: int = 0):
        self.cursor = cursor
        self.tranquility = tranquility
        self.corruptions = corruptions

    def to_obj(self):
        return [self.cursor, self.tranquility, self.corruptions]

    @classmethod
    def from_obj(cls, obj):
        return cls(bytes(obj[0]), int(obj[1]), int(obj[2]))


class ScrubWorker(Worker):
    """Verify every stored block against its hash, slowly and forever."""

    def __init__(self, manager, metadata_dir: str | None = None):
        self.manager = manager
        self.tranquilizer = Tranquilizer()
        self.persister = (
            Persister(metadata_dir, "scrub_info", ScrubPersisted)
            if metadata_dir
            else None
        )
        self.state = (self.persister.load() if self.persister else None) or ScrubPersisted()
        self.paused = False
        # the rest after a pass ends at this monotonic time; the operator's
        # start command ends it at once through `_wake`
        self._rest_until: float | None = None
        self._wake = asyncio.Event()

    def name(self) -> str:
        return "scrub"

    def status(self):
        return {
            "cursor": self.state.cursor.hex()[:16],
            "corruptions": self.state.corruptions,
            "paused": self.paused,
        }

    def tranquility(self) -> int | None:
        return self.state.tranquility

    # --- operator controls (reference `garage repair scrub {…}`) -------------

    def cmd_start(self) -> None:
        """Begin a fresh pass immediately."""
        self.state.cursor = b""
        self.paused = False
        self._save()
        self._end_rest()

    def cmd_pause(self) -> None:
        self.paused = True

    def cmd_resume(self) -> None:
        self.paused = False

    def _end_rest(self) -> None:
        self._rest_until = None
        self._wake.set()

    async def wait_for_work(self) -> None:
        """Rest until the pass's rest is over or a command ends it."""
        left = None if self._rest_until is None else self._rest_until - time.monotonic()
        try:
            await asyncio.wait_for(self._wake.wait(), left)
        except asyncio.TimeoutError:
            pass
        self._wake.clear()

    def cmd_cancel(self) -> None:
        """Abort the in-progress pass (the next one starts from zero)."""
        self.state.cursor = b""
        self.paused = True
        self._save()

    def cmd_set_tranquility(self, t: int) -> None:
        self.state.tranquility = max(0, int(t))
        self._save()

    async def work(self):
        if self.paused:
            return (WorkerState.THROTTLED, 5.0)
        if self._rest_until is not None:
            if time.monotonic() < self._rest_until:
                return WorkerState.IDLE
            self._rest_until = None
        self.tranquilizer.reset()
        n = 0
        for key, _v in self.manager.rc.tree.iter_range(start=self.state.cursor):
            hash32 = key
            await self._scrub_one(hash32)
            self.state.cursor = key + b"\x00"
            n += 1
            if n >= SCRUB_BATCH:
                break
        if n == 0:
            # cycle complete: restart from the beginning after a long rest,
            # which `repair scrub start` cuts short
            self.state.cursor = b""
            await self._save_async()
            self._rest_until = time.monotonic() + SCRUB_REST_SECS
            return WorkerState.IDLE
        await self._save_async()
        delay = self.tranquilizer.tranquilize_delay(self.state.tranquility)
        return (WorkerState.THROTTLED, max(delay, 0.05))

    async def _scrub_one(self, hash32: bytes) -> None:
        mgr = self.manager
        if mgr.codec.n_pieces > 1:
            await self._scrub_pieces([hash32])
            return
        found = mgr.find_block_file(hash32)
        if found is None:
            return
        data = await mgr.read_block_local(hash32)  # verifies + quarantines
        if data is None and mgr.rc.is_needed(hash32):
            self.state.corruptions += 1
            logger.warning("scrub: corrupted block %s queued for refetch", hash32.hex()[:16])

    async def _scrub_pieces(self, hashes: list[bytes]) -> None:
        """Verify every local EC piece of `hashes` against its header
        BLAKE3.  Equal-length pieces are hashed in ONE batch, so a scrub
        pass over thousands of shards is a few dispatches.  The piece
        length decides where, before any call: lengths the batched
        device hasher takes go to kernel K2 on the codec's device (its
        plain version for a CPU codec), the others to the host library.
        A failed launch raises out of the scrub step."""
        from .manager import _read_file_sync, stored_piece_parts

        mgr = self.manager
        groups: dict[int, list[tuple[bytes, int, str, bytes, bytes]]] = {}
        for h in hashes:
            for pi, (path, compressed) in mgr.local_pieces(h).items():
                try:
                    stored = await asyncio.to_thread(_read_file_sync, path)
                except OSError:
                    continue
                parts = stored_piece_parts(stored)
                if parts is None:
                    continue  # v1 piece: no integrity hash to check
                blen, want, piece = parts
                groups.setdefault(len(piece), []).append(
                    (h, pi, path, want, piece)
                )
        for plen, items in groups.items():
            # worker-thread hops for the WHOLE group path: the np.stack is
            # a copy of the group, the device hash ends in a device->host
            # copy, and the host hash is a long CPU run — any of them
            # dispatched inline stalls the event loop for the whole scrub
            # batch
            batch = await asyncio.to_thread(
                np.stack,
                [np.frombuffer(p, dtype=np.uint8) for *_x, p in items],
            )
            if blake3_supported_len(plen):
                got = await asyncio.to_thread(_device_hashes, mgr.codec.device, batch)
            else:
                got = await asyncio.to_thread(_native.blake3_batch, batch)
            for idx, (h, pi, path, want, piece) in enumerate(items):
                if bytes(got[idx]) != want:
                    self.state.corruptions += 1
                    logger.warning(
                        "scrub: corrupted piece %d of %s quarantined",
                        pi, h.hex()[:16],
                    )
                    await mgr._quarantine(path)
                    mgr.resync.queue_block(h)

    def _save(self):
        if self.persister:
            self.persister.save(self.state)

    async def _save_async(self):
        # work()-path checkpoints fsync off the event loop (loop-blocker);
        # the sync _save stays for the operator cmd_* one-shots
        if self.persister:
            await self.persister.save_in_thread(self.state)


class RebalanceWorker(Worker):
    """Move block files onto their current primary directory (one-shot)."""

    def __init__(self, manager):
        self.manager = manager
        self.cursor: bytes | None = b""
        self.moved = 0

    def name(self) -> str:
        return "rebalance"

    def status(self):
        return {"moved": self.moved, "done": self.cursor is None}

    async def work(self):
        if self.cursor is None:
            return WorkerState.DONE
        mgr = self.manager
        n = 0
        for key, _v in mgr.rc.tree.iter_range(start=self.cursor):
            self.cursor = key + b"\x00"
            n += 1
            primary = mgr.data_layout.primary_dir(key)
            want_dir = mgr.data_layout.block_dir(primary, key)
            for piece, (path, compressed) in mgr.local_pieces(key).items():
                want = os.path.join(want_dir, mgr._file_name(key, piece, compressed))
                if path != want:
                    await asyncio.to_thread(os.makedirs, want_dir, exist_ok=True)
                    await asyncio.to_thread(os.replace, path, want)
                    self.moved += 1
            if n >= 100:
                return WorkerState.BUSY
        self.cursor = None
        return WorkerState.BUSY
