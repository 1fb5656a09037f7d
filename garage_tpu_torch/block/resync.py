"""Block resynchronization: the self-healing loop.

Reference src/block/resync.rs.  A persistent, time-ordered queue of block
hashes to (re)examine.  For each due item:

  - node needs the block (rc > 0) but doesn't have it  -> fetch from peers
  - node has it but rc == 0 past the GC delay          -> make sure no
    storage node still needs it (Need RPC), push to any that do, then
    delete the local file
  - errors retry with exponential backoff 1 min -> 64 min (errors tree)

Workers (1..MAX_RESYNC_WORKERS) drain the queue with a Tranquilizer.
Resync traffic runs at PRIO_BACKGROUND: the frame scheduler guarantees it
never starves interactive transfers.
"""

from __future__ import annotations

import asyncio
import logging
import os

from ..net.message import PRIO_BACKGROUND
from ..rpc.layout.types import partition_of
from ..utils.backoff import expo
from ..utils.background import BackgroundRunner, Worker, WorkerState
from ..utils.serde import pack, unpack
from ..utils.time_util import now_msec
from ..utils.tranquilizer import Tranquilizer

logger = logging.getLogger("garage.block.resync")

BACKOFF_MIN_MS = 60 * 1000
BACKOFF_MAX_MS = 64 * 60 * 1000
# A block whose refcount goes 0 -> 1 is checked this many RPC timeouts
# later (the timeout a block PUT waits on for its sends): the PUT that
# made the reference is still sending the block's pieces until then, and
# a check before they land fails and backs off BACKOFF_MIN_MS.  The Rust
# Garage's `block_incref` waits twice its RPC timeout the same way.
INCREF_CHECK_TIMEOUTS = 2
MAX_RESYNC_WORKERS = 8


def unpack_error(raw: bytes) -> tuple[int, int, int | None]:
    """(failure count, next retry msec, first-failure msec).  Error
    entries written before error-age tracking are 2-element lists —
    their first-failure time is unknown (None), never fabricated."""
    obj = unpack(raw)
    first = int(obj[2]) if len(obj) > 2 else None
    return int(obj[0]), int(obj[1]), first


class BlockResyncManager:
    def __init__(self, manager):
        self.manager = manager
        db = manager.db
        self.queue = db.open_tree("block_resync_queue")  # [when|hash] -> b""
        self.errors = db.open_tree("block_resync_errors")  # hash -> [count, when]
        self.n_workers = 1
        self.tranquility = 2
        self._kick = asyncio.Event()
        # oldest-error-age cache: status() runs after every worker
        # iteration and the durability digest reads it per collection —
        # neither should pay an O(errors) tree walk each time
        self._age_cache: tuple[float, float | None] | None = None

    # --- queueing -------------------------------------------------------------

    def queue_block(self, hash32: bytes, delay_ms: int = 0, tx=None) -> None:
        """Pass `tx` when queueing from inside a table updated() hook."""
        when = now_msec() + delay_ms
        key = when.to_bytes(8, "big") + hash32
        if tx is not None:
            tx.insert(self.queue, key, b"")
        else:
            self.queue.insert(key, b"")
        self._kick.set()

    def incref_delay_ms(self) -> int:
        """How long after a 0 -> 1 refcount its check is due."""
        return int(INCREF_CHECK_TIMEOUTS * self.manager.helper.default_timeout * 1000)

    def queue_blocks(self, hashes: list[bytes], delay_ms: int = 0) -> None:
        """Bulk enqueue (repair-plane `Queue` nudges, gather failures):
        one kick instead of one per hash."""
        when = (now_msec() + delay_ms).to_bytes(8, "big")
        for h in hashes:
            self.queue.insert(when + h, b"")
        if hashes:
            self._kick.set()

    def queue_len(self) -> int:
        return len(self.queue)

    def due_empty(self) -> bool:
        """True if no queue entry is due yet.  The queue is time-ordered
        (`when|hash` keys), so this is O(1).  Future-dated entries
        (GC-delay deletes, error backoffs) must not gate layout-sync
        completion — under steady delete traffic the queue is never
        LITERALLY empty and a migration would never close."""
        f = self.queue.first()
        return f is None or f[0][:8] > now_msec().to_bytes(8, "big")

    def errors_len(self) -> int:
        return len(self.errors)

    def oldest_error_age_secs(self) -> float | None:
        """Age of the OLDEST entry in the error set (None when empty, or
        when every entry predates error-age tracking).  Cached ~1 s —
        callers poll this per worker iteration / digest collection."""
        import time

        now = time.monotonic()
        if self._age_cache is not None and now - self._age_cache[0] < 1.0:
            return self._age_cache[1]
        oldest: int | None = None
        for _h, raw in self.errors.iter_range():
            _count, _next_try, first = unpack_error(raw)
            if first is not None and (oldest is None or first < oldest):
                oldest = first
        age = (
            max(0.0, (now_msec() - oldest) / 1000.0)
            if oldest is not None
            else None
        )
        self._age_cache = (now, age)
        return age

    def error_age_counts(self, stuck_after_secs: float) -> tuple[int, int]:
        """(transiently-failing, stuck) block counts: an errored block
        older than `stuck_after_secs` is stuck — retries have been
        failing long past the first backoff rungs.  Unknown-age entries
        (pre-upgrade format) count transient."""
        cutoff = now_msec() - int(stuck_after_secs * 1000)
        transient = stuck = 0
        for _h, raw in self.errors.iter_range():
            _count, _next_try, first = unpack_error(raw)
            if first is not None and first <= cutoff:
                stuck += 1
            else:
                transient += 1
        return transient, stuck

    # --- one unit of work -----------------------------------------------------

    async def resync_iter(self) -> bool:
        """Process one due queue item; returns True if work was done."""
        now = now_msec()
        for key, _ in self.queue.iter_range():
            when = int.from_bytes(key[:8], "big")
            if when > now:
                return False
            hash32 = key[8:]
            # error backoff: skip if a retry is scheduled later
            err = self.errors.get(hash32)
            if err is not None:
                count, next_try, _first = unpack_error(err)
                if next_try > now:
                    self.queue.remove(key)
                    self.queue.insert(next_try.to_bytes(8, "big") + hash32, b"")
                    return True
            try:
                await self._resync_block(hash32)
                self.errors.remove(hash32)
                self.queue.remove(key)
            except Exception as e:  # noqa: BLE001
                count = 0
                first = now_msec()  # error AGE: first-failure timestamp
                # survives retries so the ledger can tell a fresh blip
                # from a block that has been failing for an hour
                if err is not None:
                    count, _next, prev_first = unpack_error(err)
                    if prev_first is not None:
                        first = prev_first
                backoff = int(expo(count, BACKOFF_MIN_MS, BACKOFF_MAX_MS))
                self.errors.insert(
                    hash32,
                    pack([count + 1, now_msec() + backoff, first]),
                )
                self.queue.remove(key)
                self.queue.insert(
                    (now_msec() + backoff).to_bytes(8, "big") + hash32, b""
                )
                logger.info(
                    "resync of %s failed (try %d): %r",
                    hash32.hex()[:16],
                    count + 1,
                    e,
                )
            return True
        return False

    async def _resync_block(self, hash32: bytes) -> None:
        mgr = self.manager
        needed = mgr.rc.is_needed(hash32)
        have = mgr.has_block(hash32)
        i_store = mgr.system.id in mgr.storage_nodes_of(hash32)

        if mgr.codec.n_pieces > 1:
            # EC mode: this node's unit of storage is its piece(s).  A
            # node is a holder if it ranks < n_pieces in ANY active
            # layout version (possibly with different ranks -> several
            # pieces) — an old-version holder must NOT drop pieces while
            # a migration is open (the multi-set write guarantee says
            # either version's set alone can decode); it hands off only
            # after trim retires the old version.
            nodes = mgr.system.layout_manager.history.current().nodes_of(hash32)
            my_ranks = mgr.ec_ranks_of(hash32)
            is_holder = bool(my_ranks)
            local = mgr.local_pieces(hash32)
            if needed and is_holder and any(r not in local for r in my_ranks):
                await mgr.reconstruct_local_piece(hash32)
                logger.debug("resync: reconstructed piece for %s", hash32.hex()[:16])
                return
            if local and not needed and mgr.rc.is_deletable(hash32):
                # block deleted: reclaim every local piece
                for _pi, (path, _c) in local.items():
                    try:
                        await asyncio.to_thread(os.remove, path)
                    except OSError:
                        pass
                mgr.rc.clear_deleted(hash32)
                logger.debug("resync: deleted pieces of %s", hash32.hex()[:16])
                return
            if local and needed and not is_holder:
                # no longer a holder (layout change): delete only once the
                # current holders can serve >= k distinct pieces without us
                distinct: set[int] = set()
                for n in nodes[: mgr.codec.n_pieces]:
                    try:
                        resp = await mgr.helper.call(
                            mgr.endpoint, n, ["Pieces", hash32],
                            prio=PRIO_BACKGROUND, idempotent=True,
                        )
                        distinct.update(int(p) for p in resp.body or [])
                    except Exception as e:
                        raise RuntimeError(f"cannot check holders: {e!r}") from e
                if len(distinct) >= mgr.codec.min_pieces:
                    for _pi, (path, _c) in local.items():
                        try:
                            await asyncio.to_thread(os.remove, path)
                        except OSError:
                            pass
                else:
                    raise RuntimeError(
                        f"holders have only {len(distinct)} distinct pieces; "
                        "keeping ours until they heal"
                    )
            return

        if needed and i_store and not have:
            data = await mgr.rpc_get_block(hash32, prio=PRIO_BACKGROUND)
            stored, compressed = mgr._maybe_compress(data)
            await mgr.write_block_local(hash32, stored, compressed)
            logger.debug("resync: fetched %s", hash32.hex()[:16])
            return

        if have and (not needed or not i_store):
            if not mgr.rc.is_deletable(hash32) and not i_store:
                # rc still counting somewhere else; we just don't store it
                pass
            elif not mgr.rc.is_deletable(hash32):
                return  # deletion delay not yet passed
            # before deleting, push to any storage node that needs it
            for n in mgr.storage_nodes_of(hash32):
                if n == mgr.system.id:
                    continue
                try:
                    resp = await mgr.helper.call(
                        mgr.endpoint, n, ["Need", hash32],
                        prio=PRIO_BACKGROUND, idempotent=True,
                    )
                    if resp.body:
                        found = mgr.find_block_file(hash32)
                        if found:
                            from ..net.stream import bytes_stream

                            from .manager import _read_file_sync

                            path, compressed = found
                            stored = await asyncio.to_thread(
                                _read_file_sync, path
                            )
                            async with mgr.buffers.reserve(len(stored)):
                                # content-addressed Put: safe to retry
                                await mgr.helper.call(
                                    mgr.endpoint, n,
                                    ["Put", hash32,
                                     {"c": compressed, "s": len(stored)}],
                                    prio=PRIO_BACKGROUND,
                                    timeout=120.0,
                                    stream_factory=lambda: bytes_stream(stored),
                                    idempotent=True,
                                )
                            # rebalance observatory (rpc/transition.py):
                            # attribute the outbound handoff to the
                            # (self -> n) pair — no-op outside a transition
                            tt = getattr(
                                mgr.system, "transition_tracker", None
                            )
                            if tt is not None:
                                tt.note_transfer(
                                    mgr.system.id, n, len(stored),
                                    partition=partition_of(hash32),
                                )
                except Exception as e:
                    raise RuntimeError(
                        f"cannot verify/hand off to {n.hex()[:8]}: {e!r}"
                    ) from e
            found = mgr.find_block_file(hash32)
            if found:
                try:
                    await asyncio.to_thread(os.remove, found[0])
                    logger.debug("resync: deleted %s", hash32.hex()[:16])
                except OSError:
                    pass
            mgr.rc.clear_deleted(hash32)

    # --- workers --------------------------------------------------------------

    def spawn_workers(self, bg: BackgroundRunner) -> None:
        for i in range(MAX_RESYNC_WORKERS):
            bg.spawn(_ResyncWorker(self, i))
        bg.spawn(_LayoutSyncWorker(self))


class _LayoutSyncWorker(Worker):
    """The block plane's role in a layout transition.

    On every new layout version, re-queue every locally-referenced block
    so the resync logic migrates / hands off / reconstructs pieces for
    the new assignment; once the scan is done AND the resync queue has
    drained with no errored blocks, report the "block" sync component to
    the layout manager.  Version retirement (LayoutHistory.trim) is
    gated on this report exactly like on the table syncers' — without
    it, old versions could be retired while blocks still live only on
    the outgoing node set, stranding acked data (see
    doc/ec-placement.md "When does a transition complete?")."""

    SCAN_BATCH = 200

    def __init__(self, resync: BlockResyncManager):
        self.resync = resync
        self.lm = resync.manager.system.layout_manager
        self.lm.register_sync_component("block")
        self._changed = asyncio.Event()
        self._changed.set()  # initial pass reports the boot version
        self._last_seen = self.lm.history.current().version
        self.lm.subscribe(self._on_layout_change)
        self._version: int | None = None  # version currently being driven
        self._cursor: bytes | None = None  # rc-table scan position
        self._queued = 0

    def _on_layout_change(self) -> None:
        # trigger only on NEW versions — tracker gossip also notifies,
        # and re-scanning on every tracker advance would loop forever
        v = self.lm.history.current().version
        if v != self._last_seen:
            self._last_seen = v
            self._changed.set()

    def name(self) -> str:
        return "block layout sync"

    def status(self):
        return {
            "version": self._version,
            "queued": self._queued,
            "scanning": self._cursor is not None,
        }

    async def work(self):
        mgr = self.resync.manager
        if self._changed.is_set():
            self._changed.clear()
            h = self.lm.history
            self._version = h.current().version
            self._queued = 0
            active = [v for v in h.versions if v.ring_assignment]
            if (
                len(active) <= 1
                and h.sync.get(mgr.system.id) >= self._version
            ):
                # plain restart of an already-synced node: report without
                # sweeping the whole rc table
                self._cursor = None
            else:
                self._cursor = b""
        if self._version is None:
            return WorkerState.IDLE
        if self._cursor is not None:
            n = 0
            for key, _v in mgr.rc.tree.iter_range(start=self._cursor):
                self.resync.queue_block(key)
                self._cursor = key + b"\x00"
                self._queued += 1
                n += 1
                if n >= self.SCAN_BATCH:
                    await asyncio.sleep(0)  # yield: the scan is sync code
                    return WorkerState.BUSY
            self._cursor = None
            return WorkerState.BUSY
        if self.resync.due_empty() and self.resync.errors_len() == 0:
            self.lm.component_synced("block", self._version)
            self._version = None
        return WorkerState.IDLE

    async def wait_for_work(self) -> None:
        try:
            await asyncio.wait_for(self._changed.wait(), timeout=2.0)
        except asyncio.TimeoutError:
            pass


class _ResyncWorker(Worker):
    def __init__(self, resync: BlockResyncManager, index: int):
        self.resync = resync
        self.index = index
        self.tranquilizer = Tranquilizer()

    def name(self) -> str:
        return f"resync:{self.index}"

    def status(self):
        age = self.resync.oldest_error_age_secs()
        return {
            "queue": self.resync.queue_len(),
            "errors": self.resync.errors_len(),
            "oldest_error_secs": round(age, 1) if age is not None else None,
        }

    def tranquility(self) -> int | None:
        return self.resync.tranquility

    def queue_length(self) -> int | None:
        # the resync queue is shared by all resync workers: only index 0
        # exports it, or aggregations over the family would overcount
        # the backlog n_workers times
        return self.resync.queue_len() if self.index == 0 else None

    async def work(self):
        if self.index >= self.resync.n_workers:
            return (WorkerState.THROTTLED, 10.0)  # worker disabled by config
        self.tranquilizer.reset()
        did = await self.resync.resync_iter()
        if not did:
            return WorkerState.IDLE
        delay = self.tranquilizer.tranquilize_delay(self.resync.tranquility)
        return (WorkerState.THROTTLED, delay) if delay else WorkerState.BUSY

    async def wait_for_work(self) -> None:
        self.resync._kick.clear()
        try:
            await asyncio.wait_for(self.resync._kick.wait(), timeout=10.0)
        except asyncio.TimeoutError:
            pass
