"""Repair plane: cluster-wide batched-reconstruction planner.

The reactive repair paths fix blocks ONE AT A TIME: resync pops queue
entries, scrub re-queues what it finds corrupt.  `bulk_reconstruct`
(block/manager.py) can rebuild thousands of pieces in a handful of
device dispatches, but the reactive paths never PLAN at that scale, so
the codec's mesh fan-out threshold (2x devices, ops/ec_cuda.py) would
be cleared only by accident.  This module is the batched-inference
scheduler of the storage plane: aggregate many small independent repairs
into hardware-sized dispatches under admission control.

A `RepairPlanner` worker runs in three phases:

  scan     — walk the local rc tree (every block this cluster still
             references) in batches; for each batch, survey piece
             inventories: local files plus one bulk `Inv` RPC per peer
             (breaker-aware: open-breaker peers are skipped and their
             pieces conservatively counted missing).  Each stripe with
             missing shards becomes a ledger entry classified by
             URGENCY = how many shards are gone (closest to data loss
             first).  Stripes whose missing ranks live on OTHER nodes
             are nudged there (bulk `Queue` RPC -> their resync queue);
             stripes with fewer than k shards anywhere are recorded as
             `lost` (operator surface, nothing to dispatch).
  repair   — repeatedly coalesce compatible ledger entries (same k/m by
             construction; sorted so equal-urgency stripes of the same
             shard length are adjacent -> rectangular dispatches) into
             batches sized to clear the mesh threshold, capped by the
             bytes-in-flight budget, and drive them through
             `bulk_reconstruct`.  Stripes whose surviving shards sit
             behind open circuit breakers are deferred — the batch
             keeps filling with later stripes instead of stalling.
             Gather failures fall to resync's retry/backoff ladder
             (bulk_reconstruct queues them); the planner moves on.
  done     — final checkpoint, gauges unregistered.

Progress is CHECKPOINTED (`repair_plan` persister file) after every scan
step and repair round: a restarted daemon resumes the plan — ledger,
cursor and stats intact — instead of rescanning the cluster
(`Garage.spawn_workers` auto-resumes an in-progress plan).

Admission control is runtime-tunable via BgVars (`worker set`):
`repair-tranquility` (Tranquilizer pacing, same contract as resync) and
`repair-bytes-in-flight` (bytes of surviving shards gathered per round).

Metric families (catalogued in doc/monitoring.md, rendered by the admin
/metrics endpoint):

  repair_plan_backlog{urgency,id}      G  ledger depth by urgency class
  repair_plan_blocks_total             C  pieces rebuilt by the plane
  repair_plan_rounds_total             C  bulk_reconstruct rounds driven
  repair_plan_batch_size               H  blocks per round (pow2, _sum)
  repair_plan_dispatch_duration        H  seconds per round
  repair_plan_remote_nudges_total      C  hashes queued on remote nodes
  repair_plan_deferred_total           C  breaker-deferred stripe picks
  tpu_mesh_engaged_total{kernel,platform,devices}
                                       C  dispatches actually served by
                                          the multi-device mesh path
                                          (ops/telemetry.py)
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os

from ..utils.background import Worker, WorkerState
from ..utils.metrics import SIZE_BUCKETS, registry
from ..utils.migrate import Migratable
from ..utils.persister import Persister
from ..utils.time_util import now_msec
from ..utils.tranquilizer import Tranquilizer

logger = logging.getLogger("garage.block.repair_plan")

# value-histogram family: blocks per bulk_reconstruct round
registry.set_buckets("repair_plan_batch_size", SIZE_BUCKETS)

SCAN_BATCH = 512  # rc-tree keys surveyed per work() iteration
SCAN_CHECKPOINT_EVERY = 8  # scan steps between checkpoints: the save
# rewrites the WHOLE growing ledger, so per-step saves would be
# O(ledger^2) on a heavily degraded cluster; a crash merely re-surveys
# the unpersisted steps (cursor and ledger snapshot together, so resume
# cannot duplicate entries)
INV_RPC_HASHES = 256  # hashes per bulk Inv/Queue RPC
DEFAULT_BATCH_TARGET = 256  # floor for the mesh-sized coalescing target
DEFAULT_PIECE_EST = 256 * 1024  # bytes budget estimate when plen unknown
DEFER_ROUNDS_MAX = 60  # all-deferred rounds before handing off to resync
DEFER_RETRY_SECS = 2.0  # pause between all-deferred rounds

# urgency classes, most severe first (repair order within the ledger)
URGENCY_LOST = "lost"  # < k shards reachable: nothing to dispatch
URGENCY_CRITICAL = "critical"  # one more loss means data loss
URGENCY_HIGH = "high"  # over half the parity budget consumed
URGENCY_LOW = "low"
URGENCIES = (URGENCY_CRITICAL, URGENCY_HIGH, URGENCY_LOW, URGENCY_LOST)

# gauge `id` label: process-unique (several in-process nodes share the
# global registry — see utils/background.py _gauge_ids for the pattern)
_gauge_ids = itertools.count(1)


def classify(n_missing: int, m: int) -> str:
    """Urgency of a stripe with `n_missing` shards gone, parity width m."""
    if n_missing > m:
        return URGENCY_LOST
    if n_missing == m:
        return URGENCY_CRITICAL
    if n_missing >= (m + 1) // 2:
        return URGENCY_HIGH
    return URGENCY_LOW


class PlanParams:
    """Mutable admission-control knobs, shared between the composition
    root (config + BgVars setters) and the running planner — `worker set
    repair-tranquility 4` takes effect on the NEXT round, no restart."""

    def __init__(
        self,
        tranquility: int = 2,
        bytes_in_flight: int = 128 * 1024 * 1024,
        batch_blocks: int | None = None,
    ):
        self.tranquility = tranquility
        self.bytes_in_flight = bytes_in_flight
        self.batch_blocks = batch_blocks  # None: mesh-derived target


class PlanPersisted(Migratable):
    """Checkpointed plan state.  Ledger entries are
    [hash32, local_missing_ranks, n_missing_total, piece_len]."""

    VERSION_MARKER = b"GT0rplan"

    def __init__(
        self,
        state: str = "scanning",
        cursor: bytes | None = b"",
        ledger: list | None = None,
        lost: list | None = None,
        scanned: int = 0,
        repaired: int = 0,
        rounds: int = 0,
        nudged: int = 0,
        deferred: int = 0,
        started_ms: int = 0,
    ):
        self.state = state
        self.cursor = cursor  # rc-tree scan position; None = scan done
        self.ledger = ledger if ledger is not None else []
        self.lost = lost if lost is not None else []
        self.scanned = scanned
        self.repaired = repaired
        self.rounds = rounds
        self.nudged = nudged
        self.deferred = deferred
        self.started_ms = started_ms

    def to_obj(self):
        return [
            self.state,
            self.cursor,
            [[bytes(h), list(lr), nm, pl] for h, lr, nm, pl in self.ledger],
            [bytes(h) for h in self.lost],
            self.scanned,
            self.repaired,
            self.rounds,
            self.nudged,
            self.deferred,
            self.started_ms,
        ]

    @classmethod
    def from_obj(cls, obj):
        return cls(
            state=str(obj[0]),
            cursor=bytes(obj[1]) if obj[1] is not None else None,
            ledger=[
                (bytes(h), [int(r) for r in lr], int(nm), int(pl))
                for h, lr, nm, pl in obj[2]
            ],
            lost=[bytes(h) for h in obj[3]],
            scanned=int(obj[4]),
            repaired=int(obj[5]),
            rounds=int(obj[6]),
            nudged=int(obj[7]),
            deferred=int(obj[8]),
            started_ms=int(obj[9]),
        )


def _mesh_width(manager) -> int:
    """Devices the codec fans a batch over (`EcCuda._mesh_width`,
    ops/ec_cuda.py); 1 for a codec with no device plane, such as
    ReplicaCodec — the 2x threshold the coalescer must clear."""
    ec = getattr(manager.codec, "_ec", None)
    return 1 if ec is None else max(1, ec._mesh_width())


async def drive_bulk(manager, hashes: list[bytes]) -> int:
    """One repair-plane round: `bulk_reconstruct` wrapped in the
    repair_plan metric families.  Shared by the planner and the one-shot
    `repair blocks` worker (block/repair.py) so dispatch accounting
    cannot drift between the two callers."""
    registry.observe("repair_plan_batch_size", (), float(len(hashes)))
    with registry.timer("repair_plan_dispatch_duration", ()):
        n = await manager.bulk_reconstruct(hashes)
    registry.incr("repair_plan_blocks_total", (), n)
    registry.incr("repair_plan_rounds_total")
    return n


class RepairPlanner(Worker):
    """Cluster-degradation planner (see module docstring).

    One planner per node; launched from the admin API/CLI (`repair plan
    launch`) or auto-resumed from a checkpoint at daemon start.  Drives
    only THIS node's missing pieces through the device path — remote-only
    degradation is delegated to the owning nodes via `Queue` nudges, so
    cluster-wide repair remains every node draining its own rank at mesh
    batch sizes."""

    def __init__(
        self,
        manager,
        metadata_dir: str | None = None,
        params: PlanParams | None = None,
        fresh: bool = False,
    ):
        if manager.codec.n_pieces <= 1:
            raise ValueError(
                "repair planner requires an erasure-coded block codec "
                "(replication_mode = ec:k:m)"
            )
        self.manager = manager
        self.params = params or PlanParams()
        self.tranquilizer = Tranquilizer()
        self.persister = (
            Persister(metadata_dir, "repair_plan", PlanPersisted)
            if metadata_dir
            else None
        )
        self.plan = None if fresh else self._load_resumable()
        self.resumed = self.plan is not None
        if self.plan is None:
            self.plan = PlanPersisted(started_ms=now_msec())
        self.finished = False
        self._cancel = False
        self._defer_rounds = 0
        self._scan_steps = 0
        self._gauge_keys: list[tuple] = []
        self._register_gauges()
        if self.resumed:
            logger.info(
                "repair plan resumed from checkpoint: state=%s backlog=%d "
                "repaired=%d", self.plan.state, len(self.plan.ledger),
                self.plan.repaired,
            )

    def _load_resumable(self) -> PlanPersisted | None:
        if self.persister is None:
            return None
        try:
            plan = self.persister.load()
        except Exception as e:  # noqa: BLE001 — a corrupt/foreign-version
            # checkpoint must cost a rescan, never a crashed planner
            logger.warning(
                "repair plan checkpoint unreadable (%r); starting fresh", e
            )
            return None
        if plan is not None and plan.state in ("scanning", "repairing"):
            return plan
        return None

    @classmethod
    def resumable(cls, metadata_dir: str | None) -> bool:
        """Is there an in-progress checkpoint to resume on this node?
        Unreadable checkpoints (corruption, a newer build's format after
        a downgrade) answer False — auto-resume runs inside daemon boot
        and one bad auxiliary file must not brick startup."""
        if not metadata_dir:
            return False
        try:
            plan = Persister(
                metadata_dir, "repair_plan", PlanPersisted
            ).load()
        except Exception as e:  # noqa: BLE001
            logger.warning("unreadable repair_plan checkpoint ignored: %r", e)
            return False
        return plan is not None and plan.state in ("scanning", "repairing")

    # --- worker interface -----------------------------------------------------

    def name(self) -> str:
        return "repair_plan"

    def status(self):
        return {
            "state": self.plan.state,
            "backlog": len(self.plan.ledger),
            "scanned": self.plan.scanned,
            "repaired": self.plan.repaired,
            "rounds": self.plan.rounds,
            "nudged": self.plan.nudged,
            "deferred": self.plan.deferred,
            "lost": len(self.plan.lost),
            "scanning": self.plan.cursor is not None,
        }

    def tranquility(self) -> int | None:
        return self.params.tranquility

    def queue_length(self) -> int | None:
        return len(self.plan.ledger)

    def cmd_cancel(self) -> None:
        """Stop after the in-flight round; the checkpoint keeps state
        "cancelled" so a later launch starts a fresh plan."""
        self._cancel = True

    def backlog_by_urgency(self) -> dict[str, int]:
        m = self.manager.codec.n_pieces - self.manager.codec.min_pieces
        out = {u: 0 for u in URGENCIES}
        for _h, _lr, n_missing, _pl in self.plan.ledger:
            # ledger entries are repairable by construction; a partial
            # survey can overstate n_missing past m (unanswered peers
            # count missing conservatively), which must read as
            # "critical", never as the lost data-loss alarm
            out[classify(min(n_missing, m), m)] += 1
        out[URGENCY_LOST] += len(self.plan.lost)
        return out

    def status_full(self) -> dict:
        """Admin-API view: worker status + urgency breakdown + knobs."""
        st = self.status()
        st["backlogByUrgency"] = self.backlog_by_urgency()
        st["startedMs"] = self.plan.started_ms
        st["meshWidth"] = _mesh_width(self.manager)
        st["batchTarget"] = self._batch_target()
        return st

    async def work(self):
        if self._cancel and not self.finished:
            return await self._finish("cancelled")
        if self.finished:
            return WorkerState.DONE
        self.tranquilizer.reset()
        if self.plan.state == "scanning":
            more = await self._scan_step()
            self._scan_steps += 1
            if not more and self.plan.state == "scanning":
                self.plan.state = "repairing" if self.plan.ledger else "done"
            if not more or self._scan_steps % SCAN_CHECKPOINT_EVERY == 0:
                await self._save_async()
            if self.plan.state == "done":
                return await self._finish("done")
            return self._throttle()
        if self.plan.state == "repairing":
            if not self.plan.ledger:
                return await self._finish("done")
            picked = await self._repair_round()
            await self._save_async()
            if not self.plan.ledger:
                return await self._finish("done")
            if picked == 0:
                # everything pickable sits behind open breakers: wait for
                # half-open probes rather than spinning; after too long,
                # hand the tail to resync's error ladder and finish
                self._defer_rounds += 1
                if self._defer_rounds >= DEFER_ROUNDS_MAX:
                    for h, _lr, _nm, _pl in self.plan.ledger:
                        self.manager.resync.queue_block(h)
                    logger.warning(
                        "repair plan: %d stripes stuck behind open "
                        "breakers for %d rounds; handed to resync",
                        len(self.plan.ledger), self._defer_rounds,
                    )
                    self.plan.ledger = []
                    return await self._finish("done")
                return (WorkerState.THROTTLED, DEFER_RETRY_SECS)
            self._defer_rounds = 0
            return self._throttle()
        return await self._finish(self.plan.state or "done")

    def _throttle(self):
        delay = self.tranquilizer.tranquilize_delay(self.params.tranquility)
        return (WorkerState.THROTTLED, delay) if delay else WorkerState.BUSY

    # --- scan phase -----------------------------------------------------------

    async def _scan_step(self) -> bool:
        """Survey one SCAN_BATCH of the rc tree; returns False when the
        scan is complete."""
        mgr = self.manager
        hashes: list[bytes] = []
        cursor = self.plan.cursor or b""
        for key, val in mgr.rc.tree.iter_range(start=cursor):
            cursor = key + b"\x00"
            if val and not val.startswith(b"del") and int.from_bytes(
                val[:8], "big"
            ) > 0:
                hashes.append(key)
            if len(hashes) >= SCAN_BATCH:
                break
        else:
            self.plan.cursor = None
        if self.plan.cursor is not None:
            self.plan.cursor = cursor
        if hashes:
            await self._survey(hashes)
            self.plan.scanned += len(hashes)
        return self.plan.cursor is not None

    async def _survey(self, hashes: list[bytes]) -> None:
        """Inventory `hashes` across their assignment, append degraded
        stripes to the ledger, nudge remote-only holders."""
        from ..net.message import PRIO_BACKGROUND

        mgr = self.manager
        layout = mgr.system.layout_manager.history.current()
        npieces = mgr.codec.n_pieces
        k = mgr.codec.min_pieces
        self_id = mgr.system.id
        health = mgr.helper.health

        assign: dict[bytes, list[bytes]] = {}
        present: dict[bytes, set[int]] = {}
        plen: dict[bytes, int] = {}
        per_node: dict[bytes, list[bytes]] = {}
        for h in hashes:
            nodes = layout.nodes_of(h)[:npieces]
            if len(nodes) < npieces:
                continue  # layout narrower than the stripe: nothing to plan
            assign[h] = nodes
            local = mgr.local_pieces(h)
            present[h] = set(local.keys())
            for _pi, (path, compressed) in sorted(local.items()):
                if compressed:
                    continue  # legacy .zst replica file: size lies
                plen[h] = await asyncio.to_thread(_stored_piece_len, path)
                break
            # survey EVERY node that may hold pieces — the union of all
            # active layout versions (storage_nodes_of), not just the
            # current assignment: mid-migration, pieces still sit on
            # previous-version holders, and asking only current holders
            # would misreport fully recoverable stripes as lost
            for n in set(mgr.storage_nodes_of(h)) | set(nodes):
                if n != self_id:
                    per_node.setdefault(n, []).append(h)

        # hashes with at least one unanswered holder: their shards count
        # missing CONSERVATIVELY, so they must never be classified lost,
        # and their remote holders must not be nudged on guesswork
        unsurveyed: set[bytes] = set()
        for n, hs in per_node.items():
            from ..rpc.peer_health import OPEN

            if health.state_of(n) == OPEN:
                # skip the sick peer; its pieces count as missing
                # (conservative: worst case we rebuild a piece that still
                # exists there — content-addressed, so harmless)
                registry.incr("repair_plan_deferred_total", (), len(hs))
                self.plan.deferred += len(hs)
                unsurveyed.update(hs)
                continue
            for i in range(0, len(hs), INV_RPC_HASHES):
                chunk = hs[i : i + INV_RPC_HASHES]
                try:
                    resp = await mgr.helper.call(
                        mgr.endpoint, n, ["Inv", chunk],
                        prio=PRIO_BACKGROUND, idempotent=True,
                    )
                except Exception as e:  # noqa: BLE001 — peer counts missing
                    logger.debug("repair plan: Inv to %s failed: %r",
                                 n.hex()[:8], e)
                    unsurveyed.update(chunk)
                    continue
                for h, (idxs, pl) in zip(chunk, resp.body):
                    if h in present:
                        present[h].update(int(x) for x in idxs)
                        if pl and h not in plen:
                            plen[h] = int(pl)

        nudges: dict[bytes, set[bytes]] = {}
        for h, nodes in assign.items():
            missing = [r for r in range(npieces) if r not in present[h]]
            if not missing:
                continue
            my_ranks = set(mgr.ec_ranks_of(h))
            local_missing = [r for r in missing if r in my_ranks]
            if len(present[h]) < k and h not in unsurveyed:
                # every holder answered and fewer than k shards exist
                # anywhere: genuinely unrepairable (operator surface)
                self.plan.lost.append(h)
                continue
            if local_missing:
                self.plan.ledger.append(
                    (h, local_missing, len(missing), plen.get(h, 0))
                )
            if h in unsurveyed:
                continue  # don't nudge holders based on a partial survey
            for r in missing:
                if r not in my_ranks:
                    nudges.setdefault(nodes[r], set()).add(h)

        for n, hs in nudges.items():
            from ..net.message import PRIO_BACKGROUND
            from ..rpc.peer_health import OPEN

            if health.state_of(n) == OPEN:
                continue  # sick holder: its own resync finds the gap later
            hl = sorted(hs)
            for i in range(0, len(hl), INV_RPC_HASHES):
                chunk = hl[i : i + INV_RPC_HASHES]
                try:
                    await mgr.helper.call(
                        mgr.endpoint, n, ["Queue", chunk],
                        prio=PRIO_BACKGROUND, idempotent=True,
                    )
                    self.plan.nudged += len(chunk)
                    registry.incr(
                        "repair_plan_remote_nudges_total", (), len(chunk)
                    )
                except Exception as e:  # noqa: BLE001
                    logger.debug("repair plan: Queue to %s failed: %r",
                                 n.hex()[:8], e)

    # --- repair phase ---------------------------------------------------------

    def _batch_target(self) -> int:
        """Blocks to coalesce per round: explicit config, else large
        enough to clear the mesh fan-out threshold with headroom."""
        if self.params.batch_blocks:
            return max(1, int(self.params.batch_blocks))
        return max(2 * _mesh_width(self.manager), DEFAULT_BATCH_TARGET)

    def _pick_batch(self) -> list[int]:
        """Ledger indices for the next round: urgency-first (most missing
        shards first), same-shard-length stripes adjacent so grouped
        dispatches stay rectangular, capped by the bytes-in-flight
        budget, open-breaker stripes skipped (the batch widens past them
        instead of stalling)."""
        from ..rpc.peer_health import OPEN

        mgr = self.manager
        layout = mgr.system.layout_manager.history.current()
        health = mgr.helper.health
        npieces = mgr.codec.n_pieces
        k = mgr.codec.min_pieces
        self_id = mgr.system.id

        target = self._batch_target()
        budget = max(1, int(self.params.bytes_in_flight))
        order = sorted(
            range(len(self.plan.ledger)),
            key=lambda i: (-self.plan.ledger[i][2], self.plan.ledger[i][3]),
        )
        picked: list[int] = []
        used = 0
        for i in order:
            if len(picked) >= target:
                break
            h, local_missing, _nm, pl = self.plan.ledger[i]
            est = k * (pl or DEFAULT_PIECE_EST)
            if picked and used + est > budget:
                break  # ledger is urgency-ordered; later entries can wait
            nodes = layout.nodes_of(h)[:npieces]
            open_peers = sum(
                1
                for n in set(nodes)
                if n != self_id and health.state_of(n) == OPEN
            )
            if npieces - open_peers - len(local_missing) < k:
                # not enough reachable survivors right now: defer, keep
                # filling the batch with stripes that CAN repair
                registry.incr("repair_plan_deferred_total")
                self.plan.deferred += 1
                continue
            picked.append(i)
            used += est
        return picked

    async def _repair_round(self) -> int:
        """Drive one coalesced batch through bulk_reconstruct; returns
        how many stripes were picked (0 = everything deferred)."""
        picked = self._pick_batch()
        if not picked:
            return 0
        hashes = [self.plan.ledger[i][0] for i in picked]
        rebuilt = await drive_bulk(self.manager, hashes)
        self.plan.repaired += rebuilt
        self.plan.rounds += 1
        # picked entries leave the ledger whatever happened: repaired ones
        # are done, gather failures were queued to resync (which owns the
        # retry/backoff ladder) by bulk_reconstruct itself
        dead = set(picked)
        self.plan.ledger = [
            e for i, e in enumerate(self.plan.ledger) if i not in dead
        ]
        logger.info(
            "repair plan: round %d rebuilt %d pieces (%d stripes, "
            "%d left)", self.plan.rounds, rebuilt, len(picked),
            len(self.plan.ledger),
        )
        return len(picked)

    # --- persistence / lifecycle ----------------------------------------------

    async def _save_async(self) -> None:
        # work()-path checkpoints go off-loop: a plan ledger fsync on the
        # event loop stalls every concurrent request (loop-blocker)
        if self.persister is not None:
            await self.persister.save_in_thread(self.plan)

    async def _finish(self, state: str):
        self.plan.state = state
        await self._save_async()
        self._unregister_gauges()
        self.finished = True
        logger.info(
            "repair plan %s: scanned=%d repaired=%d rounds=%d lost=%d",
            state, self.plan.scanned, self.plan.repaired, self.plan.rounds,
            len(self.plan.lost),
        )
        return WorkerState.DONE

    def _register_gauges(self) -> None:
        gid = str(next(_gauge_ids))
        for u in URGENCIES:
            lbl = (("urgency", u), ("id", gid))
            registry.register_gauge(
                "repair_plan_backlog", lbl,
                lambda u=u: float(self.backlog_by_urgency()[u]),
            )
            self._gauge_keys.append(("repair_plan_backlog", lbl))

    def _unregister_gauges(self) -> None:
        for name, lbl in self._gauge_keys:
            registry.unregister_gauge(name, lbl)
        self._gauge_keys = []


def _stored_piece_len(path: str) -> int:
    """Payload length of a stored EC piece file (0 when unknown) — used
    only for batch byte-budget estimates and shard-length coalescing."""
    from .manager import PIECE_MAGIC, PIECE_MAGIC_V1

    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            magic = f.read(4)
    except OSError:
        return 0
    if magic == PIECE_MAGIC:
        return max(0, size - 44)
    if magic == PIECE_MAGIC_V1:
        return max(0, size - 12)
    return 0
