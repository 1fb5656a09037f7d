"""Lifecycle worker (reference src/model/s3/lifecycle_worker.rs).

Once per day (and on restart, resumable via a persisted cursor) walk the
LOCAL object table and apply each bucket's lifecycle rules:

  Expiration (Days | Date)             -> insert a delete marker
  AbortIncompleteMultipartUpload(Days) -> abort old in-flight uploads

Only the partitions this node stores are scanned; every storage node runs
the same pass, and the resulting delete markers converge by CRDT.
"""

from __future__ import annotations

import asyncio
import logging
from datetime import datetime, timezone
from typing import Any

from ...utils.background import Worker, WorkerState
from ...utils.data import gen_uuid
from ...utils.migrate import Migratable
from ...utils.persister import Persister
from ...utils.time_util import now_msec
from .object_table import Object, ObjectVersion

logger = logging.getLogger("garage.lifecycle")

BATCH = 64


class LifecycleState(Migratable):
    VERSION_MARKER = b"GT0lifecycle"

    def __init__(self, last_completed: str = "", cursor: bytes = b""):
        self.last_completed = last_completed  # YYYY-MM-DD of last full pass
        self.cursor = cursor

    def to_obj(self) -> Any:
        return [self.last_completed, self.cursor]

    @classmethod
    def from_obj(cls, obj: Any) -> "LifecycleState":
        return cls(obj[0], bytes(obj[1]))


def _today(use_local_tz: bool = False) -> str:
    """Current date for day-boundary decisions; `use_local_tz` shifts the
    boundary to local midnight (reference config.rs use_local_tz ->
    lifecycle_worker.rs:73,208-222 today()/midnight_ts)."""
    now = datetime.now().astimezone() if use_local_tz else datetime.now(timezone.utc)
    return now.strftime("%Y-%m-%d")


class LifecycleWorker(Worker):
    def __init__(self, garage, metadata_dir: str | None = None):
        self.garage = garage
        self.persister = (
            Persister(metadata_dir, "lifecycle_state", LifecycleState)
            if metadata_dir
            else None
        )
        self.state = (self.persister.load() if self.persister else None) or LifecycleState()
        self._bucket_cache: dict[bytes, list | None] = {}

    def name(self) -> str:
        return "lifecycle"

    def status(self):
        return {"last_completed": self.state.last_completed}

    async def work(self):
        use_local = self.garage.config.use_local_tz
        if self.state.last_completed == _today(use_local):
            return WorkerState.IDLE
        data = self.garage.object_table.data
        n = 0
        for key, value in data.store.iter_range(start=self.state.cursor):
            obj = data.decode(value)
            try:
                await self._apply(obj)
            except Exception as e:  # noqa: BLE001
                logger.warning("lifecycle apply failed for %s: %r", obj.key, e)
            self.state.cursor = key + b"\x00"
            n += 1
            if n >= BATCH:
                await self._save_async()
                return WorkerState.BUSY
        # pass complete
        self.state.last_completed = _today(use_local)
        self.state.cursor = b""
        self._bucket_cache.clear()
        await self._save_async()
        return WorkerState.IDLE

    async def wait_for_work(self) -> None:
        await asyncio.sleep(60.0)

    async def _rules_of(self, bucket_id: bytes):
        if bucket_id not in self._bucket_cache:
            try:
                b = await self.garage.helper.get_bucket(bucket_id)
                self._bucket_cache[bucket_id] = b.params().lifecycle.get()
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "lifecycle: cannot read bucket %s config, skipping: %r",
                    bucket_id.hex()[:16], e,
                )
                self._bucket_cache[bucket_id] = None
        return self._bucket_cache[bucket_id]

    async def _apply(self, obj: Object) -> None:
        rules = await self._rules_of(obj.bucket_id)
        if not rules:
            return
        now = now_msec()
        for rule in rules:
            if not rule.get("enabled", True):
                continue
            if rule.get("prefix") and not obj.key.startswith(rule["prefix"]):
                continue
            vis = obj.last_visible()
            if vis is not None:
                expired = False
                if rule.get("expiration_days") is not None:
                    age_days = (now - vis.timestamp) / 86_400_000
                    expired = age_days >= rule["expiration_days"]
                if rule.get("expiration_date"):
                    try:
                        # the rule date is a day boundary: local midnight
                        # when use_local_tz, else UTC midnight (reference
                        # lifecycle_worker.rs:389 midnight_ts)
                        tz = (
                            datetime.now().astimezone().tzinfo
                            if self.garage.config.use_local_tz
                            else timezone.utc
                        )
                        d = datetime.strptime(
                            rule["expiration_date"][:10], "%Y-%m-%d"
                        ).replace(tzinfo=tz)
                        expired = expired or now >= d.timestamp() * 1000
                    except ValueError:
                        pass
                if expired:
                    # strictly past every existing version, like the API
                    # delete path — a skew-dated version must not outrank
                    # its own expiration
                    from .object_table import next_timestamp

                    dm = ObjectVersion(
                        gen_uuid(), next_timestamp(obj), "complete",
                        {"t": "delete_marker"},
                    )
                    await self.garage.object_table.insert(
                        Object(obj.bucket_id, obj.key, [dm])
                    )
                    logger.info("lifecycle: expired %s", obj.key)
                    return
            if rule.get("abort_mpu_days") is not None:
                for v in obj.versions:
                    if v.state == "uploading":
                        age_days = (now - v.timestamp) / 86_400_000
                        if age_days >= rule["abort_mpu_days"]:
                            from .mpu_table import MultipartUpload

                            closed = MultipartUpload(
                                v.uuid, obj.bucket_id, obj.key, timestamp=v.timestamp
                            )
                            closed.deleted.set()
                            await self.garage.mpu_table.insert(closed)
                            aborted = ObjectVersion(
                                v.uuid, v.timestamp, "aborted", dict(v.data)
                            )
                            await self.garage.object_table.insert(
                                Object(obj.bucket_id, obj.key, [aborted])
                            )
                            logger.info("lifecycle: aborted stale mpu on %s", obj.key)

    async def _save_async(self):
        # work()-path checkpoints fsync off the event loop (loop-blocker)
        if self.persister:
            await self.persister.save_in_thread(self.state)
