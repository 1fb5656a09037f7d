"""Metadata repair workers (reference src/garage/repair/online.rs:29-95):
walk local table entries and fix dangling references.

  versions   — tombstone version entries whose object/upload no longer
               lists them (e.g. after an interrupted delete cascade)
  mpu        — tombstone multipart uploads whose object entry no longer
               has the matching uploading version
  block_refs — tombstone block refs whose version is deleted/missing

Each worker pages through the LOCAL copy of its table (repairs run on
every node; quorum writes propagate the fixes) and goes DONE at the end
of one pass.
"""

from __future__ import annotations

import logging

from ..utils.background import Worker, WorkerState

logger = logging.getLogger("garage.repair")

BATCH = 200


class _TableWalkWorker(Worker):
    """One pass over all local entries of a table, BATCH per work()."""

    def __init__(self, garage):
        self.garage = garage
        self.cursor = b""
        self.examined = 0
        self.fixed = 0

    def status(self):
        return {"examined": self.examined, "fixed": self.fixed}

    def _table(self):
        raise NotImplementedError

    async def _repair_one(self, entry) -> bool:
        raise NotImplementedError

    async def work(self):
        data = self._table().data
        batch = []
        for k, v in data.store.iter_range(start=self.cursor):
            batch.append((k, v))
            if len(batch) >= BATCH:
                break
        if not batch:
            return WorkerState.DONE
        for k, v in batch:
            self.examined += 1
            try:
                if await self._repair_one(data.decode(v)):
                    self.fixed += 1
            except Exception:  # noqa: BLE001 — keep walking
                logger.exception("repair step failed")
        self.cursor = batch[-1][0] + b"\x00"
        return WorkerState.BUSY

    async def wait_for_work(self):
        return


class VersionRepairWorker(_TableWalkWorker):
    """reference repair/online.rs RepairVersions."""

    def name(self) -> str:
        return "version repair"

    def _table(self):
        return self.garage.version_table

    async def _repair_one(self, ver) -> bool:
        if ver.deleted.get():
            return False
        g = self.garage
        obj = await g.object_table.get(ver.bucket_id, ver.key.encode())
        referenced = False
        upload_ids = []
        if obj is not None:
            for ov in obj.versions:
                if ov.state == "aborted":
                    continue
                if ov.uuid == ver.uuid or ov.data.get("vid") == ver.uuid:
                    referenced = True
                    break
                upload_ids.append(ov.uuid)
        if not referenced:
            # maybe an in-flight multipart part: referenced via mpu parts
            for uid in upload_ids:
                mpu = await g.mpu_table.get(bytes(uid), b"")
                if mpu is None or mpu.deleted.get():
                    continue
                if any(
                    bytes(p["vid"]) == ver.uuid
                    for p in mpu.latest_parts().values()
                ):
                    referenced = True
                    break
        if not referenced:
            from .s3.version_table import Version

            logger.info("version repair: deleting dangling %s", ver.uuid.hex()[:16])
            await g.version_table.insert(
                Version.deleted_marker(ver.uuid, ver.bucket_id, ver.key)
            )
            return True
        return False


class MpuRepairWorker(_TableWalkWorker):
    """reference repair/online.rs RepairMpu."""

    def name(self) -> str:
        return "mpu repair"

    def _table(self):
        return self.garage.mpu_table

    async def _repair_one(self, mpu) -> bool:
        if mpu.deleted.get():
            return False
        g = self.garage
        obj = await g.object_table.get(mpu.bucket_id, mpu.key.encode())
        alive = obj is not None and any(
            ov.uuid == mpu.upload_id and ov.state == "uploading"
            for ov in obj.versions
        )
        if not alive:
            from .s3.mpu_table import MultipartUpload

            logger.info("mpu repair: aborting dangling %s", mpu.upload_id.hex()[:16])
            dead = MultipartUpload(
                mpu.upload_id, mpu.bucket_id, mpu.key, timestamp=mpu.timestamp
            )
            dead.deleted.set()
            await g.mpu_table.insert(dead)
            return True
        return False


class BlockRefRepairWorker(_TableWalkWorker):
    """reference repair/online.rs RepairBlockRefs."""

    def name(self) -> str:
        return "block_ref repair"

    def _table(self):
        return self.garage.block_ref_table

    async def _repair_one(self, ref) -> bool:
        if ref.deleted.get():
            return False
        g = self.garage
        ver = await g.version_table.get(bytes(ref.version), b"")
        if ver is None or ver.deleted.get():
            from .s3.block_ref_table import BlockRef

            logger.info(
                "block_ref repair: dropping ref %s -> %s",
                ref.block.hex()[:16], bytes(ref.version).hex()[:16],
            )
            dead = BlockRef(ref.block, bytes(ref.version))
            dead.deleted.set()
            await g.block_ref_table.insert(dead)
            return True
        return False
