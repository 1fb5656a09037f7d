"""Multipart-upload table (reference src/model/s3/mpu_table.rs).

pk = upload id (a version uuid), sk = "".  Parts are a CRDT map keyed
[part_number, timestamp] -> {"vid": part version uuid, "etag", "size"};
re-uploading a part adds a newer (part_number, timestamp) entry and the
completion step picks the newest per part number (stale part versions are
tombstoned by the cascade).
"""

from __future__ import annotations

from typing import Any

from ...table.schema import TableSchema
from ...utils.crdt import Bool, CrdtMap


class MultipartUpload:
    def __init__(
        self,
        upload_id: bytes,
        bucket_id: bytes,
        key: str,
        timestamp: int = 0,
        parts: CrdtMap | None = None,
        deleted: Bool | None = None,
        enc: dict | None = None,
        hdrs: list | None = None,
    ):
        self.upload_id = upload_id
        self.bucket_id = bucket_id
        self.key = key
        self.timestamp = timestamp
        self.parts = parts or CrdtMap()
        self.deleted = deleted or Bool(False)
        self.enc = enc  # SSE-C {"alg","md5"} fixed at CreateMultipartUpload
        # object metadata headers fixed at CreateMultipartUpload; stored
        # here (not only on the uploading marker version) because a
        # concurrent complete PutObject prunes older marker versions
        self.hdrs = hdrs

    def merge(self, other: "MultipartUpload") -> None:
        self.deleted.merge(other.deleted)
        if self.deleted.get():
            self.parts = CrdtMap()
        else:
            self.parts.merge(other.parts)
        self.timestamp = max(self.timestamp, other.timestamp) if self.timestamp else other.timestamp
        if self.enc is None:
            self.enc = other.enc
        if self.hdrs is None:
            self.hdrs = other.hdrs

    def latest_parts(self) -> dict[int, dict]:
        """part_number -> newest {"vid","etag","size"}."""
        out: dict[int, tuple[int, dict]] = {}
        for k, v in self.parts.items():
            pn, ts = int(k[0]), int(k[1])
            if pn not in out or ts > out[pn][0]:
                out[pn] = (ts, v)
        return {pn: v for pn, (_ts, v) in out.items()}

    def all_part_vids(self) -> list[bytes]:
        return [bytes(v["vid"]) for _k, v in self.parts.items()]

    def to_obj(self) -> Any:
        return [
            self.upload_id,
            self.bucket_id,
            self.key,
            self.timestamp,
            self.parts.to_obj(),
            self.deleted.to_obj(),
            self.enc,
            self.hdrs,
        ]


class MpuTable(TableSchema):
    table_name = "multipart_upload"

    def __init__(self, version_table=None):
        self.version_table = version_table

    def entry_partition_key(self, e: MultipartUpload) -> bytes:
        return e.upload_id

    def entry_sort_key(self, e: MultipartUpload) -> bytes:
        return b""

    def decode_entry(self, obj: Any) -> MultipartUpload:
        parts = CrdtMap.from_obj(obj[4])
        for _k, v in parts.items():
            if "vid" in v:
                v["vid"] = bytes(v["vid"])
        return MultipartUpload(
            bytes(obj[0]), bytes(obj[1]), obj[2], int(obj[3]), parts,
            Bool.from_obj(obj[5]), obj[6] if len(obj) > 6 else None,
            obj[7] if len(obj) > 7 else None,
        )

    def merge_entries(self, a, b):
        a.merge(b)
        return a

    def is_tombstone(self, e: MultipartUpload) -> bool:
        return e.deleted.get()

    def updated(self, tx, old, new) -> None:
        """When the upload is deleted/aborted, tombstone every part
        version (cascades to block refs)."""
        if self.version_table is None:
            return
        from .version_table import Version

        was = old is not None and not old.deleted.get()
        now = new is not None and not new.deleted.get()
        if was and not now:
            for vid in old.all_part_vids():
                self.version_table.queue_insert(
                    Version.deleted_marker(vid, old.bucket_id, old.key), tx=tx
                )