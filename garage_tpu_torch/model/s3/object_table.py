"""Object table: the S3 namespace (reference src/model/s3/object_table.rs).

One entry per (bucket_id, key).  An entry holds a list of ObjectVersions,
each identified by (uuid, timestamp):

  state: "uploading" | "complete" | "aborted"
  data:  {"t": "inline", "meta": {...}, "bytes": ...}
       | {"t": "first_block", "meta": {...}, "vid": version_uuid}
       | {"t": "delete_marker"}
  meta:  {"size": int, "etag": str, "headers": [[name, value]...]}

CRDT merge (object_table.rs:26-93): union of versions by (uuid, ts) with
per-version state merge (aborted wins over anything; complete wins over
uploading), then prune: drop everything strictly older than the newest
"complete-or-delete-marker" version except still-uploading versions (the
in-flight multipart uploads).  The `updated()` hook marks versions that
disappeared (or aborted) as deleted in the version table, cascading to
block refs -> rc decrements.
"""

from __future__ import annotations

from typing import Any

from ...table.schema import TableSchema

STATE_ORDER = {"uploading": 0, "complete": 1, "aborted": 2}  # aborted is terminal


class ObjectVersion:
    __slots__ = ("uuid", "timestamp", "state", "data")

    def __init__(self, uuid: bytes, timestamp: int, state: str, data: dict):
        self.uuid = uuid
        self.timestamp = timestamp
        self.state = state
        self.data = data

    def cmp_key(self) -> tuple[int, bytes]:
        return (self.timestamp, self.uuid)

    def is_complete_or_dm(self) -> bool:
        return self.state == "complete"

    def is_data_block(self) -> bool:
        return self.state == "complete" and self.data.get("t") == "first_block"

    def to_obj(self) -> Any:
        return [self.uuid, self.timestamp, self.state, self.data]

    @classmethod
    def from_obj(cls, obj: Any) -> "ObjectVersion":
        data = dict(obj[3])
        if "bytes" in data:
            data["bytes"] = bytes(data["bytes"])
        if "vid" in data:
            data["vid"] = bytes(data["vid"])
        return cls(bytes(obj[0]), int(obj[1]), obj[2], data)


class Object:
    def __init__(self, bucket_id: bytes, key: str, versions: list[ObjectVersion]):
        self.bucket_id = bucket_id
        self.key = key
        self.versions = sorted(versions, key=lambda v: v.cmp_key())

    def merge(self, other: "Object") -> None:
        byid: dict[bytes, ObjectVersion] = {v.uuid: v for v in self.versions}
        for v in other.versions:
            cur = byid.get(v.uuid)
            if cur is None:
                byid[v.uuid] = v
            elif STATE_ORDER[v.state] > STATE_ORDER[cur.state]:
                byid[v.uuid] = v
        versions = sorted(byid.values(), key=lambda v: v.cmp_key())
        # prune (object_table.rs:513-526): drop everything strictly older
        # than the newest complete version; keep the rest — INCLUDING
        # aborted versions, which persist as terminal CRDT tombstones so a
        # replica that missed the abort converges instead of resurrecting
        # the upload via anti-entropy (the cascade handles data cleanup).
        last_complete_idx = None
        for i, v in enumerate(versions):
            if v.is_complete_or_dm():
                last_complete_idx = i
        if last_complete_idx is not None:
            versions = versions[last_complete_idx:]
        self.versions = versions

    def last_complete(self) -> ObjectVersion | None:
        last = None
        for v in self.versions:
            if v.state == "complete":
                last = v
        return last

    def last_visible(self) -> ObjectVersion | None:
        """Newest complete version that is not a delete marker."""
        v = self.last_complete()
        if v is None or v.data.get("t") == "delete_marker":
            return None
        return v

    def to_obj(self) -> Any:
        return [self.bucket_id, self.key, [v.to_obj() for v in self.versions]]


def next_timestamp(existing: "Object | None") -> int:
    """Version timestamp for a new write: strictly after every version the
    key already has, even if a clock-skewed node wrote one in the future
    (reference put.rs:698 next_timestamp — without this, a delete issued
    after a future-dated write would lose the LWW race and the object
    would be undeletable until wall clocks catch up).  Shared by the API
    write paths, the lifecycle worker, and block purge."""
    from ...utils.time_util import now_msec

    ts = now_msec()
    if existing is not None and existing.versions:
        ts = max(ts, max(v.timestamp for v in existing.versions) + 1)
    return ts


def object_counts(e: "Object | None") -> dict[str, int]:
    """Counter deltas source (reference object_table.rs counts())."""
    if e is None:
        return {"objects": 0, "bytes": 0, "unfinished_uploads": 0}
    vis = e.last_visible()
    return {
        "objects": 1 if vis is not None else 0,
        "bytes": vis.data.get("meta", {}).get("size", 0) if vis else 0,
        "unfinished_uploads": sum(1 for v in e.versions if v.state == "uploading"),
    }


class ObjectTable(TableSchema):
    table_name = "object"

    def __init__(self, version_table=None, counter=None):
        self.version_table = version_table  # set by Garage after wiring
        self.counter = counter  # IndexCounter for per-bucket usage

    def entry_partition_key(self, e: Object) -> bytes:
        return e.bucket_id

    def entry_sort_key(self, e: Object) -> bytes:
        return e.key.encode()

    def decode_entry(self, obj: Any) -> Object:
        return Object(
            bytes(obj[0]), obj[1], [ObjectVersion.from_obj(v) for v in obj[2]]
        )

    def merge_entries(self, a: Object, b: Object) -> Object:
        a.merge(b)
        return a

    def is_tombstone(self, e: Object) -> bool:
        # an object whose only content is a delete marker is a tombstone
        return len(e.versions) == 1 and e.versions[0].data.get("t") == "delete_marker"

    def matches_filter(self, e: Object, filt) -> bool:
        if filt == "visible":
            return e.last_visible() is not None
        return True

    def updated(self, tx, old: Object | None, new: Object | None) -> None:
        """Cascade: versions that disappeared (pruned/aborted) get their
        data deleted via the version table (reference updated() hook)."""
        if self.counter is not None:
            oldc = object_counts(old)
            newc = object_counts(new)
            deltas = {k: newc[k] - oldc[k] for k in newc}
            pk = (new or old).bucket_id
            self.counter.count(tx, pk, b"", deltas)
        if self.version_table is None:
            return
        from .version_table import Version

        # a version's data is deleted when it disappeared from the merged
        # list OR it newly transitioned to aborted (object_table.rs:571-600)
        new_by_id = {v.uuid: v for v in new.versions} if new is not None else {}
        for v in old.versions if old is not None else []:
            nv = new_by_id.get(v.uuid)
            delete_version = (
                nv is None or (nv.state == "aborted" and v.state != "aborted")
            )
            if delete_version and v.data.get("t") != "delete_marker":
                # enqueue deletion (async local insert; the queue worker
                # fans it out with quorum)
                self.version_table.queue_insert(
                    Version.deleted_marker(v.uuid, old.bucket_id, old.key), tx=tx
                )