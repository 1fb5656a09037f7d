"""K2V items: a DVVS (dotted version vector set) CRDT register
(reference src/model/k2v/item_table.rs:28-117 + causality.rs:21-47).

An item at (bucket, partition_key, sort_key) holds, per writer node, a
discard horizon `t_discard` and the concurrent values written after it:

  items[node] = {"t": t_discard, "v": [[t, value | None], ...]}   t > t_discard

A write carries the causality token (vector clock {node: t}) of the state
it has seen; everything covered by the token is discarded, so the item
converges to exactly the set of concurrent (un-seen) writes — multiple
values survive iff they were truly concurrent.  None = tombstone value.
"""

from __future__ import annotations

import base64
from typing import Any

from ...table.schema import TableSchema
from ...utils.serde import pack, unpack


class CausalContext:
    """Vector clock {node_id: last_seen_t}, encoded base64(msgpack)."""

    def __init__(self, vv: dict[bytes, int] | None = None):
        self.vv = vv or {}

    def serialize(self) -> str:
        return base64.urlsafe_b64encode(
            pack(sorted([[n, t] for n, t in self.vv.items()]))
        ).decode()

    @classmethod
    def parse(cls, s: str) -> "CausalContext":
        try:
            rows = unpack(base64.urlsafe_b64decode(s.encode()))
            return cls({bytes(n): int(t) for n, t in rows})
        except Exception as e:
            raise ValueError(f"bad causality token: {e}") from e


class K2VItem:
    def __init__(
        self,
        bucket_id: bytes,
        partition_key: str,
        sort_key: str,
        items: dict[bytes, dict] | None = None,
    ):
        self.bucket_id = bucket_id
        self.partition_key = partition_key
        self.sort_key = sort_key
        self.items = items or {}

    # --- DVVS ops -------------------------------------------------------------

    def max_t(self) -> int:
        out = 0
        for e in self.items.values():
            out = max(out, e["t"], *[t for t, _v in e["v"]] or [0])
        return out

    def causal_context(self) -> CausalContext:
        vv = {}
        for node, e in self.items.items():
            vv[node] = max(e["t"], *[t for t, _v in e["v"]] or [0])
        return CausalContext(vv)

    def update(
        self,
        this_node: bytes,
        context: CausalContext | None,
        value: bytes | None,
        node_ts: int = 0,
    ) -> int:
        """Apply a write allocated on this_node (reference item_table.rs
        update()): discard everything the writer has seen, then append the
        new value with a fresh dot.

        `node_ts` is the writer node's GLOBAL monotonic timestamp floor
        (reference rpc.rs local_insert: max(persisted, now_msec)).  Dots
        must be monotonic per NODE — not just per item — because the
        PollRange seen-marker's vector clock asserts "every item this node
        produced with t <= clock has been seen" (seen.py).  Returns the
        allocated timestamp."""
        if context is not None:
            for node, seen_t in context.vv.items():
                # nodes we have no entry for yet STILL get their horizon
                # recorded (reference item_table.rs:79-91) — otherwise a
                # value synced in later would resurrect past the token
                e = self.items.setdefault(node, {"t": 0, "v": []})
                if seen_t > e["t"]:
                    e["t"] = seen_t
                    e["v"] = [[t, v] for t, v in e["v"] if t > seen_t]
        new_t = max(self.max_t(), node_ts) + 1
        e = self.items.setdefault(this_node, {"t": 0, "v": []})
        e["v"].append([new_t, value])
        return new_t

    def values(self) -> list[bytes | None]:
        out = []
        for _node, e in sorted(self.items.items()):
            for _t, v in sorted(e["v"]):
                out.append(bytes(v) if v is not None else None)
        return out

    def live_values(self) -> list[bytes]:
        return [v for v in self.values() if v is not None]

    def is_tombstone(self) -> bool:
        vals = self.values()
        return all(v is None for v in vals)

    # --- CRDT -----------------------------------------------------------------

    def merge(self, other: "K2VItem") -> None:
        for node, oe in other.items.items():
            e = self.items.get(node)
            if e is None:
                self.items[node] = {"t": oe["t"], "v": [list(x) for x in oe["v"]]}
                continue
            t_discard = max(e["t"], oe["t"])
            by_t = {t: v for t, v in e["v"]}
            for t, v in oe["v"]:
                by_t.setdefault(t, v)
            e["t"] = t_discard
            e["v"] = sorted([[t, v] for t, v in by_t.items() if t > t_discard])

    def counts(self) -> dict[str, int]:
        vals = self.values()
        live = [v for v in vals if v is not None]
        return {
            "items": 0 if self.is_tombstone() else 1,
            "conflicts": 1 if len(live) > 1 else 0,
            "values": len(live),
            "bytes": sum(len(v) for v in live),
        }

    def to_obj(self) -> Any:
        return [
            self.bucket_id,
            self.partition_key,
            self.sort_key,
            [[n, e["t"], e["v"]] for n, e in sorted(self.items.items())],
        ]


class K2VItemTable(TableSchema):
    table_name = "k2v_item"

    def __init__(self, counter=None, sub_manager=None):
        self.counter = counter
        self.sub_manager = sub_manager

    def entry_partition_key(self, e: K2VItem) -> bytes:
        # placement by (bucket, partition_key) — reference k2v partitioning
        return e.bucket_id + e.partition_key.encode()

    def entry_sort_key(self, e: K2VItem) -> bytes:
        return e.sort_key.encode()

    def decode_entry(self, obj: Any) -> K2VItem:
        return K2VItem(
            bytes(obj[0]),
            obj[1],
            obj[2],
            {
                bytes(n): {"t": int(t), "v": [[int(tt), bytes(v) if v is not None else None] for tt, v in vals]}
                for n, t, vals in obj[3]
            },
        )

    def merge_entries(self, a, b):
        a.merge(b)
        return a

    def is_tombstone(self, e: K2VItem) -> bool:
        return e.is_tombstone()

    def matches_filter(self, e, filt) -> bool:
        if filt == "conflicts":
            return len(e.live_values()) > 1
        if filt == "present":
            return not e.is_tombstone()
        return True

    def updated(self, tx, old, new) -> None:
        if self.counter is not None:
            oldc = old.counts() if old else {"items": 0, "conflicts": 0, "values": 0, "bytes": 0}
            newc = new.counts() if new else {"items": 0, "conflicts": 0, "values": 0, "bytes": 0}
            deltas = {k: newc[k] - oldc[k] for k in newc}
            ent = new or old
            # counter keyed (bucket, partition_key): all of a bucket's
            # counters share one placement partition, so ReadIndex is an
            # ordered distributed range read (reference index.rs)
            self.counter.count(
                tx, ent.bucket_id, ent.partition_key.encode(), deltas
            )
        if self.sub_manager is not None and new is not None:
            self.sub_manager.notify(new)