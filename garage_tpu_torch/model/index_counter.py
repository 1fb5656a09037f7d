"""Distributed index counters (reference src/model/index_counter.rs).

Every node that stores a table partition maintains, transactionally with
each entry write, a LOCAL count of items/bytes under each (pk, sk) counter
key.  It then publishes its count into a replicated counter table whose
entries map node -> (ts, value), merged per-node by newest timestamp.  The
aggregate value of a counter is the MAX over current layout nodes: every
replica counts the same logical set, so the freshest replica's number is
the truth — no cross-node transactions needed.

Used for per-bucket objects / bytes / unfinished-upload counts (quota
enforcement + bucket info).
"""

from __future__ import annotations

from typing import Any

from ..table.schema import TableSchema
from ..utils.serde import pack, unpack
from ..utils.time_util import now_msec


class CounterEntry:
    def __init__(self, pk: bytes, sk: bytes, values: dict[str, dict[bytes, list]]):
        self.pk = pk
        self.sk = sk
        # values[name][node] = [ts, value]
        self.values = values

    def merge(self, other: "CounterEntry") -> None:
        for name, nodes in other.values.items():
            mine = self.values.setdefault(name, {})
            for node, (ts, v) in nodes.items():
                if node not in mine or ts > mine[node][0]:
                    mine[node] = [ts, v]

    def aggregate(self, layout_nodes: list[bytes]) -> dict[str, int]:
        out = {}
        for name, nodes in self.values.items():
            vals = [v for n, (_ts, v) in nodes.items() if n in layout_nodes]
            if not vals:
                vals = [v for _n, (_ts, v) in nodes.items()]
            if vals:
                out[name] = max(vals)
        return out

    def to_obj(self) -> Any:
        return [
            self.pk,
            self.sk,
            {
                name: [[n, ts, v] for n, (ts, v) in nodes.items()]
                for name, nodes in self.values.items()
            },
        ]


class CounterTable(TableSchema):
    def __init__(self, table_name: str):
        self.table_name = table_name

    def entry_partition_key(self, e: CounterEntry) -> bytes:
        return e.pk

    def entry_sort_key(self, e: CounterEntry) -> bytes:
        return e.sk

    def decode_entry(self, obj: Any) -> CounterEntry:
        return CounterEntry(
            bytes(obj[0]),
            bytes(obj[1]),
            {
                name: {bytes(n): [int(ts), int(v)] for n, ts, v in rows}
                for name, rows in obj[2].items()
            },
        )


class IndexCounter:
    """One instance per counted table (reference IndexCounter<T>)."""

    def __init__(self, system, counter_table, db):
        self.system = system
        self.table = counter_table  # Table[CounterTable]
        self.local = db.open_tree(f"{counter_table.schema.table_name}:local")

    def count(self, tx, pk: bytes, sk: bytes, deltas: dict[str, int]) -> None:
        """Apply counter deltas transactionally; called from a table's
        updated() hook."""
        if not any(deltas.values()):
            return
        key = pk + b"\x00" + sk
        raw = tx.get(self.local, key)
        values: dict[str, list] = unpack(raw) if raw else {}
        now = now_msec()
        for name, d in deltas.items():
            ts, v = values.get(name, [0, 0])
            values[name] = [max(ts + 1, now), v + d]
        tx.insert(self.local, key, pack(values))
        entry = CounterEntry(
            pk, sk,
            {
                name: {self.system.id: [ts, v]}
                for name, (ts, v) in values.items()
            },
        )
        self.table.queue_insert(entry, tx=tx)

    async def get_values(self, pk: bytes, sk: bytes = b"") -> dict[str, int]:
        entry = await self.table.get(pk, sk)
        if entry is None:
            return {}
        nodes = self.system.layout_manager.history.current().storage_nodes()
        return entry.aggregate(nodes)