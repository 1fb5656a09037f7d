"""The port's table engine (garage_tpu_torch/table) held to the
reference on the CPU.

  - the reference's own table tests (tests/test_table.py) on port nodes:
    the Merkle trie's canonical shape, prefix keys, batch equivalence and
    no-op deletes, quorum insert and get, read repair, anti-entropy, the
    three-phase tombstone GC, the insert queue and reverse ranges;
  - for the same seeded inserts, every serialized entry, every Merkle
    trie node and every partition's root hash are bit-identical between
    a port table and a reference table;
  - a mixed cluster of two reference nodes and one port node converges
    by anti-entropy, each way, to the same Merkle roots.
"""

import asyncio
import random

import torch

import test_table as ref
from garage_tpu.db import open_db as j_open_db
from garage_tpu.net import NetApp as JNetApp
from garage_tpu.net.handshake import gen_node_key
from garage_tpu.rpc.layout.manager import LayoutManager as JLayoutManager
from garage_tpu.rpc.layout.types import NodeRole as JNodeRole
from garage_tpu.rpc.replication_mode import ReplicationMode as JReplicationMode
from garage_tpu.rpc.rpc_helper import RpcHelper as JRpcHelper
from garage_tpu.rpc.system import System as JSystem
from garage_tpu.table.data import TableData as JTableData
from garage_tpu.table.merkle import MerkleUpdater as JMerkleUpdater
from garage_tpu.table.replication import TableShardedReplication as JSharded
from garage_tpu.table.table import Table as JTable
from garage_tpu.utils.crdt import Bool as JBool
from garage_tpu.utils.crdt import Lww as JLww
from garage_tpu_torch.db import open_db
from garage_tpu_torch.net import NetApp
from garage_tpu_torch.rpc.layout.manager import LayoutManager
from garage_tpu_torch.rpc.replication_mode import ReplicationMode
from garage_tpu_torch.rpc.rpc_helper import RpcHelper
from garage_tpu_torch.rpc.system import System
from garage_tpu_torch.table.data import TableData
from garage_tpu_torch.table.merkle import MerkleUpdater
from garage_tpu_torch.table.replication import TableShardedReplication
from garage_tpu_torch.table.table import Table
from garage_tpu_torch.utils.crdt import Bool, Lww
from test_torch_s3 import mirrored_tests, port_mirror
from torch_mirror import time_limit

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

# a test still running after 3 minutes ends its worker process, so that no
# scenario can hold the suite past its clock
_limit = time_limit(180)

table_mirror = port_mirror("test_table.py")
globals().update(mirrored_tests(table_mirror, "table"))
KvEntry, KvSchema = table_mirror.KvEntry, table_mirror.KvSchema  # the port's


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def seeded_rows(seed: int, n: int = 300) -> list[tuple]:
    """(pk, sk, ts, value, deleted) rows: a few partitions with shared and
    strict-prefix sort keys, overwrites, older writes and tombstones."""
    rng = random.Random(seed)
    pks = [rng.randbytes(rng.randint(1, 12)) for _ in range(12)]
    rows = []
    for _ in range(n):
        sk = b"shared/" + rng.randbytes(rng.randint(0, 4))
        value = rng.choice([None, rng.randint(0, 1 << 40), rng.randbytes(8).hex()])
        rows.append((rng.choice(pks), sk, rng.randint(1, 50), value, rng.random() < 0.1))
    return rows


class _Partitions:
    def partition_of(self, h):
        return h[0]


def fill(data, updater, entry, lww, boolean, rows) -> list[bytes]:
    """Write `rows` through `data.update_entry`, then apply the Merkle todo
    queue in one batch; returns the serialized entries written."""
    written = []
    for pk, sk, ts, value, deleted in rows:
        blob = data.encode(entry(pk, sk, lww.raw(ts, value), boolean(deleted)))
        written.append(blob)
        data.update_entry(blob)
    updater.update_batch(list(data.merkle_todo.iter_range()))
    return written


def test_entries_and_merkle_trie_are_bit_identical(tmp_path):
    rows = seeded_rows(7)
    jd = JTableData(j_open_db(str(tmp_path / "j"), engine="memory"), ref.KvSchema(),
                    _Partitions())
    td = TableData(open_db(str(tmp_path / "t"), engine="memory"), KvSchema(), _Partitions())
    jm, tm = JMerkleUpdater(jd), MerkleUpdater(td)
    j_written = fill(jd, jm, ref.KvEntry, JLww, JBool, rows)
    t_written = fill(td, tm, KvEntry, Lww, Bool, rows)
    assert t_written == j_written
    assert list(td.store.iter_range()) == list(jd.store.iter_range())
    assert len(list(td.store.iter_range())) > 100
    assert list(td.merkle_tree.iter_range()) == list(jd.merkle_tree.iter_range())
    parts = {k[0] for k, _v in jd.store.iter_range()}
    assert len(parts) > 5
    for p in range(256):
        assert tm.root_hash(p) == jm.root_hash(p), p
    # each side decodes the other's bytes to an entry that encodes back
    for (_k, v), (_k2, v2) in zip(jd.store.iter_range(), td.store.iter_range()):
        assert td.encode(td.decode(v)) == v and jd.encode(jd.decode(v2)) == v2


async def mixed_table_cluster(tmp_path):
    """Nodes 0 and 1 of the reference, node 2 of the port, one layout,
    a KvSchema table on each (rf 3: every node holds every partition)."""
    netkey = ref.NETKEY
    apps = [JNetApp(netkey, gen_node_key()), JNetApp(netkey, gen_node_key()),
            NetApp(netkey, gen_node_key())]
    for app in apps:
        await app.listen("127.0.0.1", 0)
    pkgs = [(JLayoutManager, JSystem, JReplicationMode)] * 2 + [
        (LayoutManager, System, ReplicationMode)]
    systems = []
    for app, (lm_cls, sys_cls, mode_cls) in zip(apps, pkgs):
        peers = [(a.id, a.bind_addr) for a in apps if a is not app]
        s = sys_cls(app, lm_cls(app.id, 3), mode_cls(3), bootstrap=peers)
        await s.start()
        systems.append(s)
    for _ in range(200):
        await asyncio.sleep(0.05)
        if all(len(s.peering.connected_peers()) == 2 for s in systems):
            break
    lm0 = systems[0].layout_manager
    for app in apps:
        lm0.stage_role(app.id, JNodeRole(zone="dc1", capacity=10**12))
    lm0.apply_staged()
    for _ in range(200):
        await asyncio.sleep(0.05)
        if all(s.layout_manager.digest() == lm0.digest() for s in systems):
            break
    assert all(s.layout_manager.digest() == lm0.digest() for s in systems)
    tables = []
    for i, (app, s) in enumerate(zip(apps, systems)):
        if i < 2:
            tables.append(JTable(s, JRpcHelper(app.id, s.peering),
                                 j_open_db(str(tmp_path / f"n{i}"), engine="memory"),
                                 ref.KvSchema(), JSharded(s)))
        else:
            tables.append(Table(s, RpcHelper(app.id, s.peering),
                                open_db(str(tmp_path / f"n{i}"), engine="memory"),
                                KvSchema(), TableShardedReplication(s)))
    return apps, systems, tables


def local_write(table, entry, lww, boolean, rows) -> None:
    """Rows into one node's local storage only (a node the others missed),
    with its Merkle trie brought up to date."""
    for pk, sk, ts, value, deleted in rows:
        table.data.update_entry(table.data.encode(entry(pk, sk, lww.raw(ts, value),
                                                        boolean(deleted))))
    settle_merkle([table])


def settle_merkle(tables) -> None:
    """Apply each table's Merkle todo queue (no Merkle worker runs here)."""
    for t in tables:
        todo = list(t.data.merkle_todo.iter_range())
        t.merkle.update_batch(todo)
        for key, _vh in todo:
            t.data.merkle_todo.remove(key)


def test_mixed_cluster_converges_by_anti_entropy(tmp_path):
    async def main():
        apps, systems, tables = await mixed_table_cluster(tmp_path)
        try:
            rows = seeded_rows(11, 120)
            # the reference node 0 alone holds the first half ...
            local_write(tables[0], ref.KvEntry, JLww, JBool, rows[:60])
            stats = await tables[0].syncer.sync_all_partitions()
            assert stats["pushed"] > 0
            # ... the port node alone the second half
            local_write(tables[2], KvEntry, Lww, Bool, rows[60:])
            stats = await tables[2].syncer.sync_all_partitions()
            assert stats["pushed"] > 0
            settle_merkle(tables)
            stores = [list(t.data.store.iter_range()) for t in tables]
            assert stores[0] == stores[1] == stores[2]
            parts = {k[0] for k, _v in stores[0]}
            for p in parts:
                roots = {t.merkle.root_hash(p) for t in tables}
                assert len(roots) == 1, p
            # the port node reads a reference node's rows back by quorum
            pk, sk, *_ = rows[0]
            got = await tables[2].get(pk, sk)
            assert got is not None
            assert tables[2].data.encode(got) == tables[0].data.read_entry(pk, sk)
        finally:
            for s in systems:
                await s.stop()
            for a in apps:
                await a.shutdown()

    run(main())
