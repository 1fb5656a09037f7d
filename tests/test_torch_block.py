"""The port's block store (garage_tpu_torch/block) on its own cluster
plane, held to the reference on the CPU.

  - the port's 3-node EC(2,1) cluster (`device="cpu"`) passes the
    reference's own block tests (tests/test_block.py): distinct pieces,
    read and reconstruct, bulk reconstruct, piece scrub, resync fetch
    and delete; and the repair planner run of tests/test_repair_plan.py
    on an 8-entry CPU mesh;
  - a mixed cluster of two reference nodes and one port node reads
    every block bit-exact whichever package wrote it, and every piece
    file is byte-identical to the reference's encoding;
  - state carried across: a port node started on a stopped reference
    node's metadata (sqlite) and data directories serves its blocks;
  - the port's host BLAKE3 equals the pure-Python oracle and the
    reference's native library.

Every cluster test body runs under `asyncio.wait_for(..., 60)`, so a
stuck test fails on its own.
"""

import asyncio
import os
import random

import numpy as np
import pytest
import torch

import garage_tpu.block.manager as j_manager
from garage_tpu import _native as j_native
from garage_tpu.block.codec.ec import EcCodec as JEcCodec
from garage_tpu.block.manager import BlockManager as JBlockManager
from garage_tpu.db import open_db as j_open_db
from garage_tpu.net import NetApp as JNetApp
from garage_tpu.net.handshake import gen_node_key
from garage_tpu.rpc.layout.manager import LayoutManager as JLayoutManager
from garage_tpu.rpc.layout.manager import PersistedLayout as JPersistedLayout
from garage_tpu.rpc.layout.types import NodeRole as JNodeRole
from garage_tpu.rpc.replication_mode import ReplicationMode as JReplicationMode
from garage_tpu.rpc.rpc_helper import RpcHelper as JRpcHelper
from garage_tpu.rpc.system import System as JSystem
from garage_tpu.utils.config import DataDir as JDataDir
from garage_tpu.utils.persister import Persister as JPersister
from garage_tpu_torch import _native as t_native
from garage_tpu_torch.block import manager as t_manager
from garage_tpu_torch.block import rc as t_rc
from garage_tpu_torch.block.codec import ReplicaCodec
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.block.repair import ScrubWorker
from garage_tpu_torch.block.repair_plan import PlanParams, RepairPlanner
from garage_tpu_torch.ops import hash_cuda
from garage_tpu_torch.ops.blake3_ref import blake3 as py_blake3
from garage_tpu_torch.rpc.layout.types import NodeRole as TNodeRole
from garage_tpu_torch.tools import block_cluster as bc
from garage_tpu_torch.utils.background import WorkerState
from garage_tpu_torch.utils.config import BlockConfig
from garage_tpu_torch.utils.data import blake2sum
from garage_tpu_torch.utils.error import Error
from garage_tpu_torch.utils.metrics import registry

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

EC3 = ["dc1"] * 3  # the reference test cluster's zones


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def port_codec(_i=0, **kw):
    return EcCodec(2, 1, device="cpu", **kw)


async def port_cluster(tmp_path, **kw):
    return await bc.make_cluster(tmp_path, 3, port_codec, zones=EC3, **kw)


async def reference(nodes, hashes):
    """Reference the blocks on every node's rc (as the block_ref table
    hook would): bulk repair and resync refuse unreferenced blocks."""
    for x in nodes:
        mgr = x.manager
        mgr.db.transaction(lambda tx, m=mgr: [m.rc.incr(tx, h) for h in hashes] and None)


async def populate(nodes, n_blocks, size=4096, seed=0, via=0):
    rng = random.Random(seed)
    blocks = {}
    for _ in range(n_blocks):
        data = rng.randbytes(size)
        h = blake2sum(data)
        blocks[h] = data
        await nodes[via].manager.rpc_put_block(h, data)
    await asyncio.sleep(0.3)  # leftover background piece sends land
    await reference(nodes, list(blocks))
    return blocks


# --- the reference's block tests on the port's cluster -------------------------


def test_ec_block_put_distinct_pieces(tmp_path):
    async def main():
        nodes = await port_cluster(tmp_path)
        try:
            data = os.urandom(50_000)
            h = blake2sum(data)
            await nodes[0].manager.rpc_put_block(h, data)
            await asyncio.sleep(0.2)
            held = {}
            for i, x in enumerate(nodes):
                pieces = x.manager.local_pieces(h)
                assert len(pieces) == 1, f"node {i} holds {len(pieces)} pieces"
                for p, (path, _c) in pieces.items():
                    blen, piece = t_manager.unwrap_piece(open(path, "rb").read())
                    assert blen == len(data)
                    held[p] = piece
            assert set(held) == {0, 1, 2}
            c = nodes[0].manager.codec
            assert c.decode({0: held[0], 1: held[1]}, len(data)) == data
            assert c.decode({1: held[1], 2: held[2]}, len(data)) == data
            # the same pieces as the reference codec's
            want = JEcCodec(2, 1, tpu_enable=False).encode(data)
            assert [held[i] for i in range(3)] == want
        finally:
            await bc.stop_all(nodes)

    run(main())


def test_ec_read_and_reconstruct(tmp_path):
    async def main():
        nodes = await port_cluster(tmp_path)
        try:
            data = os.urandom(37_123)  # deliberately unaligned length
            h = blake2sum(data)
            await nodes[0].manager.rpc_put_block(h, data)
            await asyncio.sleep(0.2)
            assert await nodes[0].manager.rpc_get_block(h) == data
            victim = None
            for x in nodes:
                pieces = x.manager.local_pieces(h)
                if 0 in pieces:
                    victim = x.manager
                    os.remove(pieces[0][0])
                    break
            assert victim is not None
            assert await nodes[2].manager.rpc_get_block(h) == data
            await reference(nodes, [h])
            victim.resync.queue_block(h)
            assert await victim.resync.resync_iter()
            assert victim.local_pieces(h), "piece not reconstructed"
            assert await victim.rpc_get_block(h) == data
        finally:
            await bc.stop_all(nodes)

    run(main())


def test_ec_bulk_reconstruct(tmp_path):
    async def main():
        nodes = await port_cluster(tmp_path)
        try:
            blocks = {}
            for i in range(12):
                data = os.urandom(8_000 + i)
                h = blake2sum(data)
                blocks[h] = data
                await nodes[0].manager.rpc_put_block(h, data)
            await asyncio.sleep(0.3)
            await reference(nodes, list(blocks))
            vm = nodes[1].manager
            lost = []
            for h in blocks:
                for _pi, (path, _c) in vm.local_pieces(h).items():
                    os.remove(path)
                    lost.append(h)
            assert lost
            n = await vm.bulk_reconstruct(list(blocks))
            assert n == len(set(lost)), f"rebuilt {n} != lost {len(set(lost))}"
            for h, data in blocks.items():
                assert await vm.rpc_get_block(h) == data
        finally:
            await bc.stop_all(nodes)

    run(main())


def test_ec_piece_scrub_detects_corruption(tmp_path, monkeypatch):
    async def main():
        nodes = await port_cluster(tmp_path)
        launches = []
        real = hash_cuda.blake3_batch

        def counting(x):
            launches.append(tuple(x.shape))
            return real(x)

        monkeypatch.setattr("garage_tpu_torch.block.repair.blake3_batch", counting)
        try:
            data = os.urandom(25_000)
            h = blake2sum(data)
            await nodes[0].manager.rpc_put_block(h, data)
            await asyncio.sleep(0.2)
            await reference(nodes, [h])
            vm = nodes[1].manager
            ((_pi, (path, _c)),) = vm.local_pieces(h).items()
            raw = bytearray(open(path, "rb").read())
            raw[-1] ^= 0xFF
            open(path, "wb").write(bytes(raw))
            with pytest.raises(Error):
                t_manager.unwrap_piece(bytes(raw))
            w = ScrubWorker(vm)
            await w._scrub_pieces([h])
            assert w.state.corruptions == 1
            # 25_000 bytes -> 12_544-byte pieces: not a K2 length, host hash
            assert launches == []
            assert not vm.local_pieces(h)
            assert os.path.exists(path + ".corrupted")
            assert await vm.resync.resync_iter()
            assert vm.local_pieces(h)
            assert await vm.rpc_get_block(h) == data
        finally:
            await bc.stop_all(nodes)

    run(main())


def test_scrub_hashes_k2_lengths_through_the_device_hasher(tmp_path, monkeypatch):
    """Pieces whose length the batched hasher takes go through
    `hash_cuda.blake3_batch` on the codec's device, one call per length
    group; a corrupted piece among them is caught."""

    async def main():
        nodes = await port_cluster(tmp_path)
        calls = []
        real = hash_cuda.blake3_batch

        def counting(x):
            calls.append((tuple(x.shape), x.device.type))
            return real(x)

        monkeypatch.setattr("garage_tpu_torch.block.repair.blake3_batch", counting)
        try:
            blocks = await populate(nodes, 6, size=8192)  # 4096-byte pieces
            vm = nodes[2].manager
            victim = next(iter(blocks))
            ((_pi, (path, _c)),) = vm.local_pieces(victim).items()
            raw = bytearray(open(path, "rb").read())
            raw[100] ^= 0x01
            open(path, "wb").write(bytes(raw))
            w = ScrubWorker(vm)
            await w._scrub_pieces(list(blocks))
            assert calls == [((6, 4096), "cpu")]
            assert w.state.corruptions == 1
            assert os.path.exists(path + ".corrupted")
        finally:
            await bc.stop_all(nodes)

    run(main())


def test_resync_fetch_and_delete(tmp_path, monkeypatch):
    monkeypatch.setattr(t_rc, "BLOCK_GC_DELAY_MS", -1)

    async def main():
        nodes = await bc.make_cluster(tmp_path, 3, lambda i: ReplicaCodec(), zones=EC3, rf=3)
        try:
            data = os.urandom(40_000)
            h = blake2sum(data)
            for x in nodes[:2]:
                stored, comp = x.manager._maybe_compress(data)
                await x.manager.write_block_local(h, stored, comp)
            await reference(nodes, [h])
            m2 = nodes[2].manager
            assert not m2.has_block(h)
            m2.resync.queue_block(h)
            assert await m2.resync.resync_iter()
            assert m2.has_block(h)
            assert await m2.rpc_get_block(h) == data
            for x in nodes:
                x.manager.db.transaction(lambda tx, m=x.manager: m.rc.decr(tx, h))
            m2.resync.queue_block(h)
            assert await m2.resync.resync_iter()
            assert not m2.has_block(h)
        finally:
            await bc.stop_all(nodes)

    run(main())


# --- the repair planner on an 8-entry CPU mesh -----------------------------------


def _counter(name, **want):
    return sum(v for (n, labels), v in registry.counters.items()
               if n == name and all(dict(labels).get(k) == x for k, x in want.items()))


def _hist_count(name, **want):
    return sum(c for (n, labels), (c, _s, _b) in registry.durations.items()
               if n == name and all(dict(labels).get(k) == x for k, x in want.items()))


async def drive(planner, max_iters=500):
    for _ in range(max_iters):
        res = await planner.work()
        if (res[0] if isinstance(res, tuple) else res) == WorkerState.DONE:
            return
    raise AssertionError("planner did not finish")


def test_planner_end_to_end_mesh_engaged(tmp_path):
    """tests/test_repair_plan.py::test_planner_end_to_end_mesh_engaged on
    the port: a one-node piece wipe is repaired in a few coalesced rounds
    whose reconstructions fan out over 8 CPU mesh entries (EcCuda's
    plain version, asked for with `batch_impl = "xla"`)."""

    async def main():
        nodes = await bc.make_cluster(
            tmp_path, 3, lambda i: port_codec(n_devices=8), zones=EC3,
            block_config=BlockConfig(batch_impl="xla"))
        try:
            blocks = await populate(nodes, 64)
            vm = nodes[1].manager
            assert vm.codec._ec._mesh_width() == 8
            lost = set()
            for h in blocks:
                for _pi, (path, _c) in vm.local_pieces(h).items():
                    os.remove(path)
                    lost.add(h)
            assert len(lost) >= 2 * 8, "cluster placed too few pieces on vm"
            mesh0 = _counter("tpu_mesh_engaged_total", kernel="ec_reconstruct")
            blocks0 = _counter("repair_plan_blocks_total")
            rounds0 = _counter("repair_plan_rounds_total")
            bs0 = _hist_count("repair_plan_batch_size")
            planner = RepairPlanner(vm, metadata_dir=str(tmp_path / "plan-meta"),
                                    params=PlanParams(tranquility=0, batch_blocks=64))
            await drive(planner)
            assert planner.plan.state == "done"
            assert planner.plan.repaired == len(lost)
            for h in lost:
                assert vm.local_pieces(h), f"{h.hex()[:12]} not restored"
            for h, data in list(blocks.items())[:8]:
                assert await vm.rpc_get_block(h) == data
            assert _counter("tpu_mesh_engaged_total", kernel="ec_reconstruct") > mesh0
            assert _counter("repair_plan_blocks_total") - blocks0 == len(lost)
            assert 1 <= _counter("repair_plan_rounds_total") - rounds0 <= 3
            assert _hist_count("repair_plan_batch_size") > bs0
            assert planner._gauge_keys == []
        finally:
            await bc.stop_all(nodes)

    run(main())


# --- mixed reference + port cluster --------------------------------------------

async def start_ref_node(root, i, app, key, bootstrap, engine="memory"):
    """A reference node wired as the port's cluster tool wires its own."""
    meta, data = str(root / f"meta{i}"), str(root / f"data{i}")
    os.makedirs(meta, exist_ok=True)
    lm = JLayoutManager(app.id, 3, persister=JPersister(meta, "cluster_layout",
                                                         JPersistedLayout))
    system = JSystem(app, lm, JReplicationMode(3), bootstrap=bootstrap)
    await system.start()
    db = j_open_db(meta, engine=engine)
    mgr = JBlockManager(system, JRpcHelper(app.id, system.peering), db,
                        [JDataDir(data)], meta, codec=JEcCodec(2, 1, tpu_enable=False))
    return bc.Node(i, key, app, system, db, mgr, data)


async def mixed_cluster(root, kinds, engine="memory"):
    keys = [gen_node_key() for _ in kinds]
    apps = []
    for kind, key in zip(kinds, keys):
        app = (JNetApp if kind == "ref" else bc.NetApp)(bc.NETKEY, key)
        await app.listen("127.0.0.1", 0)
        apps.append(app)
    nodes = []
    for i, (kind, app) in enumerate(zip(kinds, apps)):
        peers = [(a.id, a.bind_addr) for a in apps if a is not app]
        if kind == "ref":
            nodes.append(await start_ref_node(root, i, app, keys[i], peers, engine))
        else:
            nodes.append(await bc.start_node(root, i, app, keys[i], port_codec(), peers,
                                             engine=engine))
    await bc.wait_until(lambda: all(len(x.system.peering.connected_peers()) == 2
                                    for x in nodes), 30, "full mesh")
    lm0 = nodes[0].system.layout_manager
    role = JNodeRole if kinds[0] == "ref" else TNodeRole  # node 0's own type
    for x in nodes:
        lm0.stage_role(x.app.id, role(zone="dc1", capacity=bc.CAPACITY))
    lm0.apply_staged()
    await bc.wait_until(lambda: all(x.system.layout_manager.digest() == lm0.digest()
                                    for x in nodes), 30, "layout agreement")
    return nodes


def expected_files(data: bytes) -> list[bytes]:
    """Each rank's piece file as the reference writes it."""
    pieces = JEcCodec(2, 1, tpu_enable=False).encode(data)
    return [j_manager.wrap_piece(len(data), p) for p in pieces]


def test_mixed_cluster_reads_both_ways(tmp_path):
    async def main():
        nodes = await mixed_cluster(tmp_path, ["ref", "ref", "port"])
        try:
            rng = random.Random(5)
            written = {}
            for via in (0, 2, 1, 2):  # reference and port writers, in turns
                for size in (4096, 37_123, 65_536):
                    data = rng.randbytes(size)
                    h = blake2sum(data)
                    await nodes[via].manager.rpc_put_block(h, data)
                    written[h] = (data, via)
            await asyncio.sleep(0.3)
            for h, (data, via) in written.items():
                for reader in (0, 1, 2):
                    assert await nodes[reader].manager.rpc_get_block(h) == data, (via, reader)
                files = {}
                for x in nodes:
                    for rank, (path, comp) in x.manager.local_pieces(h).items():
                        assert not comp
                        files[rank] = open(path, "rb").read()
                assert files == dict(enumerate(expected_files(data))), f"writer {via}"
        finally:
            await bc.stop_all(nodes)

    run(main())


def test_port_node_serves_reference_state(tmp_path):
    """A reference node on the sqlite engine is stopped; a port node under
    the same key opens its metadata (persisted cluster layout, data
    layout, rc in sqlite) and data directories and serves its blocks."""

    async def main():
        nodes = await mixed_cluster(tmp_path, ["ref", "ref", "ref"], engine="sqlite")
        try:
            blocks = await populate(nodes, 10, size=20_000, seed=3)
            old = nodes[2]
            pieces_before = {h: old.manager.local_pieces(h) for h in blocks}
            await bc.stop_node(old)
            node = await bc.restart_node(tmp_path, old, nodes[:2], port_codec(),
                                         engine="sqlite")
            nodes[2] = node
            assert node.app.id == old.app.id
            assert isinstance(node.manager, t_manager.BlockManager)
            # the carried rc, data layout and pieces
            for h in blocks:
                assert node.manager.rc.is_needed(h)
                assert node.manager.local_pieces(h) == pieces_before[h]
            for h, data in blocks.items():
                assert await node.manager.rpc_get_block(h) == data
            # a reference node needs the port node's pieces once node 1's are gone
            for h in blocks:
                for _pi, (path, _c) in nodes[1].manager.local_pieces(h).items():
                    os.remove(path)
            for h, data in blocks.items():
                assert await nodes[0].manager.rpc_get_block(h) == data
        finally:
            await bc.stop_all(nodes)

    run(main())


# --- host BLAKE3 -----------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 63, 64, 1023, 1024, 1025, 131072, 100001])
def test_host_blake3(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    got = t_native.blake3(data)
    assert got == py_blake3(data)
    if j_native.available():
        assert got == j_native.blake3(data)
    if n:
        rows = np.frombuffer(data * 3, dtype=np.uint8).reshape(3, n)
        assert t_native.blake3_batch(rows).tobytes() == got * 3


def test_host_blake3_rejects_non_rows():
    with pytest.raises(ValueError):
        t_native.blake3_batch(np.zeros(64, dtype=np.uint8))
