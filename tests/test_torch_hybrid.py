"""Hybrid acceptance on the CPU: the reference's in-process storage
cluster (garage_tpu block manager, S3 API, RPC) driven by the port's
`EcCodec`.  No reference file is edited: the port's codec is handed to
`make_block_cluster` (tests/test_block.py) and, for the S3 cluster, put
in place of `garage_tpu.model.garage.get_codec` with monkeypatch.

The reference's codec batcher passes its `impl` ("auto" / "host" /
"xla") to the port's codec, which takes it as the reference's does.
These tests hold EcCuda's CPU path (the mesh fan-out, the `path="cpu"`
counters), so they ask for "xla": the nodes' batchers are set to it,
and `xla_codec` binds it to `reconstruct_batch`, which the reference's
repair plane calls without one."""

import asyncio
import functools
import os

import pytest
import torch

import garage_tpu.model.garage as jax_garage
from garage_tpu.api.s3.client import S3Client
from garage_tpu.api.s3.api_server import S3ApiServer
from garage_tpu.block.codec import ReplicaCodec
from garage_tpu.utils.data import blake2sum
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.ops.ec_cuda import EcCuda
from garage_tpu_torch.utils.metrics import registry

from test_block import make_block_cluster, stop_all
from test_ec_cluster import make_ec_cluster, stop_cluster
from torch_mirror import time_limit

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

# a test still running after 3 minutes ends its worker process, so that no
# scenario can hold the suite past its clock
_limit = time_limit(180)

N = 8


def xla_codec(*args, **kw) -> EcCodec:
    """A CPU `EcCodec` whose `reconstruct_batch` asks for EcCuda's path."""
    codec = EcCodec(*args, device="cpu", **kw)
    codec.reconstruct_batch = functools.partial(codec.reconstruct_batch, impl="xla")
    return codec


def run(coro):
    return asyncio.run(coro)


@pytest.fixture
def port_mesh_calls(monkeypatch):
    calls = []
    orig = EcCuda._apply_mesh

    def wrapper(self, key, x, n, rec):
        calls.append((x.shape[0], n))
        return orig(self, key, x, n, rec)

    monkeypatch.setattr(EcCuda, "_apply_mesh", wrapper)
    return calls


def _port_blocks(op: str, path: str) -> float:
    return registry.counters.get(("block_codec_blocks_total", (("op", op), ("path", path))), 0.0)


def test_bulk_reconstruct_through_port_mesh(tmp_path, port_mesh_calls):
    """The reference's `BlockManager.bulk_reconstruct` rebuilds every lost
    piece bit-exactly through the port's 8-entry fan-out (mirrors
    tests/test_mesh_repair.py::test_bulk_reconstruct_through_mesh)."""

    async def main():
        codec = xla_codec(2, 1, n_devices=N)
        apps, systems, managers = await make_block_cluster(tmp_path, codec=codec)
        for mgr in managers:
            mgr.codec = xla_codec(2, 1, n_devices=N)
        try:
            blocks = {}
            for _ in range(40):  # one size -> one rectangular mesh dispatch
                data = os.urandom(8_192)
                h = blake2sum(data)
                blocks[h] = data
                await managers[0].rpc_put_block(h, data)
            await asyncio.sleep(0.3)
            for mgr in managers:
                for h in blocks:
                    mgr.db.transaction(lambda tx, h=h: mgr.rc.incr(tx, h))
            vm = managers[1]
            lost = set()
            for h in blocks:
                for _pi, (path, _c) in vm.local_pieces(h).items():
                    os.remove(path)
                    lost.add(h)
            assert len(lost) >= N, "cluster placed too few pieces on vm"
            port_mesh_calls.clear()
            rebuilt = await vm.bulk_reconstruct(list(blocks.keys()))
            assert rebuilt == len(lost)
            assert port_mesh_calls and all(n == N for _b, n in port_mesh_calls), \
                "bulk_reconstruct skipped the port's mesh"
            for h, data in blocks.items():
                assert await vm.rpc_get_block(h) == data
        finally:
            await stop_all(apps, systems)

    run(main())


def test_ec_s3_cluster_on_port_codec(tmp_path, monkeypatch):
    """The reference's in-process EC S3 cluster with the port's codec:
    a multi-block PUT, a GET through another node, and a degraded GET
    after one node's shards are deleted, all bit-exact."""
    made = []

    def port_get_codec(ec_params=None, **_kw):
        if ec_params is None:
            return ReplicaCodec()
        made.append(xla_codec(*ec_params))
        return made[-1]

    monkeypatch.setattr(jax_garage, "get_codec", port_get_codec)

    async def main():
        garages = await make_ec_cluster(tmp_path)
        assert len(made) == 3 and all(g.block_manager.codec is c for g, c in zip(garages, made))
        for g in garages:
            g.block_manager.batcher.impl = "xla"
        s3_0, s3_2 = S3ApiServer(garages[0]), S3ApiServer(garages[2])
        await s3_0.start("127.0.0.1", 0)
        await s3_2.start("127.0.0.1", 0)
        key = await garages[0].helper.create_key("port-codec")
        key.params().allow_create_bucket.update(True)
        await garages[0].key_table.insert(key)
        c0 = S3Client(f"http://127.0.0.1:{s3_0.runner.addresses[0][1]}", key.key_id, key.secret())
        c2 = S3Client(f"http://127.0.0.1:{s3_2.runner.addresses[0][1]}", key.key_id, key.secret())
        try:
            await c0.create_bucket("hybrid")
            big = os.urandom(120_000)  # 15 blocks at 8 KiB
            encoded = _port_blocks("encode", "cpu")
            await c0.put_object("hybrid", "striped.bin", big)
            assert _port_blocks("encode", "cpu") >= encoded + 15
            assert await c0.get_object("hybrid", "striped.bin") == big

            # wipe a node that holds data rank 0 of some block, once table
            # sync has told it of all 15, so the degraded GET must decode
            def rank0_holder():
                for g in garages:
                    bm = g.block_manager
                    held = [bm.local_pieces(h) for h, _v in bm.rc.tree.iter_range()]
                    if sum(1 for p in held if p) >= 15 and any(0 in p for p in held):
                        return bm
                return None

            victim = None
            for _ in range(100):
                victim = rank0_holder()
                if victim is not None:
                    break
                await asyncio.sleep(0.05)
            assert victim is not None, "no node holds a piece of all 15 blocks and a data rank 0"
            for h, _v in victim.rc.tree.iter_range():
                for _pi, (path, _c) in victim.local_pieces(h).items():
                    os.remove(path)
            rebuilt = _port_blocks("reconstruct", "cpu")
            assert await c2.get_object("hybrid", "striped.bin") == big
            assert _port_blocks("reconstruct", "cpu") > rebuilt, \
                "the degraded GET decoded nothing through the port's codec"
        finally:
            await stop_cluster(garages, [s3_0, s3_2], [c0, c2])

    run(main())
