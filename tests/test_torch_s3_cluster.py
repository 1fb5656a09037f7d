"""Port S3 nodes beside reference S3 nodes, on the CPU.

  - state carried across: a reference node writes objects over S3 and
    stops; a port `Garage` opened on its sqlite metadata and data
    directories serves the same objects byte-exact over S3, with the same
    listing;
  - a mixed EC(2,1) cluster of two reference nodes and one port node
    (tools/s3_cluster.py builds the port node): an object PUT through the
    port node's S3 endpoint reads back byte-exact through a reference
    node's endpoint, and the other way round;
  - F3: on a port node wired by `Garage`, the telemetry digest carries
    the canary prober's `digest_fields`;
  - a port cluster from tools/s3_cluster.py (EC(2,1), 3 nodes, sqlite,
    metadata replicated 3 times) serves S3 through both of its endpoints.

Every body runs under `asyncio.wait_for(..., 60)`.  Tolerance: zero for
bytes and ETags.
"""

import asyncio
import hashlib
import random

import torch

from garage_tpu.api.s3.api_server import S3ApiServer as JS3ApiServer
from garage_tpu.api.s3.client import S3Client as JS3Client
from garage_tpu.model.garage import Garage as JGarage
from garage_tpu.rpc.layout.types import NodeRole as JNodeRole
from garage_tpu.utils.config import config_from_dict as j_config_from_dict
from garage_tpu_torch.api.s3 import canary
from garage_tpu_torch.api.s3.client import S3Client
from garage_tpu_torch.rpc.telemetry_digest import DigestCollector
from garage_tpu_torch.tools import s3_cluster
from garage_tpu_torch.utils.data import blake2sum
from test_torch_s3 import s3_mirror
from time_limits import time_limit

_limit = time_limit(120)  # a stalled test fails instead of holding the run

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

BLOCK = 8192
RNG = random.Random(21)
OBJECTS = {
    "inline": RNG.randbytes(900),
    "one-block": RNG.randbytes(BLOCK),
    "multi/blocks": RNG.randbytes(5 * BLOCK + 17),
}
MPU_PARTS = [RNG.randbytes(3 * BLOCK + 5), RNG.randbytes(2 * BLOCK)]
WANT = {**OBJECTS, "mpu": b"".join(MPU_PARTS)}  # what a bucket holds after `put_all`


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def ref_config(tmp_path, name: str, *, mode: str, engine: str):
    """A reference node's config of the same shape as `s3_cluster.node_config`."""
    return j_config_from_dict({
        "metadata_dir": str(tmp_path / name / "meta"),
        "data_dir": str(tmp_path / name / "data"),
        "db_engine": engine,
        "replication_mode": mode,
        "rpc_bind_addr": "127.0.0.1:0",
        "rpc_secret": s3_cluster.RPC_SECRET,
        "block_size": BLOCK,
        "tpu": {"enable": False},
        "s3_api": {"api_bind_addr": None, "s3_region": "garage"},
    })


async def put_all(client, bucket: str) -> dict[str, str]:
    etags = {k: await client.put_object(bucket, k, body) for k, body in OBJECTS.items()}
    uid = await client.create_multipart_upload(bucket, "mpu")
    part_etags = [await client.upload_part(bucket, "mpu", uid, i + 1, p)
                  for i, p in enumerate(MPU_PARTS)]
    etags["mpu"] = await client.complete_multipart_upload(
        bucket, "mpu", uid, list(enumerate(part_etags, 1)))
    return etags


async def read_all(client, bucket: str) -> dict[str, bytes]:
    return {k: await client.get_object(bucket, k) for k in WANT}


def test_port_node_serves_a_stopped_reference_nodes_directories(tmp_path):
    async def main():
        cfg = ref_config(tmp_path, "node", mode="1", engine="sqlite")
        ref = JGarage(cfg)
        await ref.start()
        ref.layout_manager.stage_role(ref.node_id, JNodeRole(zone="dc1", capacity=10**12))
        ref.layout_manager.apply_staged()
        ref.spawn_workers()
        srv = JS3ApiServer(ref)
        await srv.start("127.0.0.1", 0)
        key = await ref.helper.create_key("carried")
        key.params().allow_create_bucket.update(True)
        await ref.key_table.insert(key)
        client = JS3Client(f"http://127.0.0.1:{srv.runner.addresses[0][1]}",
                           key.key_id, key.secret())
        try:
            await client.create_bucket("carried-bucket")
            etags = await put_all(client, "carried-bucket")
            listing = await client.list_objects_v2("carried-bucket")
        finally:
            await client.close()
            await srv.stop()
            await ref.stop()

        # the same directories under a port node (the same node key)
        node = s3_cluster.S3Node(0, s3_cluster.make_garage(s3_cluster.node_config(
            tmp_path, 0, mode="1", block_size=BLOCK, engine="sqlite", device="cpu",
            extra={"metadata_dir": cfg.metadata_dir,
                   "data_dir": cfg.data_dir[0].path})))
        assert node.garage.node_id == ref.node_id
        await node.garage.start()
        node.garage.spawn_workers()
        await s3_cluster.serve_s3(node)
        client = S3Client(node.endpoint, key.key_id, key.secret())
        try:
            assert await read_all(client, "carried-bucket") == WANT
            assert await client.list_objects_v2("carried-bucket") == listing
            assert sorted(e["etag"] for e in listing["keys"]) == sorted(etags.values())
            assert etags["one-block"] == hashlib.md5(OBJECTS["one-block"]).hexdigest()
        finally:
            await client.close()
            await s3_cluster.stop_s3_node(node)

    run(main())


def test_mixed_ec_cluster_serves_both_ways(tmp_path):
    """Nodes 0 and 1 of the reference, node 2 of the port, EC(2,1): each
    node holds one piece of every block."""
    async def main():
        refs = [JGarage(ref_config(tmp_path, f"n{i}", mode="ec:2:1", engine="memory"))
                for i in range(2)]
        port = s3_cluster.S3Node(2, s3_cluster.make_garage(s3_cluster.node_config(
            tmp_path, 2, mode="ec:2:1", block_size=BLOCK, engine="memory", device="cpu")))
        garages = [*refs, port.garage]
        servers, clients = [], []
        for g in garages:
            await g.start()
        try:
            await s3_cluster.connect_all(garages)
            await s3_cluster.apply_layout(garages)
            for g in garages:
                g.spawn_workers()
            srv = JS3ApiServer(refs[0])
            await srv.start("127.0.0.1", 0)
            servers.append(srv)
            await s3_cluster.serve_s3(port)
            key_id, secret = await s3_cluster.make_key(refs[0], "mixed")
            ref_client = JS3Client(f"http://127.0.0.1:{srv.runner.addresses[0][1]}",
                                   key_id, secret)
            port_client = S3Client(port.endpoint, key_id, secret)
            clients = [ref_client, port_client]
            await port_client.create_bucket("from-port")
            await ref_client.create_bucket("from-ref")
            port_etags = await put_all(port_client, "from-port")
            ref_etags = await put_all(ref_client, "from-ref")
            assert port_etags == ref_etags
            assert await read_all(ref_client, "from-port") == WANT
            assert await read_all(port_client, "from-ref") == WANT
            assert (await ref_client.list_objects_v2("from-port"))["keys"] == (
                await port_client.list_objects_v2("from-ref"))["keys"]
            # every node holds one piece of each multi-block object's blocks
            block0 = blake2sum(OBJECTS["multi/blocks"][:BLOCK])
            for g in garages:
                assert len(g.block_manager.local_pieces(block0)) == 1
        finally:
            for c in clients:
                await c.close()
            for s in servers:
                await s.stop()
            if port.s3 is not None:
                await port.s3.stop()
            for g in garages:
                await g.stop()

    run(main())


def test_digest_collector_reports_the_canary(tmp_path):
    """F3: the collector imports the port's canary and reports its
    `digest_fields`, with the live worker's last verdict."""
    async def main():
        garage, s3, endpoint = await s3_mirror.make_daemon(tmp_path)
        try:
            garage.config.admin.canary_interval_secs = 0.05
            garage.config.admin.canary_object_bytes = 8192
            w = garage.spawn_canary(endpoint)
            for _ in range(400):
                await asyncio.sleep(0.05)
                if w.probes >= 2:
                    break
            assert w.probes >= 2 and w.failed == 0 and w.healthy == 1.0, w.status()
            assert garage.system.telemetry_collector == garage.telemetry.collect
            # past the collector's cache of an earlier (gossip) collection
            await asyncio.sleep(garage.telemetry.min_interval)
            got = garage.telemetry.collect()["canary"]
            after = canary.digest_fields()  # the prober runs on: counts only grow
            assert set(got) == set(after) | {"ok"} and got["ok"] == 1.0
            assert 3 <= got["ops"] <= after["ops"] and got["err"] == after["err"] == 0
            assert got["p99"] is not None and after["p99"] is not None
            assert DigestCollector(garage).collect()["canary"]["ops"] >= got["ops"]
        finally:
            await s3_mirror.teardown(garage, s3)

    run(main())


def test_port_s3_cluster_serves_through_both_endpoints(tmp_path):
    async def main():
        nodes = await s3_cluster.make_s3_cluster(tmp_path, 3, mode="ec:2:1", block_size=BLOCK,
                                                 engine="sqlite", device="cpu")
        clients = []
        try:
            assert [x.endpoint is not None for x in nodes] == [True, True, False]
            key_id, secret = await s3_cluster.make_key(nodes[0].garage, "cluster")
            clients = [S3Client(x.endpoint, key_id, secret) for x in nodes[:2]]
            await clients[0].create_bucket("cluster-bucket")
            etags = await put_all(clients[0], "cluster-bucket")
            assert etags["multi/blocks"] == hashlib.md5(OBJECTS["multi/blocks"]).hexdigest()
            assert await read_all(clients[1], "cluster-bucket") == WANT
            assert all(x.garage.meta_replication_mode.replication_factor == 3 for x in nodes)
        finally:
            for c in clients:
                await c.close()
            await s3_cluster.stop_s3_cluster(nodes)

    run(main())
