"""An in-process S3 cluster of this package's nodes.

Each node is a whole `Garage` (tables, model, block store, background
workers) built from a config, and the first `s3_nodes` of them serve
the S3 API (`S3ApiServer`) on a loopback port — what a storage daemon
wires together, in one process.  The CPU tests and `chip_smoke.py`
build their S3 clusters here:

    nodes = await make_s3_cluster(root, 11, mode="ec:8:3", device="cuda")
    key_id, secret = await make_key(nodes[0].garage, "smoke")
    client = S3Client(nodes[0].endpoint, key_id, secret)
    ...
    await stop_s3_cluster(nodes)

Every node has the storage role in the layout, one zone per node.  The
metadata tables replicate at `[meta] replication_factor` (3 by
default: quorum 2 of 3); blocks at the mode's width.  `device="cpu"`
asks for the kernels' plain versions (`[tpu] enable = false`); any other
device needs the CUDA card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

from ..api.s3.api_server import S3ApiServer
from ..model.garage import Garage
from ..rpc.layout.types import NodeRole
from ..utils.config import Config, config_from_dict
from .block_cluster import CAPACITY, TIMEOUT_S, wait_until

RPC_SECRET = "5e" * 32


@dataclass
class S3Node:
    index: int
    garage: Garage
    s3: S3ApiServer | None = None
    endpoint: str | None = None  # http://127.0.0.1:<port> when it serves S3


def node_config(
    root, index: int, *, mode: str, block_size: int, engine: str, device: str,
    extra: dict | None = None,
) -> Config:
    """Node `index`'s config: metadata in `root/n<index>/meta`, blocks in
    `root/n<index>/data`, RPC on a free loopback port.  `extra` entries
    override or add sections (e.g. `{"meta": {...}}`)."""
    d = {
        "metadata_dir": str(Path(root) / f"n{index}" / "meta"),
        "data_dir": str(Path(root) / f"n{index}" / "data"),
        "db_engine": engine,
        "replication_mode": mode,
        "rpc_bind_addr": "127.0.0.1:0",
        "rpc_secret": RPC_SECRET,
        "block_size": block_size,
        "tpu": {"enable": device != "cpu"},
        "s3_api": {"api_bind_addr": None, "s3_region": "garage"},
        **(extra or {}),
    }
    return config_from_dict(d)


def make_garage(config: Config, key: bytes | None = None) -> Garage:
    """`Garage(config)`, under the private key `key` (32 bytes, which fix
    the node id and so its place in the layout) when it is given and the
    node has none yet."""
    keyfile = os.path.join(config.metadata_dir, "node_key")
    if key is not None and not os.path.exists(keyfile):
        # graft-lint: allow-blocking(harness set-up: the node key is written once, before the node serves)
        os.makedirs(config.metadata_dir, exist_ok=True)
        # graft-lint: allow-blocking(harness set-up: the node key is written once, before the node serves)
        with open(keyfile, "wb") as f:
            f.write(key)
        os.chmod(keyfile, 0o600)
    return Garage(config)


async def serve_s3(node: S3Node) -> None:
    node.s3 = S3ApiServer(node.garage)
    await node.s3.start("127.0.0.1", 0)
    node.endpoint = f"http://127.0.0.1:{node.s3.runner.addresses[0][1]}"


async def connect_all(garages: list[Garage]) -> None:
    """Dial every pair, and wait until each node sees all the others."""
    for i, gi in enumerate(garages):
        for gj in garages[i + 1:]:
            await gj.netapp.connect(gi.netapp.bind_addr, gi.node_id)
    n = len(garages)
    await wait_until(
        lambda: all(len(g.system.peering.connected_peers()) == n - 1 for g in garages),
        TIMEOUT_S, "full mesh")


async def apply_layout(garages: list[Garage]) -> None:
    """Give every node the storage role, one zone per node, in one applied
    layout, and wait until all agree."""
    lm = garages[0].layout_manager
    for i, g in enumerate(garages):
        lm.stage_role(g.node_id, NodeRole(zone=f"z{i}", capacity=CAPACITY))
    lm.apply_staged()
    await wait_until(lambda: all(g.layout_manager.digest() == lm.digest() for g in garages),
                     TIMEOUT_S, "layout agreement")


async def make_s3_cluster(
    root, n: int, *, mode: str = "ec:2:1", block_size: int = 8192,
    engine: str = "sqlite", device: str = "cuda", s3_nodes: int = 2,
    keys: list[bytes] | None = None, extra: dict | None = None,
) -> list[S3Node]:
    """`n` started, connected nodes sharing one applied layout, with
    their background workers spawned; the first `s3_nodes` serve S3.
    Node i's private key is `keys[i]` when given (random otherwise)."""
    garages = [
        make_garage(node_config(root, i, mode=mode, block_size=block_size, engine=engine,
                                device=device, extra=extra),
                    keys[i] if keys else None)
        for i in range(n)
    ]
    for g in garages:
        await g.start()
    await connect_all(garages)
    await apply_layout(garages)
    for g in garages:
        g.spawn_workers()
    nodes = [S3Node(i, g) for i, g in enumerate(garages)]
    for x in nodes[:s3_nodes]:
        await serve_s3(x)
    return nodes


async def make_key(garage: Garage, name: str) -> tuple[str, str]:
    """A new access key, through `GarageHelper`, that may create buckets:
    (key id, secret)."""
    key = await garage.helper.create_key(name)
    key.params().allow_create_bucket.update(True)
    await garage.key_table.insert(key)
    return key.key_id, key.secret()


async def stop_s3_node(node: S3Node) -> None:
    if node.s3 is not None:
        await node.s3.stop()
        node.s3 = None
    await node.garage.stop()


async def stop_s3_cluster(nodes: list[S3Node]) -> None:
    for x in nodes:
        await stop_s3_node(x)

