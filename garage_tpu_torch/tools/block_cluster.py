"""An in-process block-store cluster of this package's nodes.

Each node is a `NetApp` listening on loopback TCP, a `System` (peering,
status, layout gossip), a `LayoutManager` persisted in the node's
metadata directory, a metadata `Db` and a `BlockManager` over one data
directory — the parts a storage daemon wires together, without the
table and API layers.  The CPU tests and `chip_smoke.py` build their
clusters here:

    nodes = await make_cluster(root, 11, lambda i: EcCodec(8, 3, device="cuda"))
    await nodes[0].manager.rpc_put_block(h, data)
    ...
    await stop_all(nodes)

Every node has the storage role in the layout, one zone per node unless
`zones` says otherwise, and the replication factor is the codec's piece
count (k + m for `EcCodec(k, m)`) unless `rf` says otherwise, so each
node holds one rank of every block.  `block_config` (a `BlockConfig`,
the `[block]` section) goes to every node's `BlockManager`; its
`batch_impl` chooses the codec's backend for the batched calls.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from ..block.codec.base import BlockCodec
from ..block.manager import BlockManager
from ..db import Db, open_db
from ..net import NetApp
from ..net.handshake import gen_node_key
from ..rpc.layout.manager import LayoutManager, PersistedLayout
from ..rpc.layout.types import NodeRole
from ..rpc.replication_mode import ReplicationMode
from ..rpc.rpc_helper import RpcHelper
from ..rpc.system import System
from ..utils.config import BlockConfig, DataDir
from ..utils.persister import Persister

NETKEY = b"B" * 32
CAPACITY = 10**12
TIMEOUT_S = 30.0  # for the mesh to close and the layout to spread


@dataclass
class Node:
    index: int
    key: bytes
    app: NetApp
    system: System
    db: Db
    manager: BlockManager
    data_dir: str


async def wait_until(pred: Callable[[], bool], timeout: float, what: str) -> None:
    """Poll `pred` every 50 ms; raise TimeoutError naming `what` after
    `timeout` seconds."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            raise TimeoutError(f"{what}: not reached in {timeout} s")
        await asyncio.sleep(0.05)


async def listen(key: bytes) -> NetApp:
    app = NetApp(NETKEY, key)
    await app.listen("127.0.0.1", 0)
    return app


async def start_node(
    root, index: int, app: NetApp, key: bytes, codec: BlockCodec,
    bootstrap: list[tuple[bytes, tuple[str, int]]], *, engine: str = "memory",
    rf: int | None = None, block_config: BlockConfig | None = None,
) -> Node:
    """System + Db + BlockManager on a listening `app`; metadata in
    `root/meta<index>`, blocks in `root/data<index>`.  The replication
    factor is `rf`, by default the codec's piece count."""
    meta = str(Path(root) / f"meta{index}")
    data = str(Path(root) / f"data{index}")
    # graft-lint: allow-blocking(harness set-up: one mkdir for a node that is not serving yet)
    os.makedirs(meta, exist_ok=True)
    rf = rf or codec.n_pieces
    lm = LayoutManager(app.id, rf, persister=Persister(meta, "cluster_layout", PersistedLayout))
    system = System(app, lm, ReplicationMode(rf), bootstrap=bootstrap)
    await system.start()
    db = open_db(meta, engine=engine)
    mgr = BlockManager(
        system, RpcHelper(app.id, system.peering), db, [DataDir(data)], meta,
        codec=codec, block_config=block_config,
    )
    return Node(index, key, app, system, db, mgr, data)


async def make_cluster(
    root, n: int, codec_of: Callable[[int], BlockCodec], *, zones: list[str] | None = None,
    engine: str = "memory", rf: int | None = None, keys: list[bytes] | None = None,
    block_config: BlockConfig | None = None,
) -> list[Node]:
    """`n` connected nodes sharing one applied layout; node i's codec is
    `codec_of(i)`, its private key `keys[i]` (any 32 bytes; random by
    default), which fixes its node id and so its place in the layout."""
    keys = keys or [gen_node_key() for _ in range(n)]
    apps = [await listen(k) for k in keys]
    nodes = []
    for i, app in enumerate(apps):
        peers = [(a.id, a.bind_addr) for a in apps if a is not app]
        nodes.append(await start_node(root, i, app, keys[i], codec_of(i), peers,
                                      engine=engine, rf=rf, block_config=block_config))
    await wait_until(
        lambda: all(len(x.system.peering.connected_peers()) == n - 1 for x in nodes),
        TIMEOUT_S, "full mesh")
    lm0 = nodes[0].system.layout_manager
    for i, x in enumerate(nodes):
        lm0.stage_role(x.app.id, NodeRole(zone=zones[i] if zones else f"z{i}",
                                          capacity=CAPACITY))
    lm0.apply_staged()
    await wait_until(lambda: all(x.system.layout_manager.digest() == lm0.digest() for x in nodes),
                     TIMEOUT_S, "layout agreement")
    return nodes


async def stop_node(node: Node) -> None:
    await node.manager.close()
    await node.system.stop()
    await node.app.shutdown()
    node.db.close()


async def stop_all(nodes: list[Node]) -> None:
    for x in nodes:
        await stop_node(x)


async def restart_node(
    root, old: Node, peers: list[Node], codec: BlockCodec, *, engine: str = "memory",
    block_config: BlockConfig | None = None,
) -> Node:
    """Start node `old.index` again under its key (so its node id and
    layout roles are unchanged) on its metadata and data directories,
    and wait until it is connected to `peers` and agrees on the layout."""
    app = await listen(old.key)
    node = await start_node(root, old.index, app, old.key, codec,
                            [(p.app.id, p.app.bind_addr) for p in peers],
                            engine=engine, block_config=block_config)
    want = {p.app.id for p in peers}
    await wait_until(lambda: want <= set(node.system.peering.connected_peers()),
                     TIMEOUT_S, f"node {old.index} reconnected")
    digest = peers[0].system.layout_manager.digest()
    await wait_until(lambda: node.system.layout_manager.digest() == digest,
                     TIMEOUT_S, f"node {old.index} layout")
    return node
