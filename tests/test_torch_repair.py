"""The port's repair verification (garage_tpu_torch/block/manager.py) on
its own 3-node EC(2,1) cluster, on the CPU.

Before a repair rebuilds a piece from gathered survivors, it decodes the
block and checks its content hash, so that one corrupt surviving piece
is never laundered into freshly rebuilt pieces.  A "corrupt survivor"
here is a piece file rewritten with other bytes under a matching piece
header: it passes the per-piece integrity check of every read and only
the block hash can catch it.

  - `bulk_reconstruct` verifies every gathered block with one
    `decode_batch` (one decode dispatch per erasure pattern, counted in
    ops/telemetry.py's dispatch records) in a worker thread, skips the
    corrupt block, queues it for resync and writes no piece for it.  The
    cluster asks for EcCuda's path with `[block] batch_impl = "xla"`,
    whose dispatches are counted per erasure pattern;
  - `reconstruct_local_piece` (the resync path) rejects the same block:
    the resync step fails, records the error and writes nothing.

The scrub worker ends its rest between passes when the operator starts
a pass (`repair scrub start`), which the reference's worker does not.

Every cluster test body runs under `asyncio.wait_for(..., 60)`.
"""

import asyncio
import os
import random
import threading
import types

import pytest
import torch

from garage_tpu_torch.block import manager as t_manager
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.tools import block_cluster as bc
from garage_tpu_torch.utils.data import blake2sum
from garage_tpu_torch.utils.config import BlockConfig
from garage_tpu_torch.utils.error import Error
from garage_tpu_torch.utils.metrics import registry
from time_limits import time_limit

_limit = time_limit(120)  # a stalled test fails instead of holding the run

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

N_BLOCKS = 6
SIZE = 8_000


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def dispatches(kernel: str) -> float:
    return registry.counters.get(
        ("tpu_codec_dispatch_total", (("kernel", kernel), ("platform", "cpu"))), 0.0)


async def cluster_losing_rank0(tmp_path):
    """3 port nodes and N_BLOCKS blocks of SIZE bytes, referenced
    everywhere.  With as many nodes as pieces every block has the same
    rank order, so one node holds rank 0 (a data rank) of every block:
    it loses those pieces.  Returns (nodes, that node, {hash: data})."""
    nodes = await bc.make_cluster(tmp_path, 3, lambda _i: EcCodec(2, 1, device="cpu"),
                                  zones=["dc1"] * 3, block_config=BlockConfig(batch_impl="xla"))
    rng = random.Random(7)
    blocks = {}
    for _ in range(N_BLOCKS):
        data = rng.randbytes(SIZE)
        blocks[blake2sum(data)] = data
        await nodes[0].manager.rpc_put_block(blake2sum(data), data)
    await asyncio.sleep(0.3)  # leftover background piece sends land
    layout = nodes[0].system.layout_manager.history.current()
    (first,) = {layout.nodes_of(h)[0] for h in blocks}
    (victim,) = [x for x in nodes if x.app.id == first]
    for x in nodes:
        x.manager.db.transaction(
            lambda tx, m=x.manager: [m.rc.incr(tx, h) for h in blocks] and None)
    for h in blocks:
        ((rank, (path, _c)),) = victim.manager.local_pieces(h).items()
        assert rank == 0
        os.remove(path)
    return nodes, victim, blocks


def corrupt_survivor(nodes, h: bytes) -> None:
    """Rewrite the rank-1 piece of block h with flipped bytes under a
    matching piece header."""
    for x in nodes:
        pieces = x.manager.local_pieces(h)
        if 1 in pieces:
            path = pieces[1][0]
            blen, piece = t_manager.unwrap_piece(open(path, "rb").read())
            bad = bytes(b ^ 0x5A for b in piece[:64]) + piece[64:]
            open(path, "wb").write(t_manager.wrap_piece(blen, bad))
            return
    raise AssertionError("no node holds rank 1")


def test_bulk_reconstruct_verifies_in_one_dispatch_and_rejects_corrupt(tmp_path, monkeypatch):
    async def main():
        nodes, victim, blocks = await cluster_losing_rank0(tmp_path)
        try:
            hashes = list(blocks)
            bad = hashes[2]
            corrupt_survivor(nodes, bad)
            vm = victim.manager
            queued, decodes = [], []
            monkeypatch.setattr(vm.resync, "queue_block", lambda h, *a, **k: queued.append(h))
            decode_batch = vm.codec.decode_batch
            monkeypatch.setattr(vm.codec, "decode_batch", lambda items, impl: decodes.append(
                len(items)) or decode_batch(items, impl))
            threads = []
            verify = vm._verify_gathered
            monkeypatch.setattr(vm, "_verify_gathered", lambda items: threads.append(
                threading.current_thread()) or verify(items))
            d0 = dispatches("ec_reconstruct")
            n = await vm.bulk_reconstruct(hashes)
            # every gathered block lacks data rank 0: one erasure pattern,
            # so one verification dispatch, then one grouped rebuild
            assert decodes == [N_BLOCKS]
            assert dispatches("ec_reconstruct") - d0 == 2
            assert threads and threading.main_thread() not in threads, \
                "the verification ran on the event loop's thread"
            assert n == N_BLOCKS - 1
            assert queued == [bad]
            assert vm.find_block_file(bad, piece=0) is None, "a piece was rebuilt from corrupt input"
            want = EcCodec(2, 1, device="cpu")
            for h, data in blocks.items():
                if h == bad:
                    continue
                ((rank, (path, _c)),) = vm.local_pieces(h).items()
                assert rank == 0
                assert t_manager.unwrap_piece(open(path, "rb").read())[1] == want.encode(data)[0]
        finally:
            await bc.stop_all(nodes)

    run(main())


def test_reconstruct_local_piece_rejects_corrupt_survivor(tmp_path):
    async def main():
        nodes, victim, blocks = await cluster_losing_rank0(tmp_path)
        try:
            hashes = list(blocks)
            bad, good = hashes[0], hashes[1]
            corrupt_survivor(nodes, bad)
            vm = victim.manager
            with pytest.raises(Error, match="gathered pieces are corrupt"):
                await vm.reconstruct_local_piece(bad)
            assert vm.find_block_file(bad, piece=0) is None
            # through the resync worker: the step fails and is recorded
            vm.resync.queue_block(bad)
            assert await vm.resync.resync_iter()
            assert vm.resync.errors.get(bad) is not None
            assert vm.find_block_file(bad, piece=0) is None
            # an intact block is rebuilt by the same path
            assert await vm.reconstruct_local_piece(good)
            assert await vm.rpc_get_block(good) == blocks[good]
        finally:
            await bc.stop_all(nodes)

    run(main())


async def scrub_passes_after_start(repair_mod, background_mod) -> int:
    """A scrub worker under a `BackgroundRunner` over 3 blocks: after its
    first pass it rests; `cmd_start` is issued, and the blocks scrubbed
    within the next second are counted."""
    keys = [bytes([i]) * 32 for i in range(3)]
    seen = []

    class Tree:
        def iter_range(self, start=b""):
            return iter([(k, b"") for k in keys if k >= start])

    mgr = types.SimpleNamespace(rc=types.SimpleNamespace(tree=Tree()))
    w = repair_mod.ScrubWorker(mgr)
    w.state.tranquility = 0

    async def scrub_one(h):
        seen.append(h)

    w._scrub_one = scrub_one
    bg = background_mod.BackgroundRunner()
    bg.spawn(w)
    try:
        await bc.wait_until(lambda: seen == keys, 10, "the first pass")
        await asyncio.sleep(0.3)  # the pass is over: the worker rests
        first = len(seen)
        w.cmd_start()
        await asyncio.sleep(1.0)
        return len(seen) - first
    finally:
        await bg.shutdown()


def test_scrub_start_ends_the_rest_between_passes():
    """`repair scrub start` begins a pass at once, also while the scrub
    rests between passes (an hour).  The reference's worker sleeps
    through it: its commands do not wake the worker, so a pass started by
    the operator waits for the rest to end (F4 in ROADMAP queue 3)."""
    from garage_tpu.block import repair as j_repair
    from garage_tpu.utils import background as j_background
    from garage_tpu_torch.block import repair as t_repair
    from garage_tpu_torch.utils import background as t_background

    assert run(scrub_passes_after_start(t_repair, t_background)) == 3
    assert run(scrub_passes_after_start(j_repair, j_background)) == 0
