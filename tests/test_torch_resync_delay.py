"""The resync check that a block's 0 -> 1 refcount queues waits for the
PUT that made the reference (garage_tpu_torch/block/resync.py,
`INCREF_CHECK_TIMEOUTS`; model/s3/block_ref_table.py).

On a one-node port node on the CPU, right after a few multi-block PUTs,
every new block's check is due no sooner than twice the RPC timeout (the
timeout a block PUT waits on).  The resync worker then runs past its
idle wait and past that delay: `block-list-errors` stays empty for every
block that is on disk, and a block removed from disk after its PUT is
tried and reported there.  A check queued with no delay (`queue_blocks`,
as `repair blocks` and the repair planner queue) is tried at once.

The reference queues the same check due at once (kept divergence,
ROADMAP queue 3, F8): a try before the PUT's own write lands fails and
backs off 60 s, which `test_admin_ops.py::test_block_ops` saw as an
error entry right after its PUT.
"""

import asyncio
import os

import pytest
import torch

from torch_mirror import time_limit, twin_node

torch.set_num_threads(1)  # one thread per suite worker

_limit = time_limit(90)

RPC_TIMEOUT_MS = 2000  # the delay is twice this
IDLE_WAIT_S = 10.0  # the resync worker's wait for work (block/resync.py)
N_OBJECTS, OBJECT_BYTES = 3, 9000  # three 4 KiB blocks an object


def run(coro, limit=60):
    return asyncio.run(asyncio.wait_for(coro, limit))


async def put_objects(pkg: str, root):
    """A started one-node `Garage` of `pkg` with its S3 server, after
    N_OBJECTS PUTs; (garage, admin rpc handler, s3 server, msec before
    the first PUT, msec after the last)."""
    from importlib import import_module

    garage, adm = await twin_node(pkg, root, b"\x05" * 32, rpc_timeout_msec=RPC_TIMEOUT_MS)
    s3 = import_module(f"{pkg}.api.s3.api_server").S3ApiServer(garage)
    await s3.start("127.0.0.1", 0)
    key = await garage.helper.create_key("resync-key")
    key.params().allow_create_bucket.update(True)
    await garage.key_table.insert(key)
    client = import_module(f"{pkg}.api.s3.client").S3Client(
        f"http://127.0.0.1:{s3.runner.addresses[0][1]}", key.key_id, key.secret())
    now_msec = import_module(f"{pkg}.utils.time_util").now_msec
    await client.create_bucket("resync")
    t0 = now_msec()
    for i in range(N_OBJECTS):
        await client.put_object("resync", f"o{i}", os.urandom(OBJECT_BYTES))
    t1 = now_msec()
    await client.close()
    return garage, adm, s3, t0, t1


def due_times(resync) -> dict[bytes, list[int]]:
    """Every queued block's due times, msec."""
    out: dict[bytes, list[int]] = {}
    for key, _ in resync.queue.iter_range():
        out.setdefault(key[8:], []).append(int.from_bytes(key[:8], "big"))
    return out


async def list_errors(adm) -> list[dict]:
    from garage_tpu_torch.net.message import Req

    return (await adm._handle(b"\x00" * 32, Req(["block-list-errors", {}]))).body


def test_incref_check_waits_for_the_put_then_reports_a_missing_block(tmp_path):
    from garage_tpu_torch.block.resync import INCREF_CHECK_TIMEOUTS

    async def main():
        garage, adm, s3, t0, _t1 = await put_objects("garage_tpu_torch", tmp_path)
        try:
            bm = garage.block_manager
            blocks = [h for h, _v in bm.rc.tree.iter_range()]
            assert len(blocks) == N_OBJECTS * 3
            delay = bm.resync.incref_delay_ms()
            assert delay == INCREF_CHECK_TIMEOUTS * RPC_TIMEOUT_MS == 4000
            due = due_times(bm.resync)
            assert set(due) == set(blocks)
            assert all(min(w) >= t0 + delay for w in due.values()), (t0, delay, due)
            assert await list_errors(adm) == []

            gone = blocks[0]
            os.remove(bm.find_block_file(gone)[0])
            await asyncio.sleep(IDLE_WAIT_S + delay / 1000)
            errs = await list_errors(adm)
            assert [e["hash"] for e in errs] == [gone.hex()], errs
            assert errs[0]["failures"] == 1
            assert bm.resync.queue_len() == 1  # the missing block, backed off
        finally:
            await s3.stop()
            await garage.stop()

    run(main())


@pytest.mark.parametrize("pkg,delay_ms", [("garage_tpu", 0),
                                          ("garage_tpu_torch", 2 * RPC_TIMEOUT_MS)])
def test_incref_check_delay_beside_the_reference(tmp_path, pkg, delay_ms):
    """The delay each package gives the checks its block_ref table queues
    on the same PUTs: none on the reference, twice the RPC timeout on the
    port."""

    async def main():
        from importlib import import_module

        resync_mod = import_module(f"{pkg}.block.resync")
        delays: list[int] = []
        queue_block = resync_mod.BlockResyncManager.queue_block

        def recording(self, hash32, delay_ms=0, tx=None):
            if tx is not None:  # from inside a table's updated() hook
                delays.append(delay_ms)
            return queue_block(self, hash32, delay_ms=delay_ms, tx=tx)

        resync_mod.BlockResyncManager.queue_block = recording
        try:
            garage, _adm, s3, _t0, _t1 = await put_objects(pkg, tmp_path)
        finally:
            resync_mod.BlockResyncManager.queue_block = queue_block
        try:
            assert delays == [delay_ms] * (N_OBJECTS * 3)
        finally:
            await s3.stop()
            await garage.stop()

    run(main())


def test_queue_blocks_without_delay_is_tried_at_once(tmp_path):
    async def main():
        garage, _adm, s3, _t0, _t1 = await put_objects("garage_tpu_torch", tmp_path)
        try:
            bm = garage.block_manager
            gone = next(h for h, _v in bm.rc.tree.iter_range())
            os.remove(bm.find_block_file(gone)[0])
            bm.resync.queue_blocks([gone])  # as `repair blocks` and the planner queue
            for _ in range(100):
                if bm.resync.errors.get(gone) is not None:
                    break
                await asyncio.sleep(0.05)
            assert bm.resync.errors.get(gone) is not None, "not tried within 5 s"
        finally:
            await s3.stop()
            await garage.stop()

    run(main())
