"""The port's S3 serving path (garage_tpu_torch/api, model, table) held
to the reference on the CPU.

  - the reference's own S3 scenarios (tests/test_s3_api.py) run on a
    port node through the port's client: buckets, inline and multi-block
    objects, ranged GETs, multipart, list v1 and v2, copy, delete, POST
    object, bucket config, SSE-C, checksums, streaming signatures and
    the lifecycle worker, the admin API and the website server.  The
    scenarios are the reference file's own text with
    every `garage_tpu` import pointed at the port, and each node's
    config asks for the CPU (`[tpu] enable = false`);
  - the SigV4 vectors of tests/test_sigv4_vectors.py against the port's
    `api/common/signature.py`, the same way;
  - the aborted-overwrite race of tests/test_put_abort_race.py on port
    nodes, held to that file's stated assertions, the same way; its
    first scenario with the object table's anti-entropy held off once
    every node's first round is done, so node 1's injected row cannot
    reach the others before the abort does (the order the scenario
    states);
  - cross checks: the reference's `S3Client` against a port node and
    the port's `S3Client` against a reference node give the same
    statuses, ETags, object bytes and parsed listings.

Tolerance: zero for bytes, digests and ETags.
"""

import asyncio
import random
import re

import torch

import test_s3_api as ref_s3
from garage_tpu.api.s3.client import S3Client as JS3Client
from garage_tpu_torch.api.s3.client import S3Client
from torch_mirror import assert_mirror_whole, mirrored_tests, port_mirror, time_limit

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

# a test still running after 3 minutes ends its worker process, so that no
# scenario can hold the suite past its clock
_limit = time_limit(180)

S3_LEFT_OUT = ()  # every scenario runs on the port, the admin API and website included
s3_mirror = port_mirror("test_s3_api.py", S3_LEFT_OUT)
globals().update(mirrored_tests(s3_mirror, "s3"))
sigv4_mirror = port_mirror("test_sigv4_vectors.py")
globals().update(mirrored_tests(sigv4_mirror, "sigv4"))
frozen_clock = sigv4_mirror.frozen_clock  # the vectors' fixture
abort_mirror = port_mirror("test_put_abort_race.py")
globals().update(mirrored_tests(abort_mirror, "abort_race"))


async def hold_object_sync(garages, timeout: float = 30.0) -> None:
    """Wait until each node's object-table sync worker has finished a
    round at the current placement, then hold its further rounds off
    (the placement no longer changes in the scenario): from here on no
    row moves between nodes but through the scenario's own steps."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    for g in garages:
        name = f"sync:{g.object_table.schema.table_name}"
        worker = next(w for w, _i, _t in g.bg.workers.values() if w.name() == name)
        placement = g.layout_manager.history.placement_digest
        while worker._last_placement != placement():
            assert loop.time() < deadline, f"{name}: no clean round in {timeout} s"
            await asyncio.sleep(0.05)
        g.object_table.syncer.anti_entropy_interval = float("inf")


def test_abort_race_partial_complete_then_abort_tombstones_last_acked_version(
        tmp_path, monkeypatch):
    """The reference's first scenario of tests/test_put_abort_race.py on
    port nodes, with the anti-entropy order fixed: the object table's
    rounds are done before node 1 takes the injected "complete" row and
    held off after, so that row reaches the other nodes only through the
    scenario's abort, and every GET reads "version data missing"."""
    boot = abort_mirror.boot_cluster

    async def boot_and_hold_sync(root):
        booted = await boot(root)
        await hold_object_sync(booted[0])
        return booted

    monkeypatch.setattr(abort_mirror, "boot_cluster", boot_and_hold_sync)
    abort_mirror.test_partial_complete_then_abort_tombstones_last_acked_version(tmp_path)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def test_mirrors_hold_every_reference_scenario():
    """Each mirror carries every test of its reference file but the ones
    left out by name."""
    assert_mirror_whole("test_s3_api.py", s3_mirror, S3_LEFT_OUT, 31)
    assert_mirror_whole("test_sigv4_vectors.py", sigv4_mirror, (), 14)
    assert_mirror_whole("test_put_abort_race.py", abort_mirror, (), 2)


# --- cross checks: each package's client against the other's server ---------------

CROSS_BLOCK = 8192
DATA = random.Random(3)
BODIES = {
    "inline.txt": DATA.randbytes(700),
    "dir/multi.bin": DATA.randbytes(CROSS_BLOCK * 3 + 123),  # 4 blocks
    "dir/sub/deep.bin": DATA.randbytes(9000),
    "empty": b"",
}
PARTS = [DATA.randbytes(CROSS_BLOCK * 2 + 5), DATA.randbytes(3000)]


async def transcript(client) -> list:
    """One scripted S3 session through `client`: per step, the status and
    what a client reads back (ETags, bytes, parsed listings), without the
    fields that differ from run to run (dates, upload ids)."""
    out = []

    async def step(name, coro):
        try:
            out.append((name, "ok", await coro))
        except Exception as e:  # a client error: its status and S3 code
            out.append((name, "error", getattr(e, "status", None), getattr(e, "code", None)))

    await step("create", client.create_bucket("cross-bucket"))
    for k, body in BODIES.items():
        await step(f"put {k}", client.put_object("cross-bucket", k, body, "application/x-test",
                                                 metadata={"seed": "3"}))
    for k, body in BODIES.items():
        await step(f"get {k}", client.get_object("cross-bucket", k))
    await step("range", client.get_object("cross-bucket", "dir/multi.bin",
                                          range_=f"bytes={CROSS_BLOCK - 99}-{CROSS_BLOCK + 99}"))
    await step("suffix", client.get_object("cross-bucket", "dir/multi.bin", range_="bytes=-77"))

    async def head(k):
        h = await client.head_object("cross-bucket", k)
        return {f: h.get(f) for f in ("Content-Length", "ETag", "Content-Type",
                                      "x-amz-meta-seed")}

    await step("head", head("dir/multi.bin"))
    await step("list", client.list_objects_v2("cross-bucket"))
    await step("list delimiter", client.list_objects_v2("cross-bucket", delimiter="/"))
    await step("list prefix", client.list_objects_v2("cross-bucket", prefix="dir/", delimiter="/"))
    page = await client.list_objects_v2("cross-bucket", max_keys=2)
    out.append(("list page 1", page["keys"], page["truncated"]))
    page = await client.list_objects_v2("cross-bucket", max_keys=2,
                                        continuation_token=page["next_token"])
    out.append(("list page 2", page["keys"], page["truncated"]))

    async def list_v1():
        st, _h, data = await client._req("GET", "/cross-bucket", query=[("prefix", "dir/")])
        return st, re.findall(rb"<Key>([^<]*)</Key>", data), re.findall(rb"<ETag>([^<]*)<", data)

    await step("list v1", list_v1())

    async def multipart():
        uid = await client.create_multipart_upload("cross-bucket", "mpu.bin")
        etags = [await client.upload_part("cross-bucket", "mpu.bin", uid, i + 1, p)
                 for i, p in enumerate(PARTS)]
        parts = await client.list_parts("cross-bucket", "mpu.bin", uid)
        etag = await client.complete_multipart_upload(
            "cross-bucket", "mpu.bin", uid, list(enumerate(etags, 1)))
        return etags, parts, etag, await client.get_object("cross-bucket", "mpu.bin")

    await step("multipart", multipart())
    await step("copy", client.copy_object("cross-bucket", "inline.txt", "cross-bucket",
                                          "copy.txt"))
    await step("get copy", client.get_object("cross-bucket", "copy.txt"))
    await step("delete", client.delete_object("cross-bucket", "inline.txt"))
    await step("get deleted", client.get_object("cross-bucket", "inline.txt"))
    await step("no bucket", client.get_object("no-such-bucket", "x"))
    await step("list after", client.list_objects_v2("cross-bucket"))
    return out


def normalize(t: list) -> list:
    """The copy step returns a date-bearing result: keep its ETag only."""
    return [(s[0], s[1], {"etag": s[2].get("etag") if isinstance(s[2], dict) else None})
            if s[0] == "copy" and s[1] == "ok" else s for s in t]


async def session(make_daemon, client_cls, tmp_path) -> list:
    garage, s3, endpoint = await make_daemon(tmp_path, block_size=CROSS_BLOCK)
    try:
        key = await garage.helper.create_key("cross-key")
        key.params().allow_create_bucket.update(True)
        await garage.key_table.insert(key)
        client = client_cls(endpoint, key.key_id, key.secret())
        try:
            return normalize(await transcript(client))
        finally:
            await client.close()
    finally:
        await s3.stop()
        await garage.stop()


def test_cross_clients_and_servers_agree(tmp_path):
    """The reference's client on a port node and the port's client on a
    reference node read the same statuses, ETags, bytes and listings as
    the reference's client on a reference node."""
    runs = {}
    for name, daemon, client_cls in (
            ("reference", ref_s3.make_daemon, JS3Client),
            ("reference client, port server", s3_mirror.make_daemon, JS3Client),
            ("port client, reference server", ref_s3.make_daemon, S3Client),
            ("port", s3_mirror.make_daemon, S3Client)):
        runs[name] = run(session(daemon, client_cls, tmp_path / name.replace(" ", "_")))
    want = runs.pop("reference")
    assert len(want) == 25
    errors = [s for s in want if s[1] == "error"]
    assert [(s[0], s[2], s[3]) for s in errors] == [
        ("get deleted", 404, "NoSuchKey"), ("no bucket", 404, "NoSuchBucket")]
    mpu = next(s for s in want if s[0] == "multipart")[2]
    assert mpu[3] == b"".join(PARTS) and mpu[2].endswith("-2")
    for name, got in runs.items():
        assert got == want, name
