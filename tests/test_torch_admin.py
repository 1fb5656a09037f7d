"""The port's admin HTTP API (garage_tpu_torch/api/admin) and the planes
it serves, held to the reference on the CPU.

  - the reference's overload-plane tests (tests/test_overload.py), its
    flight-recorder tests (tests/test_flight.py) and its latency X-ray
    tests (tests/test_latency_xray.py) run on port nodes through
    `port_mirror`, each node asking for the CPU.  None is left out; two
    run in tests/test_torch_left_out_mirror.py under a time limit of
    their own (`torch_mirror.RUN_APART`):
    `test_debug_profile_endpoint_captures_hot_function`, a 2 s sampling
    profile of a live node, and `test_ec83_cluster_xray_acceptance`, an
    11-node cluster.  The overload file's 11-node burst is marked slow,
    as on the reference;
  - the admin API's `/v1/...` JSON from a reference node and a port node
    with the same node key and the same imported key is equal once the
    random bucket id, the node's directories, the permissions' time
    stamps and the shedding ladder's live readings are masked;
  - the canary sets up again after a probe is refused (403), which the
    reference's does not.

Tolerance: zero.
"""

import asyncio
import copy
import random
from contextlib import contextmanager
from importlib import import_module

import aiohttp
import torch

from torch_mirror import differences, masked, mirrored_tests, port_mirror, time_limit, twin_node

torch.set_num_threads(1)  # one thread per suite worker

_limit = time_limit(90)

overload_mirror = port_mirror("test_overload.py")
globals().update(mirrored_tests(overload_mirror, "overload"))
flight_mirror = port_mirror("test_flight.py")
globals().update(mirrored_tests(flight_mirror, "flight"))
xray_mirror = port_mirror("test_latency_xray.py")
globals().update(mirrored_tests(xray_mirror, "latency_xray"))


def test_mirrors_hold_every_reference_scenario():
    from torch_mirror import assert_mirror_whole

    assert_mirror_whole("test_overload.py", overload_mirror, (), 19)
    assert_mirror_whole("test_flight.py", flight_mirror, (), 6)
    assert_mirror_whole("test_latency_xray.py", xray_mirror, (), 9)


# --- the admin API's JSON from twin nodes -------------------------------------------

KEY_ID, SECRET = "GK" + "3a" * 12, "4b" * 32
TOKEN = "twin-admin-token"


async def admin_documents(pkg: str, root, node_key: bytes) -> tuple[dict, str]:
    """Every read-only `/v1` document of a fresh node of `pkg` after one
    key import, one bucket create and one allow through the same API."""
    garage, _adm = await twin_node(pkg, root, node_key)
    garage.config.admin.admin_token = TOKEN
    api = import_module(f"{pkg}.api.admin.api_server").AdminApiServer(garage)
    await api.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{api.runner.addresses[0][1]}"
    out = {}
    try:
        async with aiohttp.ClientSession(
                headers={"Authorization": f"Bearer {TOKEN}"}) as sess:

            async def req(method, path, **kw):
                async with sess.request(method, base + path, **kw) as r:
                    out[f"{method} {path}"] = (r.status, await r.json())
                    return out[f"{method} {path}"][1]

            await req("POST", "/v1/key/import",
                      json={"accessKeyId": KEY_ID, "secretAccessKey": SECRET, "name": "twin"})
            bucket = (await req("POST", "/v1/bucket", json={"globalAlias": "twin-bucket"}))["id"]
            await req("POST", "/v1/bucket/allow",
                      json={"bucketId": bucket, "accessKeyId": KEY_ID,
                            "permissions": {"read": True, "write": True, "owner": False}})
            for path in ("/v1/status", "/v1/health", "/v1/node", "/v1/layout", "/v1/bucket",
                         f"/v1/bucket?id={bucket}", "/v1/bucket?globalAlias=twin-bucket",
                         "/v1/key", f"/v1/key?id={KEY_ID}", "/v1/key?search=twin",
                         "/v1/overload", "/v1/repair/plan"):
                await req("GET", path)
            async with sess.get(base + "/health") as r:
                out["GET /health"] = (r.status, await r.text())
            async with aiohttp.ClientSession() as anon:  # no token: refused
                async with anon.get(base + "/v1/status") as r:
                    out["GET /v1/status, no token"] = r.status
        return out, bucket
    finally:
        await api.stop()
        await garage.stop()


def perm_times_masked(doc):
    """`doc` with the time stamp of each key's bucket permission (the
    first item of its `permissions` list) masked."""
    if isinstance(doc, dict):
        return {k: ["<time>", *v[1:]] if k == "permissions" and isinstance(v, list)
                else perm_times_masked(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [perm_times_masked(v) for v in doc]
    return doc


def test_admin_api_json_equals_the_reference(tmp_path):
    node_key = random.Random(21).randbytes(32)
    run = lambda c: asyncio.run(asyncio.wait_for(c, 60))  # noqa: E731
    ref, ref_bucket = run(admin_documents("garage_tpu", tmp_path, node_key))
    port, port_bucket = run(admin_documents("garage_tpu_torch", tmp_path, node_key))
    assert port["GET /v1/status"][1]["node"] == ref["GET /v1/status"][1]["node"]
    assert port["GET /v1/status, no token"] == 403
    # the shedding ladder's live readings (loop lag, burn rate, the time
    # since its last step) follow the host's load, not the code
    live = frozenset({"loopLagP99Ms", "burnRate", "lastChangeAgoSecs"})
    subst = lambda pkg, b: {b: "<bucket>", str(tmp_path / pkg): "<dir>"}  # noqa: E731
    assert not differences(
        perm_times_masked(masked(port, subst("garage_tpu_torch", port_bucket), live)),
        perm_times_masked(masked(ref, subst("garage_tpu", ref_bucket), live)))
    assert {v[0] for v in port.values() if isinstance(v, tuple)} == {200}


# --- the canary after its bucket's alias moves ----------------------------------------


@contextmanager
def registry_kept(pkg: str):
    """`pkg`'s process-wide metrics registry put back as it was: the
    failed probes of a scenario must not count in a later test's
    digest (the canary block reads the registry's probe histogram)."""
    reg = import_module(f"{pkg}.utils.metrics").registry
    counters, durations = copy.deepcopy(dict(reg.counters)), copy.deepcopy(reg.durations)
    try:
        yield
    finally:
        reg.counters.clear()
        reg.counters.update(counters)
        reg.durations.clear()
        reg.durations.update(durations)


async def canary_health_after_alias_moves(pkg: str, root, node_key: bytes) -> list[float]:
    """A canary's health over three probe cycles on one node of `pkg`: one
    probe, then the hidden bucket's alias moved to a new bucket (what two
    S3 nodes creating the bucket at once leave behind for the one whose
    bucket lost the alias), then two more."""
    garage, _adm = await twin_node(pkg, root, node_key)
    s3 = import_module(f"{pkg}.api.s3.api_server").S3ApiServer(garage)
    await s3.start("127.0.0.1", 0)
    w = import_module(f"{pkg}.api.s3.canary").CanaryWorker(
        garage, f"http://127.0.0.1:{s3.runner.addresses[0][1]}")
    w.object_bytes = 4096
    health = []
    try:
        await w.work()
        health.append(w.healthy)
        h = garage.helper
        old = await h.resolve_bucket(w.bucket)
        await h.set_global_alias(old, "canary-old")
        await h.unset_global_alias(old, w.bucket)
        await h.create_bucket(w.bucket)
        for _ in range(2):
            await w.work()
            health.append(w.healthy)
        return health
    finally:
        await w.stop_client()
        await s3.stop()
        await garage.stop()


def test_canary_sets_up_again_when_access_is_denied(tmp_path):
    """A probe answered 403 (the canary's grant names another bucket than
    the alias does now) makes the canary set up again: the next cycle
    grants on the bucket the alias names, and probes pass.  The
    reference's canary keeps its stale client and fails every cycle (F5
    in ROADMAP queue 3)."""
    node_key = random.Random(51).randbytes(32)
    run = lambda c: asyncio.run(asyncio.wait_for(c, 60))  # noqa: E731
    with registry_kept("garage_tpu_torch"):
        assert run(canary_health_after_alias_moves("garage_tpu_torch", tmp_path / "port",
                                                   node_key)) == [1.0, 0.0, 1.0]
    with registry_kept("garage_tpu"):
        assert run(canary_health_after_alias_moves("garage_tpu", tmp_path / "ref",
                                                   node_key)) == [1.0, 0.0, 0.0]
