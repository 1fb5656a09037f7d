"""The port's K2V HTTP API (garage_tpu_torch/api/k2v) and its client
(garage_tpu_torch/k2v_client) held to the reference on the CPU.

  - the reference's K2V tests (tests/test_k2v.py) run on port nodes
    through `port_mirror`, `test_k2v_cli` through the port's
    `python -m garage_tpu_torch.k2v_client` entry point included;
  - both cross-client directions: on a reference K2V server and on a
    port one, the reference `K2VClient` and the port's take turns in one
    scripted session (inserts with and without causality tokens,
    concurrent values, batches, the index, a range poll, deletes by
    token and by prefix); after every step both clients read the same
    items and the same causality-token bytes, and each client writes
    with the tokens the other one read;
  - the session's transcript on the reference server equals the one on
    the port server (twin nodes with one node key), once each token is
    named by the order in which it first appeared (tokens carry
    wall-clock time stamps).

Tolerance: zero for values and token bytes.
"""

import asyncio
import random

import torch

from garage_tpu.api.k2v.api_server import K2VApiServer as JK2VApiServer
from garage_tpu.k2v_client import K2VClient as JK2VClient
from garage_tpu_torch.api.k2v.api_server import K2VApiServer
from garage_tpu_torch.k2v_client import K2VClient
from torch_mirror import mirrored_tests, port_mirror, time_limit, twin_node

torch.set_num_threads(1)  # one thread per suite worker

_limit = time_limit(90)

k2v_mirror = port_mirror("test_k2v.py")
globals().update(mirrored_tests(k2v_mirror, "k2v"))


def test_mirror_holds_every_reference_scenario():
    from torch_mirror import assert_mirror_whole

    assert_mirror_whole("test_k2v.py", k2v_mirror, (), 14)
    assert "garage_tpu_torch.k2v_client.__main__" in k2v_mirror.mirror_source


# --- cross clients ------------------------------------------------------------------

KEY_ID, SECRET = "GK" + "5c" * 12, "6d" * 32
DATA = random.Random(31)
BATCH = [("room", f"b{i:02d}", DATA.randbytes(DATA.randrange(1, 200))) for i in range(16)]


async def k2v_server(pkg: str, root, node_key: bytes):
    from importlib import import_module

    garage, adm = await twin_node(pkg, root, node_key)
    Req = import_module(f"{pkg}.net.message").Req
    for op, args in (("key-import", {"key_id": KEY_ID, "secret": SECRET, "name": "k2v"}),
                     ("bucket-create", {"name": "k2v-bucket"}),
                     ("bucket-allow", {"bucket": "k2v-bucket", "key": KEY_ID, "read": True,
                                       "write": True, "owner": True})):
        await adm._handle(b"\x00" * 32, Req([op, args]))
    server = (JK2VApiServer if pkg == "garage_tpu" else K2VApiServer)(garage)
    await server.start("127.0.0.1", 0)
    return garage, server, f"http://127.0.0.1:{server.runner.addresses[0][1]}"


async def session(endpoint: str) -> list:
    """The scripted session: `a` is the reference client, `b` the
    port's.  Every read is made by both, and must agree to the byte."""
    a = JK2VClient(endpoint, "k2v-bucket", KEY_ID, SECRET)
    b = K2VClient(endpoint, "k2v-bucket", KEY_ID, SECRET)
    out = []

    async def both(name, read):
        ra, rb = await read(a), await read(b)
        assert ra == rb, name
        out.append((name, ra))
        return ra

    try:
        await a.insert_item("room", "m1", b"first")
        _vals, tok = await both("read m1", lambda c: c.read_item("room", "m1"))
        await b.insert_item("room", "m1", b"second", token=tok)  # a's token, b writes
        await a.insert_item("room", "m1", b"concurrent")  # no token: a sibling value
        _vals, tok = await both("read m1 siblings", lambda c: c.read_item("room", "m1"))
        await b.insert_batch([(pk, sk, v, None) for pk, sk, v in BATCH])
        await both("batch", lambda c: c.read_batch([{"partitionKey": "room", "prefix": "b"},
                                                     {"partitionKey": "room", "start": "b10",
                                                      "limit": 3, "reverse": True}]))
        for _ in range(200):  # the index counters land through a worker
            idx = await a.read_index()
            if idx["partitionKeys"] and idx["partitionKeys"][0].get("entries") == 17:
                break
            await asyncio.sleep(0.05)
        await both("index", lambda c: c.read_index())
        await both("poll range", lambda c: c.poll_range("room", prefix="b0", timeout=1))
        await a.delete_item("room", "m1", tok)  # b's read token, a deletes
        await both("deleted batch", lambda c: c.read_batch([{"partitionKey": "room",
                                                             "tombstones": True}]))
        await b.delete_batch([{"partitionKey": "room", "prefix": "b0"}])
        await both("after prefix delete", lambda c: c.read_batch([{"partitionKey": "room"}]))
        return out
    finally:
        await a.close()
        await b.close()


def tokens_named(doc, names: dict):
    """`doc` with each causality token or seen marker replaced by its
    order of first appearance."""
    if isinstance(doc, dict):
        return {k: _name(v, names) if k in ("ct", "seenMarker") else tokens_named(v, names)
                for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        if len(doc) == 2 and isinstance(doc[1], str) and isinstance(doc[0], (list, dict)):
            # (values, token) of a read, (items, seen marker) of a poll
            return [tokens_named(doc[0], names), _name(doc[1], names)]
        return [tokens_named(v, names) for v in doc]
    return doc


def _name(tok, names):
    return names.setdefault(tok, f"<token {len(names)}>") if tok else tok


async def cross(pkg: str, root, node_key: bytes) -> list:
    garage, server, endpoint = await k2v_server(pkg, root, node_key)
    try:
        return await session(endpoint)
    finally:
        await server.stop()
        await garage.stop()


def test_cross_clients_read_the_same_items_and_tokens(tmp_path):
    node_key = random.Random(41).randbytes(32)
    run = lambda c: asyncio.run(asyncio.wait_for(c, 60))  # noqa: E731
    ref = run(cross("garage_tpu", tmp_path, node_key))
    port = run(cross("garage_tpu_torch", tmp_path, node_key))
    assert tokens_named(port, {}) == tokens_named(ref, {})
    steps = dict((name, r) for name, r in port)
    assert sorted(steps["read m1 siblings"][0]) == [b"concurrent", b"second"]
    assert len(steps["batch"][0]["items"]) == 16
    assert all(i["v"] == [None] for i in steps["deleted batch"][0]["items"] if i["sk"] == "m1")
    assert [i["sk"] for i in steps["after prefix delete"][0]["items"]] == \
        [sk for _pk, sk, _v in BATCH if not sk.startswith("b0")]
