"""Two nodes that dial each other at once keep one link.

The port's `NetApp._install_conn` breaks the tie between a peer's open
connection and a new one dialed from the other end: both sides keep the
connection dialed by the lower node id and close the other after a
grace period, in which it takes the kept one's place if the peer closes
that first.  Held here:

  - two port NetApps dial each other at once, over 20 key pairs from a
    seed (both id orders occur), with each side's handshakes ending in
    three orders: both dials before both accepts, both accepts before
    both dials (each side then installs its two connections in the
    opposite order to the other, which is how a newest-wins rule loses
    the link), and as the event loop schedules them.  Once the displaced
    connection is reaped both sides hold the two ends of one socket, and
    a call goes each way;
  - the higher-id peer restarts under the same key and dials while the
    lower-id side still holds the old connection: the link is back
    within one peering redial;
  - a port node and a reference node dial each other at once, in the
    same three orders: the reference keeps the newest connection (no
    tie-break), so it may close the one the port kept; the port's other
    connection then takes its place, and the link never drops.
"""

import asyncio

import numpy as np
import pytest

from garage_tpu.net import NetApp as JNetApp
from garage_tpu.net import netapp as j_netapp_mod
from garage_tpu.net.message import Resp as JResp
from garage_tpu.net.peering import PeeringManager as JPeering
from garage_tpu_torch.net import NetApp
from garage_tpu_torch.net import netapp as netapp_mod
from garage_tpu_torch.net.handshake import node_id_of
from garage_tpu_torch.net.message import Resp
from garage_tpu_torch.net.peering import PeeringManager

NETKEY = b"d" * 32
PAIRS = 20
GRACE_S = 0.5  # the tie-break's grace here: two nodes on one idle event loop
REAP_S = GRACE_S + 3.0  # for a displaced connection to close on both ends
REDIAL_S = 5.0  # the peering ticks every second and redials a peer it lost at once


@pytest.fixture(autouse=True)
def _short_grace(monkeypatch):
    monkeypatch.setattr(netapp_mod, "TIE_GRACE_S", GRACE_S, raising=False)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def key_pair(seed: int) -> tuple[bytes, bytes]:
    rng = np.random.default_rng(seed)
    return rng.bytes(32), rng.bytes(32)


def ordered_keys(seed: int) -> tuple[bytes, bytes]:
    """Pair `seed`'s keys as (lower node id, higher node id)."""
    a, b = key_pair(seed)
    return (a, b) if node_id_of(a) < node_id_of(b) else (b, a)


async def node(key: bytes, cls=NetApp, resp=Resp):
    app = cls(NETKEY, key)
    await app.listen("127.0.0.1", 0)

    async def echo(from_id, req):
        return resp({"from": from_id, "body": req.body})

    app.endpoint("test/echo").set_handler(echo)
    return app


async def wait_for(pred, timeout: float, what: str) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        assert loop.time() < deadline, f"{what}: not reached in {timeout} s"
        await asyncio.sleep(0.02)


def one_socket(a, b) -> bool:
    """`a` and `b` each hold a connection to the other, and the two are
    the ends of one socket."""
    ca, cb = a.conns.get(b.id), b.conns.get(a.id)
    if ca is None or cb is None:
        return False
    ends = lambda c: (c.box.writer.get_extra_info("sockname"),  # noqa: E731
                      c.box.writer.get_extra_info("peername"))
    (a_local, a_remote), (b_local, b_remote) = ends(ca), ends(cb)
    return a_local == b_remote and a_remote == b_local


async def calls_both_ways(a, b) -> None:
    got = await a.endpoint("test/echo").call(b.id, "ab", timeout=10)
    assert got.body == {"from": a.id, "body": "ab"}
    got = await b.endpoint("test/echo").call(a.id, "ba", timeout=10)
    assert got.body == {"from": b.id, "body": "ba"}


def hold_handshakes(monkeypatch, side: str) -> tuple[asyncio.Event, list]:
    """Make every handshake of `side` ("server": the accepting end,
    "client": the dialing end), in both packages, wait for the returned
    event once it has succeeded; the returned list gets one entry as
    each goes on to install its connection."""
    gate, released = asyncio.Event(), []
    for mod in (netapp_mod, j_netapp_mod):

        async def held(*args, is_server: bool, _real=mod.handshake, **kw):
            box = await _real(*args, is_server=is_server, **kw)
            if is_server == (side == "server"):
                await gate.wait()
                released.append(box.peer_id)
            return box

        monkeypatch.setattr(mod, "handshake", held)
    return gate, released


ORDERS = ("dials_first", "accepts_first", "as_scheduled")


async def dial_at_once(a, b, order: str, monkeypatch) -> list[bytes]:
    """`a` and `b` dial each other at once; `order` (one of `ORDERS`)
    says which of each side's two handshakes ends first."""
    dials = lambda: asyncio.gather(a.connect(b.bind_addr, b.id),  # noqa: E731
                                   b.connect(a.bind_addr, a.id))
    if order == "as_scheduled":
        return await dials()
    gate, released = hold_handshakes(monkeypatch,
                                     "server" if order == "dials_first" else "client")
    if order == "dials_first":
        got = await dials()  # each side has installed its own dial
        gate.set()
        await wait_for(lambda: len(released) == 2, REAP_S, "both accepts installed")
        return got
    task = asyncio.ensure_future(dials())
    await wait_for(lambda: b.id in a.conns and a.id in b.conns, REAP_S,
                   "each side installed the other's dial")
    gate.set()
    return await task


def test_the_key_pairs_cover_both_id_orders():
    lower_first = [node_id_of(a) < node_id_of(b) for a, b in map(key_pair, range(PAIRS))]
    assert any(lower_first) and not all(lower_first)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("seed", range(PAIRS))
def test_simultaneous_dial_keeps_one_link(seed, order, monkeypatch):
    async def main():
        ka, kb = key_pair(seed)
        a, b = await node(ka), await node(kb)
        dropped = []
        a.on_disconnected = b.on_disconnected = dropped.append
        try:
            got = await dial_at_once(a, b, order, monkeypatch)
            assert got == [b.id, a.id]  # each dial returns the peer, whether it won or lost
            await wait_for(lambda: len(a.all_conns) <= 1 and len(b.all_conns) <= 1, REAP_S,
                           "the displaced connection reaped")
            assert a.is_connected(b.id) and b.is_connected(a.id), "the link was lost"
            assert one_socket(a, b), "the two sides kept different sockets"
            # the kept connection is the one the lower node id dialed
            low = a if a.id < b.id else b
            assert low.conns[(b if low is a else a).id].initiator
            await calls_both_ways(a, b)
            assert dropped == [], "a losing dial fired on_disconnected"
        finally:
            await a.shutdown()
            await b.shutdown()

    run(main())


@pytest.mark.parametrize("seed", range(3))
def test_higher_id_restart_relinks_within_one_redial(seed):
    """The higher-id peer comes back under its key and dials while the
    lower-id side still holds the connection it dialed to the old
    process: the new dial loses the tie-break, and the peering's redial,
    after the old process is gone, brings the link back."""

    async def main():
        k_low, k_high = ordered_keys(seed)
        low, old = await node(k_low), await node(k_high)
        await low.connect(old.bind_addr, old.id)  # the low side dialed the old process
        new = await node(k_high)
        peering = PeeringManager(new, [(low.id, low.bind_addr)])
        try:
            assert new.id == old.id
            assert await new.connect(low.bind_addr, low.id) == low.id
            # the low side keeps its own dial to the old process
            await wait_for(lambda: not new.all_conns, REAP_S, "the new dial closed")
            assert low.conns[old.id].initiator
            await old.shutdown()  # the old process goes away
            peering.start()
            await wait_for(lambda: one_socket(low, new), REDIAL_S, "the link back")
            await calls_both_ways(low, new)
        finally:
            await peering.stop()
            for app in (low, old, new):
                await app.shutdown()

    run(main())


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("seed", range(4))
def test_port_and_reference_dialing_at_once_keep_the_link(seed, order, monkeypatch):
    """The reference keeps the newest connection, with no tie-break
    (`garage_tpu/net/netapp.py`, a divergence kept on purpose): where it
    closes the connection the port kept, the port's other connection
    takes its place, and where it keeps that one the port closes it when
    its grace ends.  The peerings run, as in a cluster; neither side
    reports the peer down."""

    async def main():
        kp, kr = key_pair(seed)
        p, r = await node(kp), await node(kr, JNetApp, JResp)
        pp = PeeringManager(p, [(r.id, r.bind_addr)])
        rp = JPeering(r, [(p.id, p.bind_addr)])
        dropped = []
        for app in (p, r):  # the peering's own callback kept

            def on_disconnected(peer, _inner=app.on_disconnected):
                dropped.append(peer)
                _inner(peer)

            app.on_disconnected = on_disconnected
        try:
            await dial_at_once(p, r, order, monkeypatch)
            pp.start()
            rp.start()
            await wait_for(lambda: one_socket(p, r) and len(p.all_conns) == 1
                           and len(r.all_conns) == 1, REAP_S, "one link")
            await calls_both_ways(p, r)
            assert dropped == [], "the link dropped"
        finally:
            await pp.stop()
            await rp.stop()
            await p.shutdown()
            await r.shutdown()

    run(main())
