"""The port's network layer (garage_tpu_torch/net) speaks the
reference's wire protocol: a port NetApp and a reference NetApp
handshake and answer an RPC that carries an attached stream each way,
in both directions, and a port-only pair does the same."""

import asyncio
import os
from types import SimpleNamespace

import pytest

from garage_tpu.net import NetApp as JNetApp
from garage_tpu.net.handshake import VERSION_TAG as J_TAG
from garage_tpu.net.handshake import gen_node_key as j_key
from garage_tpu.net.message import Resp as JResp
from garage_tpu.net.stream import bytes_stream as j_stream
from garage_tpu.net.stream import read_stream_to_end as j_read
from garage_tpu_torch.net import NetApp as TNetApp
from garage_tpu_torch.net.handshake import VERSION_TAG as T_TAG
from garage_tpu_torch.net.handshake import gen_node_key as t_key
from garage_tpu_torch.net.message import Resp as TResp
from garage_tpu_torch.net.stream import bytes_stream as t_stream
from garage_tpu_torch.net.stream import read_stream_to_end as t_read

NETKEY = b"n" * 32
SIDES = {  # each package's NetApp, key generator, Resp, stream writer and reader
    "ref": SimpleNamespace(app=JNetApp, key=j_key, resp=JResp, stream=j_stream, read=j_read),
    "port": SimpleNamespace(app=TNetApp, key=t_key, resp=TResp, stream=t_stream, read=t_read),
}


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def node(side):
    app = SIDES[side].app(NETKEY, SIDES[side].key())
    await app.listen("127.0.0.1", 0)
    return app


def test_same_protocol_tag():
    assert T_TAG == J_TAG


@pytest.mark.parametrize("caller,server", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_rpc_with_stream_across_packages(caller, server):
    async def main():
        a, b = await node(caller), await node(server)
        cli, srv = SIDES[caller], SIDES[server]
        blob = os.urandom(300 * 1024)  # several stream chunks
        seen = []

        async def handler(from_id, req):
            seen.append(from_id)
            got = await srv.read(req.stream)
            return srv.resp({"body": req.body, "stream_len": len(got)},
                            stream=srv.stream(got[::-1]))

        b.endpoint("test/stream").set_handler(handler)
        try:
            assert await a.connect(b.bind_addr, b.id) == b.id
            body = {"n": 41, "raw": b"\x00\xff" * 1000, "list": [1, "two", None, 3.5]}
            resp = await a.endpoint("test/stream").call(
                b.id, body, stream=cli.stream(blob), timeout=30)
            assert resp.body == {"body": body, "stream_len": len(blob)}
            assert await cli.read(resp.stream) == blob[::-1]
            assert seen == [a.id]
        finally:
            await a.shutdown()
            await b.shutdown()

    run(main())


def test_wrong_network_key_is_refused():
    async def main():
        a = TNetApp(b"x" * 32, t_key())
        b = await node("ref")
        try:
            with pytest.raises(Exception):
                await a.connect(b.bind_addr, b.id)
        finally:
            await a.shutdown()
            await b.shutdown()

    run(main())


def test_shutdown_returns_when_a_peer_dials_while_it_closes(monkeypatch):
    """Shutdown stops accepting before it closes connections: a peer that
    dials while the first connection is closing is refused, instead of
    being accepted, left open, and holding `Server.wait_closed` forever."""
    from garage_tpu_torch.net.connection import Connection

    async def main():
        a, b, c = await node("port"), await node("port"), await node("port")
        await b.connect(a.bind_addr, a.id)
        real_close = Connection.close
        dials = []

        async def slow_close(self):
            if not dials:  # the first close gives a peer time to dial in
                dials.append(asyncio.create_task(c.connect(a.bind_addr, a.id)))
                await asyncio.sleep(0.3)
            await real_close(self)

        monkeypatch.setattr(Connection, "close", slow_close)
        try:
            await asyncio.wait_for(a.shutdown(), 15)
            (late,) = await asyncio.gather(*dials, return_exceptions=True)
            assert isinstance(late, OSError), late
            assert not a.all_conns
        finally:
            monkeypatch.setattr(Connection, "close", real_close)
            await b.shutdown()
            await c.shutdown()

    run(main())
