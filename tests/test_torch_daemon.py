"""The port's daemons as separate processes, booted and configured
through `python -m garage_tpu_torch.cli`, by the port's multi-process
harness (garage_tpu_torch/tools/daemons.py), on the CPU.

Three port daemons (EC(2,1), 64 KiB blocks, sqlite, `[tpu] enable =
false`): S3 on daemons 0 and 2, K2V on daemon 0, the website on daemon
1, the admin API on each.  The cluster is configured by CLI processes
only (`node id`, `node connect`, `layout assign`, `layout apply`, `key
new`, `bucket create`, `bucket allow`, `bucket website --allow`).
Checked: a multi-block S3 PUT through daemon 0 read back through daemon
2, a K2V insert and read, a website GET through daemon 1, admin
`/health` 200 on each daemon, codec dispatches on the CPU platform only,
and exit code 0 on SIGTERM.  Two interop checks: the port's CLI reads a
reference daemon's `status`, and the reference CLI reads a port
daemon's `status`.

Tolerance: zero for bytes.
"""

import asyncio
import random

import aiohttp
import torch

from garage_tpu_torch.api.s3.client import S3Client
from garage_tpu_torch.k2v_client import K2VClient
from garage_tpu_torch.tools.daemons import (
    METRICS_TOKEN, WEB_ROOT, Daemon, cli, configure, free_ports, kill_all,
    metric_samples, stop_all,
)
from torch_mirror import time_limit

torch.set_num_threads(1)  # one thread per suite worker

_limit = time_limit(110)

BUCKET = "daemons"
BLOCK = 65536


async def drive(daemons: list[Daemon], key_id: str, secret: str) -> dict:
    d0, d1, d2 = daemons
    rng = random.Random(61)
    big = rng.randbytes(5 * BLOCK - 1234)  # 5 blocks
    page = b"<html>" + rng.randbytes(3000) + b"</html>"
    out = {}
    c0 = S3Client(d0.url(d0.s3_port), key_id, secret)
    c2 = S3Client(d2.url(d2.s3_port), key_id, secret)
    k2v = K2VClient(d0.url(d0.k2v_port), BUCKET, key_id, secret)
    try:
        await c0.put_object(BUCKET, "big.bin", big)
        await c0.put_object(BUCKET, "index.html", page, "text/html")
        out["get"] = await c2.get_object(BUCKET, "big.bin") == big
        out["range"] = await c2.get_object(BUCKET, "big.bin",
                                           range_=f"bytes={BLOCK - 10}-{BLOCK + 9}") \
            == big[BLOCK - 10:BLOCK + 10]
        await k2v.insert_item("room", "m1", b"hello daemons")
        vals, tok = await k2v.read_item("room", "m1")
        out["k2v"] = vals == [b"hello daemons"] and bool(tok)
        async with aiohttp.ClientSession() as sess:
            async with sess.get(d1.url(d1.web_port) + "/",
                                headers={"Host": f"{BUCKET}.{WEB_ROOT}"}) as r:
                out["web"] = (r.status, await r.read() == page)
            out["health"] = []
            out["dispatch_platforms"] = set()
            for d in daemons:
                async with sess.get(d.url(d.admin_port) + "/health") as r:
                    out["health"].append(r.status)
                async with sess.get(d.url(d.admin_port) + "/metrics",
                                    headers={"Authorization": f"Bearer {METRICS_TOKEN}"}) as r:
                    text = await r.text()
                out["dispatch_platforms"] |= {
                    lbl["platform"] for lbl, v in metric_samples(text, "tpu_codec_dispatch_total")
                    if v > 0}
                out.setdefault("launches", []).extend(
                    metric_samples(text, "cuda_kernel_launches_total"))
    finally:
        await c0.close()
        await c2.close()
        await k2v.close()
    return out


def test_three_daemons_configured_by_the_cli(tmp_path):
    ports = free_ports(13)
    ec = {"mode": "ec:2:1", "block_size": BLOCK, "cpu": True}
    daemons = [
        Daemon(tmp_path, 0, ports[0], ports[1], s3_port=ports[2], k2v_port=ports[3], **ec),
        Daemon(tmp_path, 1, ports[4], ports[5], web_port=ports[6], **ec),
        Daemon(tmp_path, 2, ports[7], ports[8], s3_port=ports[9], **ec),
    ]
    # a reference daemon, a single-node cluster of its own, for the interop checks
    ref = Daemon(tmp_path / "ref", 0, ports[10], ports[11], mode=None,
                 module="garage_tpu.cli", cpu=True)
    try:
        for d in daemons + [ref]:
            d.start({"JAX_PLATFORMS": "cpu"})
        for d in daemons + [ref]:
            d.wait_up(60)
        key_id, secret = configure(daemons, BUCKET, website=True)
        got = asyncio.run(asyncio.wait_for(drive(daemons, key_id, secret), 60))
        assert got["get"] and got["range"], "S3 GET through daemon 2 differs from the PUT"
        assert got["k2v"]
        assert got["web"] == (200, True)
        assert got["health"] == [200, 200, 200]
        assert got["dispatch_platforms"] == {"cpu"}  # the codec ran, on the CPU only
        assert got["launches"] == []  # no kernel launched: no card was asked for
        # interop: each package's CLI reads the other package's daemon
        port_on_ref = cli(ref.config, "status")
        # daemon 0 was connected to every other daemon by `node connect`;
        # the others learn of each other by gossip, later
        ref_on_port = cli(daemons[0].config, "status", module="garage_tpu.cli")
        assert ref.node_id in port_on_ref and "==== NODE ====" in port_on_ref
        assert daemons[0].node_id in ref_on_port and "healthy" in ref_on_port
        assert stop_all(daemons + [ref], 30) == [0, 0, 0, 0]
    finally:
        kill_all(daemons + [ref])
    for d in daemons:
        assert "shutting down..." in d.log.read_text()
