"""The port's observability plane held to the reference's own tests on
the CPU: tests/test_observability.py (histograms and quantiles, gauges,
a node's `/metrics` and its strict exposition lint, the tracer's
nesting and OTLP export, traceparent round trips, one trace across a
3-node cluster with per-attempt retry spans, allocation-free disabled
tracing, log stamping) runs on port nodes through `port_mirror`.

Left out: `test_metrics_exposition_tpu_families`, which asserts the
reference's jit-cache family (`cache="ec_apply"`) and its codec path
label (`path="tpu"`).  Its port version below runs the same encode and
reconstruct through the bridged codec and asserts everything else as
written, with the port's names in those two places: the dispatch-bucket
cache (`cache="ec_dispatch_bucket"`) and the device-type path label
(`path="cpu"`)."""

import asyncio

import aiohttp
import numpy as np
import torch

from torch_mirror import (ReferenceEcCodec, assert_mirror_whole, mirrored_tests, port_mirror,
                          refusing_skips, time_limit)

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

_limit = time_limit(120)  # a stuck test ends its worker instead of the suite

OBSERVABILITY_LEFT_OUT = ("test_metrics_exposition_tpu_families",)
observability_mirror = port_mirror("test_observability.py", OBSERVABILITY_LEFT_OUT)
globals().update(refusing_skips(mirrored_tests(observability_mirror, "observability")))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_observability.py", observability_mirror,
                        OBSERVABILITY_LEFT_OUT, 11)


def test_metrics_exposition_codec_families(tmp_path):
    """tests/test_observability.py::test_metrics_exposition_tpu_families
    on a port node: after one EC encode and one reconstruction of 8
    blocks on the codec's device path, `/metrics` carries the codec
    dispatch families on platform "cpu", the compile-cache families of
    the port's caches (both dispatches are whole buckets: hits; the
    erasure pattern's matrix is new: a miss), the platform gauge, and
    the codec layer's blocks under the device-type path label."""
    from garage_tpu_torch.api.admin.api_server import AdminApiServer
    from port_mirror_test_s3_api import make_daemon, teardown

    async def main():
        garage, s3, endpoint = await make_daemon(tmp_path)
        admin = AdminApiServer(garage)
        await admin.start("127.0.0.1", 0)
        try:
            codec = ReferenceEcCodec(2, 1, tpu_enable=True)
            rng = np.random.default_rng(0)
            blocks = [bytes(rng.integers(0, 256, 4096, dtype=np.uint8)) for _ in range(8)]
            out = codec.encode_batch(blocks)  # >= TPU_BATCH_MIN: the device path
            codec.reconstruct_batch([({0: o[0], 2: o[2]}, [1], 4096) for o in out])

            port = admin.runner.addresses[0][1]
            async with aiohttp.ClientSession() as sess:
                async with sess.get(f"http://127.0.0.1:{port}/metrics") as r:
                    assert r.status == 200
                    text = await r.text()
            assert 'tpu_codec_dispatch_total{kernel="ec_encode",platform="cpu"}' in text
            assert 'tpu_codec_dispatch_total{kernel="ec_reconstruct",platform="cpu"}' in text
            assert 'tpu_codec_batch_size_bucket{kernel="ec_encode",le="8"}' in text
            assert 'tpu_codec_batch_size_sum{kernel="ec_encode"}' in text
            assert 'tpu_codec_dispatch_duration_bucket{kernel="ec_encode",platform="cpu"' in text
            assert 'tpu_codec_bytes_total{kernel="ec_encode",platform="cpu"}' in text
            hits = next(ln for ln in text.splitlines()
                        if ln.startswith('tpu_compile_cache_hit_total{cache="ec_dispatch_bucket"}'))
            assert float(hits.rsplit(" ", 1)[1]) >= 2
            assert 'tpu_compile_cache_miss_total{cache="ec_recon_matrix"}' in text
            assert 'jax_backend_platform{platform="cpu"} 1' in text
            assert 'platform="unknown"' not in text
            line = next(ln for ln in text.splitlines()
                        if ln.startswith('block_codec_blocks_total{op="encode",path="cpu"}'))
            assert float(line.rsplit(" ", 1)[1]) >= 8
            assert 'block_codec_bytes_total{op="encode",path="cpu"}' in text
        finally:
            await admin.stop()
            await teardown(garage, s3)

    asyncio.run(main())
