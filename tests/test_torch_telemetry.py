"""The port's codec telemetry against the reference's on the CPU: the
same seeded inputs go through the reference's `EcTpu` / `EcCodec` (JAX
on the CPU) and the port's `EcCuda` / `EcCodec`, and the compile-cache
lookups (`tpu_compile_cache_{hit,miss}_total` for the caches both
packages keep: `ec_recon_matrix`, `ec_batch_bucket`,
`ec_dispatch_bucket`) and the shape-class compile events are counted on
each side.  Single-device and mesh dispatches, ragged and whole-bucket
batches, repeated and new erasure patterns, hashable and unhashable
shard lengths, and the block codec's routing by batch size.  The
port's codec is the reference's constructor through the mirror
harness's bridge (`torch_mirror.ReferenceEcCodec`).  The kernel build
cache's labels are held to the label set the reference's dashboard
lint allows.

Tolerance: zero (these are counts)."""

import os
import sys

import numpy as np
import pytest
import torch

from garage_tpu.block.codec.ec import EcCodec as JEcCodec
from garage_tpu.ops import telemetry as jtel
from garage_tpu.ops.ec_tpu import EcTpu
from garage_tpu.utils.metrics import registry as jregistry
from garage_tpu_torch.ops import _build
from garage_tpu_torch.ops import telemetry as ttel
from garage_tpu_torch.ops.ec_cuda import EcCuda
from garage_tpu_torch.utils.metrics import registry as tregistry
from torch_mirror import ReferenceEcCodec

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

CACHES = ("ec_recon_matrix", "ec_batch_bucket", "ec_dispatch_bucket")
KERNELS = ("ec_encode", "ec_reconstruct")


def counts(registry) -> dict:
    """The shared caches' hit/miss counters and the kernels' compile
    events, as one flat dict."""
    out = {}
    for cache in CACHES:
        for kind in ("hit", "miss"):
            out[f"{kind}:{cache}"] = registry.counters.get(
                (f"tpu_compile_cache_{kind}_total", (("cache", cache),)), 0)
    for kernel in KERNELS:
        out[f"compile:{kernel}"] = registry.durations.get(
            ("tpu_compile_duration", (("cache", kernel),)), (0, 0.0, None))[0]
    return out


def delta(registry, before: dict) -> dict:
    return {k: v - before[k] for k, v in counts(registry).items()}


def shards(rng, b, k, s):
    return rng.integers(0, 256, (b, k, s), dtype=np.uint8)


def drive_ec(ec, k, m, seed):
    """Encodes, fused encodes and reconstructions of one seed's batches."""
    rng = np.random.default_rng(seed)
    for b in (3, 4, 5, 8, 1, 3):  # ragged and whole buckets, repeated classes
        ec.encode(shards(rng, b, k, 256))
    for b, s in ((3, 1024), (8, 1024), (3, 96)):  # 96: no hashes, plain encode
        ec.encode_and_hash(shards(rng, b, k, s))
    data = shards(rng, 6, k, 256)
    full = np.concatenate([data, ec.encode(data)], axis=1)
    for lost in ([0], [1], [0], [k]):  # a repeated pattern hits
        present = [i for i in range(k + m) if i not in lost]
        ec.reconstruct(full[:, present], present, lost)


def run_both(make_ref, make_port, drive):
    jtel.reset_xray_state()
    ttel.reset_xray_state()
    jbefore, tbefore = counts(jregistry), counts(tregistry)
    drive(make_ref())
    jd = delta(jregistry, jbefore)
    jshapes = set(jtel._shape_seen)
    drive(make_port())
    td = delta(tregistry, tbefore)
    return jd, td, jshapes, set(ttel._shape_seen)


@pytest.mark.parametrize("n_devices", [1, 8], ids=["one-device", "mesh-8"])
@pytest.mark.parametrize("k,m", [(2, 1), (4, 2)])
def test_ec_cache_events_and_shape_classes_match_reference(k, m, n_devices):
    jd, td, jshapes, tshapes = run_both(
        lambda: EcTpu(k, m, n_devices=n_devices),
        lambda: EcCuda(k, m, device="cpu", n_devices=n_devices),
        lambda ec: drive_ec(ec, k, m, seed=10 * k + n_devices))
    assert td == jd
    assert tshapes == jshapes
    assert jd["miss:ec_recon_matrix"] == 3 and jd["hit:ec_recon_matrix"] == 1
    assert jd["compile:ec_encode"] >= 3  # the cold classes were counted at all


def drive_codec(codec, seed):
    """The block codec's batched calls at sizes on both sides of the
    reference's smallest device batch (8)."""
    rng = np.random.default_rng(seed)
    k, m = codec.k, codec.n_pieces - codec.k
    for n in (10, 3, 8, 17):
        blocks = [bytes(rng.integers(0, 256, 4096, dtype=np.uint8)) for _ in range(n)]
        pieces = codec.encode_batch(blocks)
        batches = [({i: p[i] for i in range(k + m) if i != j % k}, [j % k], 4096)
                   for j, p in enumerate(pieces)]
        codec.reconstruct_batch(batches)
        codec.decode_batch([(p, n_) for p, _w, n_ in batches], "xla")
        codec.encode_batch_hashed(blocks, "xla")
        codec.encode_batch_hashed(blocks, "auto")


@pytest.mark.parametrize("tpu_enable", [True, False])
def test_block_codec_cache_events_match_reference(tpu_enable):
    jd, td, jshapes, tshapes = run_both(
        lambda: JEcCodec(4, 2, tpu_enable=tpu_enable),
        lambda: ReferenceEcCodec(4, 2, tpu_enable=tpu_enable, platform="cpu"),
        lambda codec: drive_codec(codec, seed=5))
    assert td == jd
    assert tshapes == jshapes
    if tpu_enable:
        assert jd["miss:ec_recon_matrix"] > 0 and jd["hit:ec_batch_bucket"] > 0
    else:
        assert not any(jd.values()) and not jshapes  # the host codec only


def test_reset_xray_state_makes_every_class_cold_again():
    ec = EcCuda(2, 1, device="cpu")
    data = shards(np.random.default_rng(0), 3, 2, 256)
    key = ("tpu_compile_duration", (("cache", "ec_encode"),))
    ttel.reset_xray_state()
    n0 = tregistry.durations.get(key, (0, 0.0, None))[0]
    ec.encode(data)
    ec.encode(data)
    assert tregistry.durations[key][0] == n0 + 1
    assert ("ec_encode", 4) in ttel._shape_seen
    ttel.reset_xray_state()
    assert not ttel._shape_seen and not ttel._overlap_ewma
    ec.encode(data)
    assert tregistry.durations[key][0] == n0 + 2


def test_build_cache_labels_are_bounded_and_no_kernel_name():
    """Each kernel source's build events carry a `cache` label the
    reference's dashboard lint allows on `tpu_compile_duration`, and no
    dispatch's kernel name, so build and shape-class events stay apart."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "script"))
    import dashboard_lint

    assert set(_build.BUILD_CACHES) == set(_build.SIGNATURES)
    for source, label in _build.BUILD_CACHES.items():
        assert label in dashboard_lint._COMPILE_CACHES, (source, label)
        assert label not in dashboard_lint._CODEC_KERNELS, (source, label)


def test_cold_class_counted_once_across_threads(monkeypatch):
    """The batcher's lanes dispatch from two threads: however many
    threads dispatch a cold shape class at once, it is one compile
    event (200 classes, each raced by 16 threads)."""
    import threading

    from garage_tpu_torch.utils.metrics import Metrics

    r = Metrics()
    monkeypatch.setattr(ttel, "registry", r)
    monkeypatch.setattr(ttel, "_platforms_seen", set())
    ttel.reset_xray_state()
    start = threading.Barrier(16)

    def one():
        start.wait(timeout=10)
        for i in range(200):
            with ttel.dispatch("ec_encode", "cpu", 3, 0) as rec:
                rec.pad(3, 4 + i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert r.durations[("tpu_compile_duration", (("cache", "ec_encode"),))][0] == 200
    assert r.counters[("tpu_codec_dispatch_total",
                       (("kernel", "ec_encode"), ("platform", "cpu")))] == 16 * 200
    ttel.reset_xray_state()
