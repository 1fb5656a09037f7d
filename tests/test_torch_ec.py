"""garage_tpu_torch `EcCuda` on the CPU against the JAX package's `EcTpu`
(platform cpu, one device): encode, fused encode + hash, and
reconstruct, with ragged batches so pad rows are sliced off; plus the
batch bucketing and telemetry helpers it sits on.  Exact comparisons."""

import numpy as np
import pytest
import torch

from garage_tpu.ops import bucketing as jbucket
from garage_tpu.ops import gf as jgf
from garage_tpu.ops import telemetry as jtel
from garage_tpu.ops.ec_tpu import EcTpu
from garage_tpu_torch.ops import bucketing as tbucket
from garage_tpu_torch.ops import telemetry as ttel
from garage_tpu_torch.ops.ec_cuda import EcCuda

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)


@pytest.mark.parametrize("b", [1, 3, 5])
@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_ec_cuda_matches_ec_tpu(k, m, b):
    rng = np.random.default_rng(10 * k + b)
    s = 256
    data = rng.integers(0, 256, (b, k, s), dtype=np.uint8)
    port = EcCuda(k, m, device="cpu")
    ref = EcTpu(k, m, platform="cpu", n_devices=1)

    parity = port.encode(data)
    assert parity.shape == (b, m, s)
    assert np.array_equal(parity, ref.encode(data))
    assert np.array_equal(parity, jgf.encode_blocks_ref(data, k, m))

    p2, hashes = port.encode_and_hash(data)
    rp2, rhashes = ref.encode_and_hash(data)
    assert np.array_equal(p2, rp2)
    assert hashes is not None and hashes.shape == (b, k + m, 32)
    assert np.array_equal(hashes, rhashes)

    shards = np.concatenate([data, parity], axis=1)
    for lost in (list(range(m)), [1, k, k + m - 1][:m]):
        present = [i for i in range(k + m) if i not in lost]
        rec = port.reconstruct(shards[:, present], present, lost)
        assert np.array_equal(rec, ref.reconstruct(shards[:, present], present, lost))
        assert np.array_equal(rec, shards[:, lost])


def test_encode_and_hash_unsupported_len_returns_no_hashes():
    k, m, s = 4, 2, 3 * 1024  # three chunks: not a power of two
    data = np.random.default_rng(1).integers(0, 256, (3, k, s), dtype=np.uint8)
    parity, hashes = EcCuda(k, m, device="cpu").encode_and_hash(data)
    rparity, rhashes = EcTpu(k, m, platform="cpu", n_devices=1).encode_and_hash(data)
    assert hashes is None and rhashes is None
    assert np.array_equal(parity, rparity)


def test_reconstruct_caches_one_matrix_per_pattern():
    k, m = 4, 2
    ec = EcCuda(k, m, device="cpu")
    data = np.random.default_rng(2).integers(0, 256, (2, k, 128), dtype=np.uint8)
    shards = np.concatenate([data, ec.encode(data)], axis=1)
    present = [1, 2, 3, 4, 5]
    for _ in range(3):
        ec.reconstruct(shards[:, present], present, [0])
    assert list(ec._recon_cache) == [((1, 2, 3, 4), (0,))]


@pytest.mark.parametrize("shape", [(2, 3, 128), (2, 4), (2, 4, 128)])
def test_ec_cuda_rejects_bad_batches(shape):
    data = np.zeros(shape, dtype=np.uint8 if len(shape) != 3 or shape[1] != 4 else np.int32)
    with pytest.raises(ValueError):
        EcCuda(4, 2, device="cpu").encode(data)


def test_bucketing_matches_reference():
    for b in range(0, 200):
        assert tbucket.bucket_batch(b) == jbucket.bucket_batch(b)
    x = np.arange(3 * 2 * 5, dtype=np.uint8).reshape(3, 2, 5)
    for b_padded in (3, 4, 8):
        got = tbucket.pad_to_bucket(torch.from_numpy(x), b_padded).numpy()
        assert np.array_equal(got, jbucket.pad_to_bucket(x, b_padded))


@pytest.mark.parametrize("platform", [None, "", "unknown", "cpu", "cuda", "tpu"])
def test_backend_gate_matches_reference(platform):
    assert ttel.is_host_platform(platform) == jtel.is_host_platform(platform)


def test_telemetry_platform_and_snapshot_keys():
    assert ttel.resolved_platform(torch.zeros(1)) == "cpu"
    assert ttel.resolved_platform(torch.device("cpu")) == "cpu"
    assert ttel.resolved_platform("cuda") == "cuda"
    assert ttel.resolved_platform(None) == "unknown"
    data = np.zeros((3, 4, 128), dtype=np.uint8)
    EcCuda(4, 2, device="cpu").encode_and_hash(data)
    snap = ttel.codec_snapshot()
    assert set(snap) == set(jtel.codec_snapshot())
    assert "cpu" in snap["platforms"]
    k = snap["kernels"]["ec_encode_hash"]
    assert k["requested"] >= 3 and k["padded"] >= 4
