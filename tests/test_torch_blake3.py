"""garage_tpu_torch batched BLAKE3 against the JAX package: the plain
version (what `blake3_batch` runs for a CPU tensor) against
`garage_tpu.ops.hash_tpu.blake3_batch` and the pure-Python oracle, the
same rejected lengths, and the same `blake3_supported_len`; and
`blake3_pieces` (the hashes of every data and parity piece of a batch,
read where the pieces lie) against the reference's hash of their
concatenation."""

import numpy as np
import pytest
import torch

from garage_tpu.ops import blake3_ref as jref
from garage_tpu.ops.ec_tpu import blake3_supported_len as jax_supported
from garage_tpu.ops.hash_tpu import blake3_batch as jax_blake3_batch
from garage_tpu_torch.ops import blake3_ref as tref
from garage_tpu_torch.ops.ec_cuda import blake3_supported_len
from garage_tpu_torch.ops.hash_cuda import (
    blake3_batch, blake3_batch_ref, blake3_pieces, n_chunks_for_len,
)

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)


@pytest.mark.parametrize("length", [64, 512, 1024, 2048, 4096, 16384])
def test_blake3_batch_matches_reference(length):
    rng = np.random.default_rng(length)
    x = rng.integers(0, 256, (4, length), dtype=np.uint8)
    port = blake3_batch(torch.from_numpy(x)).numpy()
    assert port.shape == (4, 32) and port.dtype == np.uint8
    assert np.array_equal(port, jax_blake3_batch(x))
    for i in range(4):
        assert bytes(port[i]) == jref.blake3(bytes(x[i])), f"row {i}"


@pytest.mark.parametrize("length", [0, 63, 96, 1024 + 64, 3 * 1024])
def test_blake3_batch_rejects_what_the_reference_rejects(length):
    x = np.zeros((1, length), dtype=np.uint8)
    with pytest.raises(ValueError):
        jax_blake3_batch(x)
    with pytest.raises(ValueError):
        blake3_batch(torch.from_numpy(x))
    with pytest.raises(ValueError):
        blake3_batch_ref(torch.from_numpy(x))


def test_supported_len_parity():
    for s in list(range(0, 70001, 64)) + [96]:
        want = jax_supported(s)
        assert blake3_supported_len(s) == want, s
        try:
            n_chunks_for_len(s)
            accepted = True
        except ValueError:
            accepted = False
        assert accepted == want, s


@pytest.mark.parametrize("n", [0, 1, 64, 1023, 1024, 1025, 5000])
def test_pure_python_oracle_copy_matches_reference(n):
    data = bytes(i % 251 for i in range(n))
    assert tref.blake3(data) == jref.blake3(data)
    assert tref.blake3(data, out_len=64) == jref.blake3(data, out_len=64)


def test_blake3_batch_empty_batch():
    assert blake3_batch(torch.zeros((0, 2048), dtype=torch.uint8)).shape == (0, 32)


@pytest.mark.parametrize("b,k,m,s", [(3, 4, 2, 1024), (2, 8, 3, 2048), (1, 2, 1, 64), (0, 2, 1, 64)])
def test_blake3_pieces_matches_reference(b, k, m, s):
    rng = np.random.default_rng(b * 100 + s)
    buf = rng.integers(0, 256, (b, k + m + 1, s), dtype=np.uint8)
    data, parity = buf[:, 1:k + 1], buf[:, k + 1:]  # strided views of one buffer
    got = blake3_pieces(torch.from_numpy(data), torch.from_numpy(parity)).numpy()
    assert got.shape == (b, k + m, 32)
    want = jax_blake3_batch(np.concatenate([data, parity], 1).reshape(-1, s)) if b else \
        np.zeros((0, 32), np.uint8)
    assert np.array_equal(got.reshape(-1, 32), want)


@pytest.mark.parametrize("data,parity", [
    ((2, 4, 1024), (3, 2, 1024)), ((2, 4, 1024), (2, 2, 2048)), ((2, 4, 96), (2, 2, 96)),
    ((2, 1024), (2, 1024)),
])
def test_blake3_pieces_rejects_mismatched_sources(data, parity):
    with pytest.raises(ValueError):
        blake3_pieces(torch.zeros(data, dtype=torch.uint8), torch.zeros(parity, dtype=torch.uint8))
