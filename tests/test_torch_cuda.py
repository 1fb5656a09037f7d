"""Card-only tests of garage_tpu_torch: each hand-written kernel against
its plain PyTorch version on the card, bit-exact (tolerance 0: integer
math).  The kernels have no CPU mode, so every test here carries the
`cuda` marker and skips with a reason where there is no card.  This file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.ops import gf
from garage_tpu_torch.ops.blake3_ref import blake3
from garage_tpu_torch.ops.ec_cuda import (
    coding_state_from_numpy, encode_hash_tensor, gf_bitmatmul, gf_bitmatmul_cuda,
)
from garage_tpu_torch.ops.hash_cuda import blake3_batch, blake3_batch_ref

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _matrices(k: int, m: int, rng) -> list[np.ndarray]:
    """Encode, two repair patterns and one arbitrary 0/1 matrix, each
    (8m, 8k)."""
    lost = ([0, k - 1] + list(range(k, k + m)))[:m]
    keep = [i for i in range(k + m) if i not in lost]
    return [
        gf.bitmatrix_of(gf.cauchy_parity_matrix(k, m)),
        gf.bitmatrix_of(gf.reconstruction_matrix(k, m, keep, lost)),
        gf.bitmatrix_of(gf.reconstruction_matrix(k, m, list(range(m, k + m)), list(range(m)))),
        rng.integers(0, 2, (8 * m, 8 * k), dtype=np.uint8),
    ]


@pytest.mark.parametrize("k,m,s", [
    (4, 2, 128), (8, 3, 1024), (16, 4, 4096), (4, 2, 100), (8, 3, 4099),
    # 8-byte table entries (r > 4): one output group; two groups on the
    # byte path (S % 16 != 0); and a small q
    (6, 6, 4096), (12, 12, 1000), (2, 3, 4096),
])
def test_gf_kernel_matches_plain(dev, k, m, s):
    rng = np.random.default_rng(k * 1000 + s)
    x = torch.from_numpy(rng.integers(0, 256, (3, k, s), dtype=np.uint8)).to(dev)
    for bm_np in _matrices(k, m, rng):
        bm = torch.from_numpy(bm_np).to(dev)
        got = gf_bitmatmul_cuda(bm, x)
        assert torch.equal(got, gf_bitmatmul(bm, x))
        # strided output: the parity half of one (B, k+m, S) buffer
        buf = torch.zeros((3, k + m, s), dtype=torch.uint8, device=dev)
        buf[:, :k] = x
        gf_bitmatmul_cuda(bm, buf[:, :k], out=buf[:, k:])
        assert torch.equal(buf[:, k:], got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("length", [64, 512, 1024, 2048, 4096, 16384, 524288])
def test_blake3_kernel_matches_plain(dev, length):
    rng = np.random.default_rng(length)
    x_np = rng.integers(0, 256, (5, length), dtype=np.uint8)
    got = blake3_batch(torch.from_numpy(x_np).to(dev))
    assert torch.equal(got.cpu(), blake3_batch_ref(torch.from_numpy(x_np)))
    assert bytes(got[0].cpu().numpy()) == blake3(bytes(x_np[0]))


def test_fused_encode_hash_and_codec_on_card(dev):
    k, m, s = 8, 3, 4096
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (6, k, s), dtype=np.uint8)).to(dev)
    bm = coding_state_from_numpy(gf.cauchy_parity_matrix(k, m), dev)["bitmat"]
    g0, h0 = gf_bitmatmul_cuda.launches, blake3_batch.launches
    shards, hashes = encode_hash_tensor(bm, x)
    assert (gf_bitmatmul_cuda.launches, blake3_batch.launches) == (g0 + 1, h0 + 1)
    parity = gf_bitmatmul(bm, x)
    assert torch.equal(shards[:, k:], parity)
    plain = blake3_batch_ref(torch.cat([x, parity], 1).reshape(-1, s))
    assert torch.equal(hashes.reshape(-1, 32), plain)

    codec = EcCodec(k, m, device=dev)
    block = bytes(rng.integers(0, 256, k * s - 17, dtype=np.uint8))
    pieces = codec.encode(block)
    survivors = {i: p for i, p in enumerate(pieces) if i not in (1, 4, 9)}
    assert codec.decode(survivors, len(block)) == block
    assert codec.reconstruct_pieces(survivors, [9], len(block)) == {9: pieces[9]}


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    bm = torch.zeros((24, 64), dtype=torch.uint8, device=dev)
    x = torch.zeros((2, 8, 256), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        gf_bitmatmul_cuda(bm, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        gf_bitmatmul_cuda(bm[:, :32], x)
    flat = torch.zeros(64 * 3 + 8, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        blake3_batch(flat[8:].view(3, 64))  # base not 16-byte aligned
    with pytest.raises(ValueError):
        blake3_batch(torch.zeros((1, 3 * 1024), dtype=torch.uint8, device=dev))
