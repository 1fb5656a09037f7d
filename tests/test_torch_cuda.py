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
from garage_tpu_torch.models.pipeline import ScrubRepairPipeline
from garage_tpu_torch.ops import gf
from garage_tpu_torch.ops._build import launch_count
from garage_tpu_torch.ops.blake3_ref import blake3
from garage_tpu_torch.ops.ec_cuda import (
    EcCuda, coding_state_from_numpy, encode_hash_tensor, gf_bitmatmul, gf_bitmatmul_cuda,
)
from garage_tpu_torch.ops.hash_cuda import (
    blake3_batch, blake3_batch_ref, blake3_pieces, blake3_pieces_ref,
)
from garage_tpu_torch.parallel.mesh import make_mesh
from garage_tpu_torch.tools import sanitize_cuda, verify

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


# (rows, chunks per row): one row; rows of 2, 4 and 32 chunks (several
# rows per warp, and one warp-sized subtree per row) with row counts that
# leave the last warp partly empty; the main path's 704 x 128 chunks; 1 MiB
# rows (1024 chunks: 32 subtrees per row, finished by the last warp) and
# 2 MiB rows (64 subtrees: the in-place reduction of groups of 32)
@pytest.mark.parametrize("rows,chunks", [
    (1, 2), (1, 128), (17, 2), (9, 4), (3, 32), (5, 32), (704, 128), (3, 1024), (2, 2048),
])
def test_blake3_warp_kernel_shapes(dev, rows, chunks):
    rng = np.random.default_rng(rows * 10_000 + chunks)
    x = torch.from_numpy(rng.integers(0, 256, (rows, chunks * 1024), dtype=np.uint8)).to(dev)
    h0 = launch_count(blake3_batch)
    got = blake3_batch(x)
    assert launch_count(blake3_batch) == h0 + 1
    assert torch.equal(got, blake3_batch_ref(x))
    got_np, x_np = got.cpu().numpy(), x.cpu().numpy()
    for i in sorted({0, rows - 1}):
        assert bytes(got_np[i]) == blake3(bytes(x_np[i])), f"row {i}"


@pytest.mark.parametrize("b,k,m,s", [(3, 8, 3, 4096), (2, 4, 2, 131072), (5, 8, 3, 1024),
                                     (2, 2, 1, 1 << 20)])
def test_blake3_pieces_reads_strided_views(dev, b, k, m, s):
    """Data and parity as strided views of one buffer with a spare piece
    between them, and as separate tensors: one launch, the digests of the
    concatenation in piece order."""
    rng = np.random.default_rng(b * s + k)
    buf = torch.from_numpy(rng.integers(0, 256, (b, k + m + 1, s), dtype=np.uint8)).to(dev)
    data, parity = buf[:, :k], buf[:, k + 1:]
    want = blake3_pieces_ref(data, parity)
    for d, p in ((data, parity), (data.contiguous(), parity.contiguous())):
        h0 = launch_count(blake3_batch)
        got = blake3_pieces(d, p)
        assert launch_count(blake3_batch) == h0 + 1
        assert torch.equal(got, want)
    last = bytes(parity[-1, -1].cpu().numpy())
    assert bytes(got[-1, -1].cpu().numpy()) == blake3(last)


def test_fused_encode_hash_and_codec_on_card(dev):
    k, m, s = 8, 3, 4096
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (6, k, s), dtype=np.uint8)).to(dev)
    bm = coding_state_from_numpy(gf.cauchy_parity_matrix(k, m), dev)["bitmat"]
    g0, h0 = launch_count(gf_bitmatmul_cuda), launch_count(blake3_batch)
    parity, hashes = encode_hash_tensor(bm, x)
    assert (launch_count(gf_bitmatmul_cuda), launch_count(blake3_batch)) == (g0 + 1, h0 + 1)
    want = gf_bitmatmul(bm, x)
    assert torch.equal(parity, want)
    assert torch.equal(hashes, blake3_pieces_ref(x, want))

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
    flat = torch.zeros(2 * 5 * 1024 + 8, dtype=torch.uint8, device=dev)
    rows = flat[8:].view(2, 5, 1024)  # base not 16-byte aligned
    with pytest.raises(ValueError):
        blake3_pieces(rows[:, :3], rows[:, 3:])
    rows = flat[:-8].view(2, 5, 1024)
    with pytest.raises(ValueError):
        blake3_pieces(rows[:, :3], rows[:, 3:].cpu())  # two devices


def test_shared_card_mesh_matches_single_device(dev):
    """A 4-entry mesh whose entries all name one card (one stream each):
    encode, reconstruct and `sharded_apply` at uneven batches equal the
    single-device path bit for bit."""
    mesh = make_mesh(devices=[dev] * 4)
    k, m, s = 8, 3, 4096
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (9, k, s), dtype=np.uint8)
    fan = EcCuda(k, m, device=dev, mesh=mesh)
    one = EcCuda(k, m, device=dev, n_devices=1)
    g0 = launch_count(gf_bitmatmul_cuda)
    parity = fan.encode(data)
    assert launch_count(gf_bitmatmul_cuda) == g0 + 4
    assert np.array_equal(parity, one.encode(data))
    assert np.array_equal(parity, gf.encode_blocks_ref(data, k, m))
    full = np.concatenate([data, parity], axis=1)
    lost = [0, 5, 9]
    present = [i for i in range(k + m) if i not in lost]
    rec = fan.reconstruct(full[:, present], present, lost)
    assert np.array_equal(rec, full[:, lost])
    assert np.array_equal(rec, one.reconstruct(full[:, present], present, lost))

    pipe = ScrubRepairPipeline(k, m, s, device=dev)
    for b in (4, 11):
        x = rng.integers(0, 256, (b, k, s), dtype=np.uint8)
        got = pipe.sharded_apply(mesh, x)
        want = pipe.encode_and_hash_fn()(torch.from_numpy(x).to(dev))
        for g, w in zip(got, want):
            assert np.array_equal(g, w.cpu().numpy())


def test_auto_width_on_one_card_never_fans_out(dev, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls = []
    monkeypatch.setattr(EcCuda, "_apply_mesh", lambda *a: calls.append(a))
    ec = EcCuda(8, 3, device=dev)
    assert ec._mesh_width() == 1
    data = np.random.default_rng(7).integers(0, 256, (64, 8, 1024), dtype=np.uint8)
    assert np.array_equal(ec.encode(data), gf.encode_blocks_ref(data, 8, 3))
    assert calls == []


def test_verify_on_card_is_all_ok(dev):
    """tools/verify.py on the card: every encode, repair, pipeline and
    case check bit-exact against the oracles."""
    lines = []
    assert verify.verify(dev, out=lines.append) == 0, [ln for ln in lines if "MISMATCH" in ln]
    assert lines[-1] == "ALL-OK"


@pytest.mark.parametrize("mode,poison", sanitize_cuda.GUARD_RUNS)
def test_cases_clean_under_the_guard_page_allocator(dev, mode, poison):
    """The case list in a child whose every tensor lies against an
    unmapped granule, fresh memory poisoned: no fault, no violation, a
    launch of each kernel."""
    so = sanitize_cuda.build_tool_library("guard_alloc.cu")
    run = sanitize_cuda._run(f"guard-{mode}", sanitize_cuda.child_command(
        ["--guard", str(so), mode, str(poison)]), sanitize_cuda.GUARD_TIMEOUT_S)
    stats = sanitize_cuda.check_guard_run(run, verify.KERNELS)
    assert stats["violations"] == 0 and stats["allocs"] > 0
