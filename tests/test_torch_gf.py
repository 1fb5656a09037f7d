"""garage_tpu_torch GF(2^8) math against the JAX package: the port's
matrix builders and coding-state loader, and the plain version of the
coding kernel (what `gf_bitmatmul_cuda` runs for a CPU tensor) against
the Pallas kernel in interpret mode and the XLA einsum body.  Integer
math: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garage_tpu.ops import gf as jgf
from garage_tpu.ops.ec_tpu import gf_bitmatmul as jax_einsum_body
from garage_tpu.ops.ec_tpu import gf_bitmatmul_pallas
from garage_tpu_torch.ops import gf as tgf
from garage_tpu_torch.ops.ec_cuda import (
    coding_state_from_numpy, gf_bitmatmul, gf_bitmatmul_cuda,
)

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)


def _matrices(k: int, m: int, rng) -> dict[str, np.ndarray]:
    """(8m, 8k) bit-matrices from the JAX package: encode, two repair
    patterns, and one arbitrary 0/1 matrix (the kernel's contract is a
    general 0/1 product, not only GF expansions)."""
    lost_a = list(range(m))  # the first m data shards
    lost_b = [1, k, k + m - 1][:m] if m > 1 else [k - 1]
    return {
        "encode": jgf.bitmatrix_of(jgf.cauchy_parity_matrix(k, m)),
        "repair_a": jgf.bitmatrix_of(jgf.reconstruction_matrix(
            k, m, [i for i in range(k + m) if i not in lost_a], lost_a)),
        "repair_b": jgf.bitmatrix_of(jgf.reconstruction_matrix(
            k, m, [i for i in range(k + m) if i not in lost_b], lost_b)),
        "arbitrary": rng.integers(0, 2, (8 * m, 8 * k), dtype=np.uint8),
    }


@pytest.mark.parametrize("s", [128, 1024, 4096])
@pytest.mark.parametrize("k,m", [(4, 2), (8, 3), (16, 4)])
def test_gf_bitmatmul_matches_pallas_and_einsum(k, m, s):
    rng = np.random.default_rng(100 * k + s)
    x = rng.integers(0, 256, (2, k, s), dtype=np.uint8)
    for name, bm in _matrices(k, m, rng).items():
        port = gf_bitmatmul_cuda(torch.from_numpy(bm), torch.from_numpy(x)).numpy()
        pallas = np.asarray(gf_bitmatmul_pallas(
            jnp.asarray(bm, jnp.uint8), jnp.asarray(x), interpret=True))
        einsum = np.asarray(jax_einsum_body(jnp.asarray(bm, jnp.bfloat16), jnp.asarray(x)))
        assert np.array_equal(port, pallas), name
        assert np.array_equal(port, einsum), name


def test_gf_bitmatmul_unaligned_shard_matches_einsum_and_oracle():
    """S=100 (not a multiple of 128): the JAX package routes it to the
    einsum body; the port's plain version and kernel take it as is."""
    k, m = 4, 2
    rng = np.random.default_rng(12)
    x = rng.integers(0, 256, (3, k, 100), dtype=np.uint8)
    coding = jgf.cauchy_parity_matrix(k, m)
    bm = jgf.bitmatrix_of(coding)
    port = gf_bitmatmul(torch.from_numpy(bm), torch.from_numpy(x)).numpy()
    einsum = np.asarray(jax_einsum_body(jnp.asarray(bm, jnp.bfloat16), jnp.asarray(x)))
    assert np.array_equal(port, einsum)
    assert np.array_equal(port, jgf.apply_matrix_ref(coding, x))


def test_gf_bitmatmul_writes_strided_output():
    """The fused encode writes parity into the [:, k:] half of one
    (B, k+m, S) buffer through the wrapper's `out` argument."""
    k, m, s = 8, 3, 256
    rng = np.random.default_rng(4)
    buf = torch.zeros((5, k + m, s), dtype=torch.uint8)
    buf[:, :k] = torch.from_numpy(rng.integers(0, 256, (5, k, s), dtype=np.uint8))
    bm = torch.from_numpy(jgf.bitmatrix_of(jgf.cauchy_parity_matrix(k, m)))
    gf_bitmatmul_cuda(bm, buf[:, :k], out=buf[:, k:])
    want = jgf.apply_matrix_ref(jgf.cauchy_parity_matrix(k, m), buf[:, :k].numpy())
    assert np.array_equal(buf[:, k:].numpy(), want)


@pytest.mark.parametrize("bad", ["bitmat_width", "bitmat_rows", "x_dtype", "out_shape"])
def test_gf_wrapper_rejects_bad_arguments(bad):
    bm = torch.zeros((24, 64), dtype=torch.uint8)
    x = torch.zeros((2, 8, 128), dtype=torch.uint8)
    out = None
    if bad == "bitmat_width":
        bm = bm[:, :32]
    elif bad == "bitmat_rows":
        bm = bm[:20]
    elif bad == "x_dtype":
        x = x.to(torch.int32)
    else:
        out = torch.zeros((2, 2, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):
        gf_bitmatmul_cuda(bm, x, out=out)


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 3), (16, 4)])
def test_matrix_builders_match_reference(k, m):
    assert np.array_equal(tgf.cauchy_parity_matrix(k, m), jgf.cauchy_parity_matrix(k, m))
    assert np.array_equal(tgf.encode_matrix(k, m), jgf.encode_matrix(k, m))
    rng = np.random.default_rng(k + m)
    for _ in range(4):
        lost = sorted(rng.choice(k + m, size=m, replace=False).tolist())
        present = [i for i in range(k + m) if i not in lost]
        rp = tgf.reconstruction_matrix(k, m, present, lost)
        assert np.array_equal(rp, jgf.reconstruction_matrix(k, m, present, lost))
        assert np.array_equal(tgf.bitmatrix_of(rp), jgf.bitmatrix_of(rp))
        sub = jgf.encode_matrix(k, m)[present[:k]]
        assert np.array_equal(tgf.gf_invert_matrix(sub), jgf.gf_invert_matrix(sub))


def test_tables_and_oracle_match_reference():
    assert np.array_equal(tgf.GF_EXP, jgf.GF_EXP)
    assert np.array_equal(tgf.GF_LOG, jgf.GF_LOG)
    assert np.array_equal(tgf.GF_MUL_TABLE, jgf.GF_MUL_TABLE)
    rng = np.random.default_rng(9)
    coding = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    shards = rng.integers(0, 256, (2, 5, 300), dtype=np.uint8)
    assert np.array_equal(
        tgf.apply_matrix_ref(coding, shards), jgf.apply_matrix_ref(coding, shards)
    )


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3), (16, 4)])
def test_coding_state_from_numpy_carries_reference_matrices(k, m):
    """The loader turns the JAX package's numpy matrices into the port's
    tensors; fed the reference's matrix, it gives the port's own."""
    ref = jgf.cauchy_parity_matrix(k, m)
    state = coding_state_from_numpy(ref, "cpu")
    assert state["coding"].dtype == state["bitmat"].dtype == torch.uint8
    assert np.array_equal(state["coding"].numpy(), ref)
    assert np.array_equal(state["bitmat"].numpy(), jgf.bitmatrix_of(ref))
    own = coding_state_from_numpy(tgf.cauchy_parity_matrix(k, m), "cpu")
    assert torch.equal(own["bitmat"], state["bitmat"])
    rmat = jgf.reconstruction_matrix(k, m, list(range(m, k + m)), list(range(m)))
    assert np.array_equal(
        coding_state_from_numpy(rmat, "cpu")["bitmat"].numpy(), jgf.bitmatrix_of(rmat)
    )
