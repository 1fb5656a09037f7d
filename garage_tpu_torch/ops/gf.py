"""GF(2^8) arithmetic and Cauchy Reed-Solomon coding — CPU reference.

The erasure-coded replication mode (`replication_mode = "ec:k:m"`,
BASELINE.json north star) splits each block into k data shards and m parity
shards over GF(2^8) with the AES-friendly polynomial x^8+x^4+x^3+x^2+1
(0x11d).  This module is the bit-exact oracle for the coding kernel in
ec_cuda.py and builds every matrix that kernel consumes; it is a copy of
garage_tpu/ops/gf.py without the native C host codec.

Key construction for the device path: multiplication by a constant c in
GF(2^8) is GF(2)-linear on the 8 bits of the operand, i.e. an 8x8 binary
matrix M_c with M_c[b, a] = bit b of (c * 2^a).  A full (m x k) GF coding
matrix therefore expands to an (8m x 8k) binary matrix, and erasure
encoding of bit-unpacked shards becomes an integer matmul followed by
`& 1`; the CUDA kernel folds each 8x8 block into a 256-entry byte
lookup table (see ec_cuda.py).
"""

from __future__ import annotations

import numpy as np

_POLY = 0x11D

# --- log/exp tables ---------------------------------------------------------

GF_EXP = np.zeros(512, dtype=np.uint8)
GF_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    GF_EXP[_i] = _x
    GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _POLY
GF_EXP[255:510] = GF_EXP[:255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(GF_EXP[255 - GF_LOG[a]])


# 256x256 multiplication table: MUL[c] is the 256-entry LUT for y = c*x.
# 64 KiB, built once; the numpy reference codec is gathers through this.
_PRODUCT_LOG = GF_LOG[:, None] + GF_LOG[None, :]
GF_MUL_TABLE = GF_EXP[_PRODUCT_LOG % 255].astype(np.uint8)
GF_MUL_TABLE[0, :] = 0
GF_MUL_TABLE[:, 0] = 0


# --- matrices ---------------------------------------------------------------

def cauchy_parity_matrix(k: int, m: int) -> np.ndarray:
    """(m x k) Cauchy matrix C[i, j] = 1 / (x_i + y_j), x_i = k+i, y_j = j.

    All x_i, y_j distinct => every square submatrix of [I_k ; C] is
    invertible, which is the property erasure decoding relies on.
    """
    if k + m > 255:
        raise ValueError("k+m must be <= 255 for distinct GF(2^8) points")
    c = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            c[i, j] = gf_inv((k + i) ^ j)
    return c


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8): a (p x q) @ b (q x r) -> (p x r).

    Used for small coding matrices only (the data path uses LUT gathers or
    the coding kernel).
    """
    p, q = a.shape
    q2, r = b.shape
    assert q == q2
    out = np.zeros((p, r), dtype=np.uint8)
    for i in range(q):
        out ^= GF_MUL_TABLE[a[:, i][:, None], b[i, :][None, :]]
    return out


def gf_invert_matrix(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion of a (n x n) matrix over GF(2^8)."""
    n = a.shape[0]
    assert a.shape == (n, n)
    aug = np.concatenate([a.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise ValueError("matrix is singular over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = GF_MUL_TABLE[inv_p, aug[col]]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= GF_MUL_TABLE[int(aug[row, col]), aug[col]]
    return aug[:, n:]


def encode_matrix(k: int, m: int) -> np.ndarray:
    """Systematic (k+m x k) generator matrix [I_k ; C]."""
    return np.concatenate([np.eye(k, dtype=np.uint8), cauchy_parity_matrix(k, m)])


def reconstruction_matrix(
    k: int, m: int, present: list[int], want: list[int]
) -> np.ndarray:
    """(len(want) x k) matrix R such that  want_shards = R @ present[:k] shards.

    `present` — indices (in [0, k+m)) of at least k surviving shards (the
    first k listed are used); `want` — indices of shards to reconstruct.
    """
    if len(present) < k:
        raise ValueError(f"need >= {k} surviving shards, have {len(present)}")
    gen = encode_matrix(k, m)
    sub = gen[np.array(present[:k])]  # (k x k), invertible by Cauchy property
    inv = gf_invert_matrix(sub)  # data = inv @ present_shards
    rows = gen[np.array(want)]  # want = rows @ data
    return gf_matmul(rows, inv)


# --- bit-matrix expansion (the coding-kernel construction) -------------------

def gf_const_bitmatrix(c: int) -> np.ndarray:
    """8x8 binary matrix of multiplication-by-c: out_bit[b] = sum_a M[b,a]*in_bit[a] mod 2."""
    m = np.zeros((8, 8), dtype=np.uint8)
    for a in range(8):
        prod = gf_mul(c, 1 << a)
        for b in range(8):
            m[b, a] = (prod >> b) & 1
    return m


def bitmatrix_of(coding: np.ndarray) -> np.ndarray:
    """Expand an (r x q) GF(2^8) matrix to the (8r x 8q) binary matrix acting
    on bit-unpacked shards (LSB-first bit order)."""
    r, q = coding.shape
    out = np.zeros((8 * r, 8 * q), dtype=np.uint8)
    for i in range(r):
        for j in range(q):
            out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = gf_const_bitmatrix(
                int(coding[i, j])
            )
    return out


# --- numpy reference codec ---------------------------------------------------

def apply_matrix_ref(coding: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """Reference data path: out (..., r, S) = coding (r x q) @ shards (..., q, S)
    over GF(2^8), via LUT gathers.  shards uint8; leading batch dims allowed."""
    r, q = coding.shape
    assert shards.shape[-2] == q, (coding.shape, shards.shape)
    out = np.zeros(shards.shape[:-2] + (r, shards.shape[-1]), dtype=np.uint8)
    for j in range(q):
        col = shards[..., j, :]  # (..., S)
        for i in range(r):
            c = int(coding[i, j])
            if c != 0:
                out[..., i, :] ^= GF_MUL_TABLE[c][col]
    return out


def encode_blocks_ref(data: np.ndarray, k: int, m: int) -> np.ndarray:
    """(..., k, S) data shards -> (..., m, S) parity shards."""
    return apply_matrix_ref(cauchy_parity_matrix(k, m), data)


def reconstruct_blocks_ref(
    shards: np.ndarray, k: int, m: int, present: list[int], want: list[int]
) -> np.ndarray:
    """shards: (..., len(present)>=k, S) surviving shards in `present` order.
    Returns (..., len(want), S) reconstructed shards."""
    rmat = reconstruction_matrix(k, m, present, want)
    return apply_matrix_ref(rmat, shards[..., : k, :])


def split_block(block: bytes, k: int) -> np.ndarray:
    """Pad a block to k equal shards -> (k, S) uint8."""
    s = (len(block) + k - 1) // k
    buf = np.zeros(k * s, dtype=np.uint8)
    buf[: len(block)] = np.frombuffer(block, dtype=np.uint8)
    return buf.reshape(k, s)
