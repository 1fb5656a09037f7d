"""A numpy mirror of kernel K1 (garage_tpu_torch/csrc/gf_bitplane.cu), held
against the JAX package on the CPU.

The kernel cannot run here, so this file repeats its arithmetic step by
step in numpy, with the kernel's own memory layout and selectors:

- the shared-memory image of one output group g: per input row j and
  nibble half h a 16-entry table T[j][h][n] of W-byte entries (W = 4 when
  r <= 4, else 8), whose byte i - g*W is M_ij(n << 4h); the columns
  (n = 1, 2, 4, 8) come from the bit-matrix, every other entry is the XOR
  of the columns of its set bits;
- the vector path: 16 bytes of a row as four little-endian words, each
  turned into table byte offsets by one shift and one mask (with the low
  byte of row j's table base), each offset moved out by a byte permute
  (PRMT) that also brings in the base's upper bytes, two lookups per byte
  XORed into the column's packed accumulator, and the 4x4 byte transpose
  of the epilogue;
- the byte path for the ragged tail.

The result must equal, byte for byte (tolerance 0: integer math), the JAX
package's XLA einsum body `gf_bitmatmul` and, for GF(2^8) matrices, its
LUT oracle `gf.apply_matrix_ref`, for Cauchy encode matrices,
reconstruction matrices and random 0/1 matrices that are no GF expansion.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from garage_tpu.ops import gf as jgf
from garage_tpu.ops.ec_tpu import gf_bitmatmul as jax_einsum_body

COLS = 16  # byte columns a thread owns: one 16-byte load per input row


def byte_perm(x, y, sel: int):
    """CUDA's __byte_perm on uint32 arrays: result byte n is byte
    (sel >> 4n) & 7 of the 8-byte value y:x."""
    x = np.asarray(x, np.uint32)
    y = np.broadcast_to(np.asarray(y, np.uint32), x.shape)
    src = [(x >> np.uint32(8 * b)) & np.uint32(0xFF) for b in range(4)]
    src += [(y >> np.uint32(8 * b)) & np.uint32(0xFF) for b in range(4)]
    out = np.zeros(x.shape, np.uint32)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def build_tables(bitmat: np.ndarray, r: int, q: int, g: int, w: int) -> np.ndarray:
    """The shared-memory image of group g's tables: q * 2 * 16 entries of
    w bytes, entry (j, h, n) at byte ((j*2 + h)*16 + n) * w."""
    words = np.zeros((q, 2, 16, w // 4), np.uint32)
    for j in range(q):
        for a in range(8):  # the columns: bit 8i+t of the entry is M[8(gw+i)+t, 8j+a]
            for rr in range(8 * w):
                row = 8 * g * w + rr
                if row < 8 * r:
                    words[j, a >> 2, 1 << (a & 3), rr >> 5] |= np.uint32(
                        (int(bitmat[row, 8 * j + a]) & 1) << (rr & 31))
    for n in range(16):  # every other entry: the XOR of its set bits' columns
        if n and not n & (n - 1):
            continue
        words[:, :, n] = 0
        for a in range(4):
            if n >> a & 1:
                words[:, :, n] ^= words[:, :, 1 << a]
    return words.reshape(-1).astype("<u4").view(np.uint8)


def entry(tabs: np.ndarray, offset, w: int) -> np.ndarray:
    """The w-byte entries at byte `offset` of the image, as (..., w // 4)
    uint32 words (x: rows 0-3 of the group, y: rows 4-7)."""
    t32 = tabs.view("<u4")
    return np.stack([t32[offset // 4 + k] for k in range(w // 4)], axis=-1)


def transpose4(a0, a1, a2, a3):
    t0 = byte_perm(a0, a1, 0x5140)
    t1 = byte_perm(a2, a3, 0x5140)
    t2 = byte_perm(a0, a1, 0x7362)
    t3 = byte_perm(a2, a3, 0x7362)
    return (byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
            byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632))


def vector_path(tabs: np.ndarray, x: np.ndarray, w: int, nrows: int) -> np.ndarray:
    """x (B, q, V), V a multiple of 16 -> (B, nrows, V), as the kernel's
    16-byte loads, lookups and transposed 16-byte stores compute it."""
    b, q, v = x.shape
    shift = 2 if w == 4 else 3
    mask = np.uint32(0x0F0F0F0F << shift)
    words = np.ascontiguousarray(x).view("<u4")  # (B, q, V/4): word k of each chunk
    acc = np.zeros((b, v, w // 4), np.uint32)
    for j in range(q):
        base = j * 32 * w  # T[j][0]; its low byte joins every nibble offset
        low = np.uint32((base & 0xFF) * 0x01010101)
        high = low | np.uint32(0x01010101 * 16 * w)
        ws = words[:, j]
        lo = ((ws << np.uint32(shift)) & mask) | low
        hi = ((ws >> np.uint32(4 - shift)) & mask) | high
        for c in range(4):
            a = entry(tabs, byte_perm(lo, base, 0x7650 + c), w)
            bb = entry(tabs, byte_perm(hi, base, 0x7650 + c), w)
            acc[:, c::4] ^= a ^ bb
    acc = acc.reshape(b, v // COLS, 4, 4, w // 4)  # (B, chunk, quad k, column, half)
    rows = np.zeros((b, w, v // COLS, 4), np.uint32)
    for k in range(4):
        for half in range(w // 4):
            quad = [acc[:, :, k, c, half] for c in range(4)]
            for i, row in enumerate(transpose4(*quad)):
                rows[:, 4 * half + i, :, k] = row
    out = rows.astype("<u4").view(np.uint8).reshape(b, w, v)
    return out[:, :nrows]


def byte_path(tabs: np.ndarray, x: np.ndarray, w: int, nrows: int) -> np.ndarray:
    """Columns of any alignment, one byte at a time."""
    b, q, n = x.shape
    acc = np.zeros((b, n, w // 4), np.uint32)
    for j in range(q):
        v = x[:, j].astype(np.int64)
        acc ^= entry(tabs, j * 32 * w + (v & 15) * w, w)
        acc ^= entry(tabs, j * 32 * w + (16 + (v >> 4)) * w, w)
    out = np.stack([(acc[..., i // 4] >> np.uint32(8 * (i % 4))) & np.uint32(0xFF)
                    for i in range(nrows)], axis=1)
    return out.astype(np.uint8)


def k1_mirror(bitmat: np.ndarray, x: np.ndarray) -> np.ndarray:
    """(8r, 8q) 0/1 matrix, x (B, q, S) uint8 -> (B, r, S), group by group:
    the vector path for whole 16-byte chunks, the byte path for the tail."""
    r, q = bitmat.shape[0] // 8, bitmat.shape[1] // 8
    w = 4 if r <= 4 else 8
    b, _q, s = x.shape
    v = s - s % COLS
    out = np.zeros((b, r, s), np.uint8)
    for g in range(-(-r // w)):
        nrows = min(w, r - g * w)
        tabs = build_tables(bitmat, r, q, g, w)
        assert tabs.size == q * 2 * 16 * w
        out[:, g * w:g * w + nrows, :v] = vector_path(tabs, x[:, :, :v], w, nrows)
        out[:, g * w:g * w + nrows, v:] = byte_path(tabs, x[:, :, v:], w, nrows)
    return out


def _coding(kind: str, r: int, q: int, rng) -> np.ndarray | None:
    """An (r x q) GF(2^8) matrix of the JAX package, or None for a random
    0/1 bit-matrix."""
    if kind == "encode":
        return jgf.cauchy_parity_matrix(q, r)
    if kind == "repair":
        lost = sorted(rng.choice(q + r, size=r, replace=False).tolist())
        return jgf.reconstruction_matrix(q, r, [i for i in range(q + r) if i not in lost], lost)
    return None


@pytest.mark.parametrize("kind", ["encode", "repair", "random"])
@pytest.mark.parametrize("q", [1, 8, 16])
@pytest.mark.parametrize("r", [1, 3, 4, 5, 8, 12])
def test_k1_nibble_tables_match_jax(r, q, kind):
    rng = np.random.default_rng(1000 * r + 10 * q + len(kind))
    coding = _coding(kind, r, q, rng)
    if coding is None:
        bitmat = rng.integers(0, 2, (8 * r, 8 * q), dtype=np.uint8)
    else:
        assert coding.shape == (r, q)
        bitmat = jgf.bitmatrix_of(coding)
    x = rng.integers(0, 256, (2, q, 100), dtype=np.uint8)  # 6 chunks + a 4-byte tail
    got = k1_mirror(bitmat, x)
    einsum = np.asarray(jax_einsum_body(jnp.asarray(bitmat, jnp.bfloat16), jnp.asarray(x)))
    assert np.array_equal(got, einsum)
    if coding is not None:
        assert np.array_equal(got, jgf.apply_matrix_ref(coding, x))
