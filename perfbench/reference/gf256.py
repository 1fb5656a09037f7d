"""Plain GF(2^8) Cauchy Reed-Solomon over NumPy: the yardstick the
benchmark judges the codec plane by.

Written from the construction, not from the program: the field is
GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1) (0x11d) with generator 2; the
code is systematic, a block's k data shards followed by m parity
shards, parity row i = sum_j C[i, j] * data_j with the Cauchy matrix
C[i, j] = 1 / (x_i + y_j), x_i = k + i, y_j = j (distinct points, so
every k rows of [I_k ; C] are invertible: any k pieces rebuild the
block).  Products are table gathers; nothing here is fast, and nothing
needs to be.
"""

from __future__ import annotations

import numpy as np

POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:] = exp[:255]
    mul = exp[(log[:, None] + log[None, :]) % 255].astype(np.uint8)
    mul[0, :] = 0
    mul[:, 0] = 0
    return exp, log, mul


EXP, LOG, MUL = _tables()


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP[255 - LOG[a]])


def cauchy(k: int, m: int) -> np.ndarray:
    """(m, k) parity matrix C[i, j] = 1 / ((k + i) xor j)."""
    return np.array([[inv((k + i) ^ j) for j in range(k)] for i in range(m)],
                    dtype=np.uint8)


def generator(k: int, m: int, parity: np.ndarray | None = None) -> np.ndarray:
    """(k + m, k) systematic generator [I_k ; C] (`parity` in place of
    the Cauchy matrix C where given)."""
    c = cauchy(k, m) if parity is None else parity
    return np.concatenate([np.eye(k, dtype=np.uint8), c])


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(p, q) x (q, r) over GF(2^8)."""
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[1]):
        out ^= MUL[a[:, i][:, None], b[i, :][None, :]]
    return out


def invert(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square matrix over GF(2^8)."""
    n = a.shape[0]
    aug = np.concatenate([a.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        rows = [r for r in range(col, n) if aug[r, col]]
        if not rows:
            raise ValueError("singular matrix over GF(2^8)")
        aug[[col, rows[0]]] = aug[[rows[0], col]]
        aug[col] = MUL[inv(int(aug[col, col])), aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= MUL[int(aug[r, col]), aug[col]]
    return aug[:, n:]


def apply(coding: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """out (r, S) = coding (r, q) x shards (q, S), by table gathers."""
    out = np.zeros((coding.shape[0], shards.shape[1]), dtype=np.uint8)
    for j in range(coding.shape[1]):
        for i in range(coding.shape[0]):
            c = int(coding[i, j])
            if c:
                out[i] ^= MUL[c][shards[j]]
    return out


def encode(data: np.ndarray, m: int, parity: np.ndarray | None = None) -> np.ndarray:
    """(k, S) data shards -> (m, S) parity shards."""
    return apply(cauchy(data.shape[0], m) if parity is None else parity, data)


def rebuild(k: int, m: int, pieces: dict[int, np.ndarray], want: list[int],
            parity: np.ndarray | None = None) -> np.ndarray:
    """Rows `want` of the coded block from any k of its pieces (the k
    lowest indices given are used)."""
    present = sorted(pieces)[:k]
    gen = generator(k, m, parity)
    decode = invert(gen[present])
    return apply(matmul(gen[want], decode), np.stack([pieces[p] for p in present]))
