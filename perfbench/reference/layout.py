"""The layout of a block's pieces and of a stored piece.

A block of L bytes is k data shards of S bytes, S the smallest multiple
of 64 that is at least L / k, the block zero-padded to k * S.  A stored
piece is b"GTP2", the block length as a big-endian u64, the BLAKE3-256
of the piece, then the piece.
"""

from __future__ import annotations

import numpy as np

from . import blake3

MAGIC = b"GTP2"


def piece_len(block_len: int, k: int) -> int:
    s = -(-block_len // k)
    return -(-s // 64) * 64


def split(block: bytes, k: int) -> np.ndarray:
    s = piece_len(len(block), k)
    buf = np.zeros(k * s, dtype=np.uint8)
    buf[:len(block)] = np.frombuffer(block, dtype=np.uint8)
    return buf.reshape(k, s)


def stored(block_len: int, piece: np.ndarray, digest: bytes | None = None) -> bytes:
    if digest is None:
        digest = blake3.hash_rows(piece[None, :]).tobytes()
    return MAGIC + block_len.to_bytes(8, "big") + digest + piece.tobytes()
