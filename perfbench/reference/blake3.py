"""Plain BLAKE3-256 over NumPy, for many messages of one length at once.

Written from the BLAKE3 specification (O'Connor, Aumasson, Neves,
Wilcox-O'Hearn, 2020): 1024-byte chunks of 64-byte blocks, the 7-round
compression with its message permutation, chunk chaining values joined
pairwise up a binary tree in which each left subtree holds the largest
power of two of chunks (merging neighbours level by level, an odd last
node carried up, builds that tree), and the CHUNK_START, CHUNK_END,
PARENT and ROOT flags.  Words are uint32 arrays, one lane per (message,
chunk), so the compression runs once per block index for all lanes.
"""

from __future__ import annotations

import numpy as np

IV = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
               0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=np.uint32)
PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
BLOCK, CHUNK = 64, 1024


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _g(s, a, b, c, d, x, y) -> None:
    s[a] = s[a] + s[b] + x
    s[d] = _rotr(s[d] ^ s[a], 16)
    s[c] = s[c] + s[d]
    s[b] = _rotr(s[b] ^ s[c], 12)
    s[a] = s[a] + s[b] + y
    s[d] = _rotr(s[d] ^ s[a], 8)
    s[c] = s[c] + s[d]
    s[b] = _rotr(s[b] ^ s[c], 7)


def compress(cv: list, m: list, counter: np.ndarray, block_len, flags) -> list:
    """First 8 output words; every argument broadcasts over the lanes."""
    shape = np.broadcast(cv[0], counter, block_len, flags).shape
    s = [np.broadcast_to(w, shape).astype(np.uint32) for w in cv]
    s += [np.full(shape, IV[i], np.uint32) for i in range(4)]
    counter = np.asarray(counter, dtype=np.uint64)
    s += [np.broadcast_to((counter & 0xFFFFFFFF).astype(np.uint32), shape).copy(),
          np.broadcast_to((counter >> np.uint64(32)).astype(np.uint32), shape).copy(),
          np.broadcast_to(np.asarray(block_len, np.uint32), shape).copy(),
          np.broadcast_to(np.asarray(flags, np.uint32), shape).copy()]
    for r in range(7):
        _g(s, 0, 4, 8, 12, m[0], m[1])
        _g(s, 1, 5, 9, 13, m[2], m[3])
        _g(s, 2, 6, 10, 14, m[4], m[5])
        _g(s, 3, 7, 11, 15, m[6], m[7])
        _g(s, 0, 5, 10, 15, m[8], m[9])
        _g(s, 1, 6, 11, 12, m[10], m[11])
        _g(s, 2, 7, 8, 13, m[12], m[13])
        _g(s, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[PERM[i]] for i in range(16)]
    return [s[i] ^ s[i + 8] for i in range(8)]


def hash_rows(x: np.ndarray) -> np.ndarray:
    """x (n, L) uint8 -> (n, 32) uint8: the BLAKE3-256 digest of each row."""
    n, length = x.shape
    chunks = max(1, -(-length // CHUNK))
    buf = np.zeros((n, chunks * CHUNK), dtype=np.uint8)
    buf[:, :length] = x
    words = buf.view("<u4").reshape(n, chunks, CHUNK // BLOCK, 16)
    # bytes in each chunk, and blocks (at least one) in each chunk
    clen = np.minimum(CHUNK, np.maximum(0, length - CHUNK * np.arange(chunks)))
    nblk = np.maximum(1, -(-clen // BLOCK))
    root = chunks == 1
    cv = [np.broadcast_to(IV[i], (n, chunks)).copy() for i in range(8)]
    counter = np.arange(chunks, dtype=np.uint64)[None, :]
    for b in range(int(nblk.max())):
        live = b < nblk  # (chunks,)
        blen = np.clip(clen - BLOCK * b, 0, BLOCK)
        flags = np.where(b == 0, CHUNK_START, 0) | np.where(
            b == nblk - 1, CHUNK_END | (ROOT if root else 0), 0)
        out = compress(cv, [words[:, :, b, w] for w in range(16)], counter,
                       blen[None, :], flags[None, :])
        cv = [np.where(live[None, :], o, c) for o, c in zip(out, cv)]
    # parents, level by level; an odd last node is carried up
    nodes = cv
    while nodes[0].shape[1] > 1:
        width = nodes[0].shape[1]
        pairs = width // 2
        last = pairs == 1 and width == 2
        flags = PARENT | (ROOT if last else 0)
        m = [nd[:, 0:2 * pairs:2] for nd in nodes] + [nd[:, 1:2 * pairs:2] for nd in nodes]
        merged = compress([np.broadcast_to(IV[i], (n, pairs)) for i in range(8)], m,
                          np.zeros(1, np.uint64), BLOCK, flags)
        if width % 2:
            merged = [np.concatenate([mg, nd[:, -1:]], axis=1) for mg, nd in zip(merged, nodes)]
        nodes = merged
    digest = np.stack([w[:, 0] for w in nodes], axis=1).astype("<u4")
    return digest.view(np.uint8).reshape(n, 32)


def blake3(data: bytes) -> bytes:
    return hash_rows(np.frombuffer(data, dtype=np.uint8)[None, :]).tobytes()
