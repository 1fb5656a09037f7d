"""Pure-Python BLAKE3 (oracle for the batched kernel in hash_cuda.py).

BLAKE3 is the rebuild's shard-integrity hash: all-32-bit word arithmetic
and a parallel chunk tree make it the natural device hash, unlike the
64-bit BLAKE2b used for content addressing (which stays on the host — it
is the block identity in the metadata tables and is computed on the
write path anyway).

Implemented from the BLAKE3 paper's specification: 1024-byte chunks, 64-byte
blocks, 7-round compression with the fixed message permutation, chunk
chaining values combined in a binary tree where each left subtree is the
largest power of two number of chunks, CHUNK_START/CHUNK_END/PARENT/ROOT
flags.  A copy of garage_tpu/ops/blake3_ref.py, verified against the
official test vectors in tests/test_blake3.py.
"""

from __future__ import annotations

import struct

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024
MASK32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _g(state: list[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 7)


def compress(
    cv: tuple[int, ...],
    block_words: tuple[int, ...],
    counter: int,
    block_len: int,
    flags: int,
) -> list[int]:
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & MASK32, (counter >> 32) & MASK32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(state, 0, 4, 8, 12, m[0], m[1])
        _g(state, 1, 5, 9, 13, m[2], m[3])
        _g(state, 2, 6, 10, 14, m[4], m[5])
        _g(state, 3, 7, 11, 15, m[6], m[7])
        _g(state, 0, 5, 10, 15, m[8], m[9])
        _g(state, 1, 6, 11, 12, m[10], m[11])
        _g(state, 2, 7, 8, 13, m[12], m[13])
        _g(state, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    return [
        state[i] ^ state[i + 8] if i < 8 else state[i] ^ cv[i - 8]
        for i in range(16)
    ]


def _words(block: bytes) -> tuple[int, ...]:
    block = block.ljust(BLOCK_LEN, b"\x00")
    return struct.unpack("<16I", block)


def _chunk_output(chunk: bytes, chunk_counter: int) -> tuple[tuple[int, ...], tuple[int, ...], int, int]:
    """Process all but the last block of a chunk; return (cv, last_block_words,
    last_block_len, base_flags) so the caller can add ROOT when applicable."""
    cv = IV
    blocks = [chunk[i : i + BLOCK_LEN] for i in range(0, max(len(chunk), 1), BLOCK_LEN)]
    for i, blk in enumerate(blocks[:-1]):
        flags = CHUNK_START if i == 0 else 0
        cv = tuple(compress(cv, _words(blk), chunk_counter, BLOCK_LEN, flags)[:8])
    last = blocks[-1]
    flags = (CHUNK_START if len(blocks) == 1 else 0) | CHUNK_END
    return cv, _words(last), len(last), flags


def _root_output_bytes(
    cv: tuple[int, ...],
    block_words: tuple[int, ...],
    counter: int,
    block_len: int,
    flags: int,
    out_len: int,
) -> bytes:
    """Extended output: re-run the final compression with incrementing
    output-block counter."""
    out = b""
    ctr = 0
    while len(out) < out_len:
        words = compress(cv, block_words, ctr, block_len, flags | ROOT)
        out += struct.pack("<16I", *words)
        ctr += 1
    return out[:out_len]


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 hash (default mode, no key/derive)."""
    # split into chunks
    n_chunks = max(1, (len(data) + CHUNK_LEN - 1) // CHUNK_LEN)
    chunks = [data[i * CHUNK_LEN : (i + 1) * CHUNK_LEN] for i in range(n_chunks)]

    if n_chunks == 1:
        cv, last_words, last_len, flags = _chunk_output(chunks[0], 0)
        return _root_output_bytes(cv, last_words, 0, last_len, flags, out_len)

    # chunk chaining values
    cvs: list[tuple[int, ...]] = []
    for i, c in enumerate(chunks):
        cv, last_words, last_len, flags = _chunk_output(c, i)
        cvs.append(tuple(compress(cv, last_words, i, last_len, flags)[:8]))

    # binary tree: left subtree = largest power of two < total count
    def merge(nodes: list[tuple[int, ...]]) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """Reduce to the final (left_cv_words..., right...) parent block."""
        if len(nodes) == 2:
            return nodes[0], nodes[1]
        split = 1 << (len(nodes) - 1).bit_length() - 1
        parts = []
        for grp in (nodes[:split], nodes[split:]):
            if len(grp) == 1:
                parts.append(grp[0])
            else:
                l, r = merge(grp)
                parts.append(tuple(compress(IV, l + r, 0, BLOCK_LEN, PARENT)[:8]))
        return parts[0], parts[1]

    left, right = merge(cvs)
    return _root_output_bytes(IV, left + right, 0, BLOCK_LEN, PARENT, out_len)
