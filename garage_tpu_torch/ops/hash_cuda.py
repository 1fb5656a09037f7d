"""Batched BLAKE3 on the card (port of garage_tpu/ops/hash_tpu.py).

`blake3_batch(x)` hashes B equal-length rows: it launches kernel K2
(csrc/blake3.cu) for a CUDA tensor and runs the plain PyTorch version
`blake3_batch_ref` for a CPU tensor.  Supported lengths are those of the
reference: any multiple of 64 bytes up to one chunk (<= 1024), or a
power-of-two number of full 1024-byte chunks; anything else raises
`ValueError`.  Output is the official BLAKE3-256 digest of each row
(oracle: blake3_ref.py).
"""

from __future__ import annotations

import torch

from . import _build
from .blake3_ref import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, PARENT, ROOT

BLOCK_LEN = 64
CHUNK_LEN = 1024
MASK32 = 0xFFFFFFFF


def n_chunks_for_len(length: int) -> int:
    """Chunk count of a supported row length; ValueError on the lengths
    the reference's `_hasher_for_len` rejects."""
    if length % BLOCK_LEN != 0 or length <= 0:
        raise ValueError("batched blake3 requires a positive multiple of 64 bytes")
    if length <= CHUNK_LEN:
        return 1
    if length % CHUNK_LEN != 0:
        raise ValueError("multi-chunk batched blake3 requires multiple of 1024")
    n_chunks = length // CHUNK_LEN
    if n_chunks & (n_chunks - 1):
        raise ValueError("chunk count must be a power of two")
    return n_chunks


# --- plain PyTorch version ----------------------------------------------------
# Words are int64 holding uint32 values, masked after every add and shift
# (torch.uint32 lacks most arithmetic).  The compression works on a list of
# 16 word tensors, vectorised over whatever leading shape they share.


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & MASK32


def _g(s: list, a: int, b: int, c: int, d: int, mx, my) -> None:
    s[a] = (s[a] + s[b] + mx) & MASK32
    s[d] = _rotr(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = _rotr(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b] + my) & MASK32
    s[d] = _rotr(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = _rotr(s[b] ^ s[c], 7)


def _compress(cv: list, m: list, counter, flags: int) -> list:
    """First 8 output words of one compression of a full 64-byte block."""
    s = list(cv) + list(IV[:4]) + [
        counter & MASK32, counter >> 32, BLOCK_LEN, flags,
    ]
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
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    return [s[i] ^ s[i + 8] for i in range(8)]


def blake3_batch_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: x (B, L) uint8 -> (B, 32) uint8 digests, on
    x's device.  The counterpart of the reference's `hash_batch`, with
    its `lax.scan` over a chunk's blocks as a Python loop."""
    b, length = x.shape
    n_chunks = n_chunks_for_len(length)
    n_blocks = length // (n_chunks * BLOCK_LEN)
    w = x.reshape(b, n_chunks, n_blocks, 16, 4).to(torch.int64)
    words = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    ctr = torch.arange(n_chunks, dtype=torch.int64, device=x.device)[None, :]
    cv = list(IV)
    for i in range(n_blocks):
        flags = CHUNK_START if i == 0 else 0
        if i == n_blocks - 1:
            flags |= CHUNK_END | (ROOT if n_chunks == 1 else 0)
        cv = _compress(cv, [words[:, :, i, j] for j in range(16)], ctr, flags)
    cvs = torch.stack(cv, dim=-1)  # (B, n_chunks, 8)
    n = n_chunks
    while n > 1:
        left, right = cvs[:, 0:n:2], cvs[:, 1:n:2]
        n //= 2
        m = [left[..., j] for j in range(8)] + [right[..., j] for j in range(8)]
        cvs = torch.stack(
            _compress(list(IV), m, 0, PARENT | (ROOT if n == 1 else 0)), dim=-1
        )
    root = cvs[:, 0, :]  # (B, 8)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=x.device)
    return ((root[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(b, 32)


# --- the K2 wrapper -------------------------------------------------------------


def blake3_batch(x: torch.Tensor) -> torch.Tensor:
    """x (B, L) uint8 -> (B, 32) uint8 BLAKE3 digests.  A CUDA tensor
    goes through kernel K2 on the current stream (no synchronisation;
    `blake3_batch.launches` counts the launches); a CPU tensor through
    `blake3_batch_ref`."""
    if x.dim() != 2 or x.dtype != torch.uint8:
        raise ValueError(f"expected a (B, L) uint8 tensor, got {tuple(x.shape)} {x.dtype}")
    n_chunks_for_len(x.shape[1])
    if x.device.type == "cpu":
        return blake3_batch_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("blake3_batch needs contiguous rows")
    if x.data_ptr() % 16:
        raise ValueError("blake3_batch needs a 16-byte aligned base")
    out = torch.empty((x.shape[0], 32), dtype=torch.uint8, device=x.device)
    if x.shape[0] == 0:
        return out
    code = _build.lib("blake3").blake3_rows(
        x.device.index, x.data_ptr(), x.shape[1], x.shape[0], out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(code, "blake3_rows")
    _build.count_launch(blake3_batch)
    return out


blake3_batch.launches = 0
