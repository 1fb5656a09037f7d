"""Batched BLAKE3 on the card (port of garage_tpu/ops/hash_tpu.py).

`blake3_batch(x)` hashes B equal-length rows, and `blake3_pieces(data,
parity)` every piece of a batch of coded blocks where the pieces lie:
each launches kernel K2 (csrc/blake3.cu) for CUDA tensors and runs the
plain PyTorch version (`blake3_batch_ref`, `blake3_pieces_ref`) for CPU
tensors.  Supported lengths are those of the reference: any multiple of
64 bytes up to one chunk (<= 1024), or a power-of-two number of full
1024-byte chunks; anything else raises `ValueError`.  Output is the
official BLAKE3-256 digest of each row (oracle: blake3_ref.py).
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .blake3_ref import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, PARENT, ROOT
from .telemetry import runs_on_host

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


def blake3_pieces_ref(data: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """Plain version of `blake3_pieces`: the concatenation of data
    (B, k, S) and parity (B, m, S), then `blake3_batch_ref` ->
    (B, k+m, 32)."""
    b, k, s = data.shape
    shards = torch.cat([data, parity], dim=1)
    return blake3_batch_ref(shards.reshape(-1, s)).view(b, k + parity.shape[1], 32)


# --- the K2 wrapper -------------------------------------------------------------


def _check_rows(x: torch.Tensor, strides, what: str) -> None:
    """Rows K2 can read in place: contiguous within a row, 16-byte
    aligned base and `strides` (bytes)."""
    if x.stride(-1) != 1:
        raise ValueError(f"{what}: the row (last) axis must be contiguous")
    if x.data_ptr() % 16 or any(st % 16 for st in strides):
        raise ValueError(f"{what}: K2 needs a 16-byte aligned base and row strides")


@functools.cache
def _scratch_words(length: int) -> int:
    """32-bit scratch words K2 needs per row of `length` bytes (0: none)."""
    return _build.lib("blake3").blake3_scratch_words(length)


def _hash_rows(b: int, s: int, x0: torch.Tensor, q0: int, strides0,
               x1: torch.Tensor | None = None, q1: int = 0, strides1=(0, 0)) -> torch.Tensor:
    """Launch K2 on b batch entries of q0 rows of x0 followed by q1 rows
    of x1 (each source's rows at `(batch, row)` byte strides) ->
    (b * (q0 + q1), 32) digests in `(entry, row)` order, on the current
    stream.  The scratch for rows longer than one warp's subtree is
    allocated here."""
    dev = x0.device
    out = torch.empty((b * (q0 + q1), 32), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    words = _scratch_words(s)
    scratch = (torch.empty(out.shape[0] * words, dtype=torch.int32, device=dev)
               if words else None)
    y = x0 if x1 is None else x1
    code = _build.lib("blake3").blake3_rows(
        dev.index, x0.data_ptr(), q0, strides0[0], strides0[1],
        y.data_ptr(), q1, strides1[0], strides1[1], b, s,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "blake3_rows")
    _build.count_launch(blake3_batch)
    return out


def blake3_batch(x: torch.Tensor) -> torch.Tensor:
    """x (B, L) uint8 -> (B, 32) uint8 BLAKE3 digests.  A CUDA tensor
    goes through kernel K2 on the current stream (no synchronisation;
    `_build.count_launch` counts the launches); its rows must be
    contiguous, with a 16-byte aligned base and row stride.  A CPU
    tensor goes through `blake3_batch_ref`."""
    if x.dim() != 2 or x.dtype != torch.uint8:
        raise ValueError(f"expected a (B, L) uint8 tensor, got {tuple(x.shape)} {x.dtype}")
    n_chunks_for_len(x.shape[1])
    if runs_on_host(x):
        return blake3_batch_ref(x)
    _check_rows(x, (x.stride(0),), "blake3_batch")
    return _hash_rows(x.shape[0], x.shape[1], x, 1, (x.stride(0), x.stride(0)))


def blake3_pieces(data: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """Digests of every piece of a batch of coded blocks, read where the
    pieces lie: data (B, k, S) and parity (B, m, S) uint8 -> (B, k+m, 32),
    row j of entry b being piece j of block b (data, then parity).  One
    K2 launch for a CUDA pair (counted as `blake3_batch`'s); each
    source needs contiguous rows with 16-byte aligned base and strides.
    A CPU pair goes through `blake3_pieces_ref`."""
    if data.dim() != 3 or parity.dim() != 3:
        raise ValueError(f"expected (B, q, S) tensors, got {tuple(data.shape)}, "
                         f"{tuple(parity.shape)}")
    (b, k, s), m = data.shape, parity.shape[1]
    if (b, s) != (parity.shape[0], parity.shape[2]):
        raise ValueError(f"data {tuple(data.shape)} and parity {tuple(parity.shape)} "
                         f"differ in batch or piece length")
    if data.dtype != torch.uint8 or parity.dtype != torch.uint8:
        raise ValueError(f"expected uint8, got {data.dtype}, {parity.dtype}")
    if data.device != parity.device:
        raise ValueError("data and parity must share a device")
    n_chunks_for_len(s)
    if runs_on_host(data):
        return blake3_pieces_ref(data, parity)
    _check_rows(data, data.stride()[:2], "data")
    _check_rows(parity, parity.stride()[:2], "parity")
    return _hash_rows(b, s, data, k, data.stride()[:2], parity, m,
                      parity.stride()[:2]).view(b, k + m, 32)
