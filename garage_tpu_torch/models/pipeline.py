"""Flagship compute pipeline: EC coding + BLAKE3 shard hashing + scrub
statistics (port of garage_tpu/models/pipeline.py).

One dispatch takes a batch of blocks already split into k data shards
and produces the m parity shards, the 32-byte integrity hash of every
one of the k+m shards, and the scrub statistics `[count, xor-fold]` —
the write-path and scrub/repair math of the erasure-coded block store,
with no host round-trip inside.  On the card the coding and the hashes
are kernels K1 and K2 (ops/ec_cuda.py `encode_hash_tensor`); the fold is
a few tensor ops over K2's small (B, k+m, 32) output.

The multi-device step (`sharded_step` / `sharded_apply` of the
reference) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gf
from ..ops.ec_cuda import (
    blake3_supported_len, coding_state_from_numpy, encode_hash_tensor,
    resolve_device,
)


def scrub_stats(hashes: torch.Tensor, nvalid=None) -> torch.Tensor:
    """hashes (B, n, 32) uint8 -> int64 tensor [count, fold]: the block
    count (or `nvalid`) and the exact XOR-fold of every little-endian
    32-bit hash word of the first `nvalid` blocks, computed as a per-bit
    sum mod 2 (the reference's formulation)."""
    b = hashes.shape[0]
    dev = hashes.device
    hw = hashes.reshape(b, -1, 4).to(torch.int64)
    words = hw[..., 0] | (hw[..., 1] << 8) | (hw[..., 2] << 16) | (hw[..., 3] << 24)
    bitpos = torch.arange(32, dtype=torch.int64, device=dev)
    bits = (words[..., None] >> bitpos) & 1  # (B, W, 32)
    if nvalid is None:
        count = torch.tensor(b, dtype=torch.int64, device=dev)
    else:
        count = torch.as_tensor(nvalid, dtype=torch.int64).to(dev)
        valid = (torch.arange(b, device=dev) < count).to(torch.int64)
        bits = bits * valid[:, None, None]
    parities = bits.sum(dim=(0, 1)) & 1  # (32,)
    fold = (parities << bitpos).sum()
    return torch.stack([count, fold])


class ScrubRepairPipeline:
    """EC(k, m) + shard hashing, fixed shard size, batched over blocks.

    shard_bytes must be a supported BLAKE3 batch length (multiple of 64 up
    to 1024, or a power-of-two number of KiB) — the block layer pads shards
    to these sizes.
    """

    def __init__(self, k: int = 8, m: int = 3, shard_bytes: int = 128 * 1024,
                 device="cuda"):
        if not blake3_supported_len(shard_bytes):
            raise ValueError(f"shard_bytes {shard_bytes} is not a supported BLAKE3 length")
        self.k, self.m, self.shard_bytes = k, m, shard_bytes
        self.device = resolve_device(device)
        self._enc_bitmat = coding_state_from_numpy(
            gf.cauchy_parity_matrix(k, m), self.device
        )["bitmat"]

    def encode_and_hash_fn(self):
        """fn: data (B, k, S) uint8 on the pipeline's device ->
        (parity (B, m, S), hashes (B, k+m, 32), scrub_stats (2,) int64).
        `nvalid` masks trailing zero-pad blocks out of the statistics."""
        k, s = self.k, self.shard_bytes
        enc_bitmat = self._enc_bitmat

        def fwd(data: torch.Tensor, nvalid=None):
            if data.dim() != 3 or data.shape[1:] != (k, s):
                raise ValueError(f"expected (B, {k}, {s}), got {tuple(data.shape)}")
            shards, hashes = encode_hash_tensor(enc_bitmat, data)
            return shards[:, k:], hashes, scrub_stats(hashes, nvalid)

        return fwd

    def example_batch(self, batch: int = 4, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(
            0, 256, (batch, self.k, self.shard_bytes), dtype=np.uint8
        )
