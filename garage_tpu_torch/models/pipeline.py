"""Flagship compute pipeline: EC coding + BLAKE3 shard hashing + scrub
statistics (port of garage_tpu/models/pipeline.py).

One dispatch takes a batch of blocks already split into k data shards
and produces the m parity shards, the 32-byte integrity hash of every
one of the k+m shards, and the scrub statistics `[count, xor-fold]` —
the write-path and scrub/repair math of the erasure-coded block store,
with no host round-trip inside.  On the card the coding and the hashes
are kernels K1 and K2 (ops/ec_cuda.py `encode_hash_tensor`); the fold is
a few tensor ops over K2's small (B, k+m, 32) output.

Multi-device (`sharded_step` / `sharded_apply`): the block batch is
split over a mesh's entries (parallel/mesh.py); each entry runs the same
K1 + K2 on its slice under its own stream, and the only exchange between
entries is the (32,) vector of per-bit sums behind the fold, added up on
the first entry's device in place of the reference's psum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gf
from ..ops.bucketing import mesh_rows
from ..ops.ec_cuda import (
    blake3_supported_len, coding_state_from_numpy, encode_hash_tensor,
    resolve_device,
)
from ..parallel.mesh import Mesh


def _int64_on(dev, value) -> torch.Tensor:
    """`value` as an int64 scalar on `dev`: a fill on the device for a
    Python number, with no host-to-device copy, so the scrub statistics
    can be captured in a CUDA graph."""
    if isinstance(value, torch.Tensor):
        return value.to(device=dev, dtype=torch.int64)
    return torch.full((), value, dtype=torch.int64, device=dev)


def scrub_bit_sums(hashes: torch.Tensor, nvalid=None) -> torch.Tensor:
    """hashes (B, n, 32) uint8 -> (32,) int64: for each bit position, how
    many little-endian 32-bit hash words of the first `nvalid` blocks
    (all B when None) have that bit set.  Sums from several slices add
    up; `finish_scrub` turns the total into the fold."""
    b = hashes.shape[0]
    dev = hashes.device
    hw = hashes.reshape(b, -1, 4).to(torch.int64)
    words = hw[..., 0] | (hw[..., 1] << 8) | (hw[..., 2] << 16) | (hw[..., 3] << 24)
    bitpos = torch.arange(32, dtype=torch.int64, device=dev)
    bits = (words[..., None] >> bitpos) & 1  # (B, W, 32)
    if nvalid is not None:
        valid = (torch.arange(b, device=dev) < _int64_on(dev, nvalid)).to(torch.int64)
        bits = bits * valid[:, None, None]
    return bits.sum(dim=(0, 1))


def finish_scrub(bit_sums: torch.Tensor, count) -> torch.Tensor:
    """(32,) per-bit sums and the block count -> int64 [count, fold]: the
    exact XOR-fold of the hash words is each bit's sum mod 2 (the
    reference's formulation, an add-reduce that splits across devices)."""
    dev = bit_sums.device
    bitpos = torch.arange(32, dtype=torch.int64, device=dev)
    fold = ((bit_sums & 1) << bitpos).sum()
    return torch.stack([_int64_on(dev, count), fold])


def scrub_stats(hashes: torch.Tensor, nvalid=None) -> torch.Tensor:
    """hashes (B, n, 32) uint8 -> int64 tensor [count, fold]: the block
    count (or `nvalid`) and the XOR-fold of every hash word of the first
    `nvalid` blocks."""
    count = hashes.shape[0] if nvalid is None else nvalid
    return finish_scrub(scrub_bit_sums(hashes, nvalid), count)


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
        self._enc_bitmats = {
            self.device: coding_state_from_numpy(
                gf.cauchy_parity_matrix(k, m), self.device
            )["bitmat"],
        }

    def _enc_bitmat(self, dev: torch.device) -> torch.Tensor:
        """The encode bit-matrix on `dev`, copied there once."""
        bm = self._enc_bitmats.get(dev)
        if bm is None:
            bm = self._enc_bitmats[dev] = self._enc_bitmats[self.device].to(dev)
        return bm

    def _check(self, data: torch.Tensor) -> None:
        if data.dim() != 3 or data.shape[1:] != (self.k, self.shard_bytes):
            raise ValueError(
                f"expected (B, {self.k}, {self.shard_bytes}), got {tuple(data.shape)}"
            )

    def encode_and_hash_fn(self):
        """fn: data (B, k, S) uint8 on the pipeline's device ->
        (parity (B, m, S), hashes (B, k+m, 32), scrub_stats (2,) int64).
        `nvalid` masks trailing zero-pad blocks out of the statistics."""
        enc_bitmat = self._enc_bitmat(self.device)

        def fwd(data: torch.Tensor, nvalid=None):
            self._check(data)
            parity, hashes = encode_hash_tensor(enc_bitmat, data)
            return parity, hashes, scrub_stats(hashes, nvalid)

        return fwd

    def example_batch(self, batch: int = 4, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(
            0, 256, (batch, self.k, self.shard_bytes), dtype=np.uint8
        )

    # --- multi-device step ----------------------------------------------------

    def sharded_step(self, mesh: Mesh):
        """step(parts, nvalid) -> (parities, hashes, stats): `parts[i]`
        is entry i's (per, k, S) slice on `mesh.devices[i]`, `nvalid` the
        number of real blocks in the whole padded batch.  Each entry runs
        K1 then K2 on its slice under its own stream and sums the scrub
        bits of its real blocks, masked by clamp(nvalid - i*per, 0, per);
        the streams are joined and the sums added on the first entry's
        device.  Returns the entries' parity and hash slices (on their
        devices) and stats [nvalid, fold]."""
        bitmats = [self._enc_bitmat(dev) for dev in mesh.devices]

        def one(_dev, bm, x, valid):
            self._check(x)
            parity, hashes = encode_hash_tensor(bm, x)
            return parity, hashes, scrub_bit_sums(hashes, valid)

        def step(parts: list[torch.Tensor], nvalid: int):
            per = parts[0].shape[0]
            valid = [min(max(nvalid - i * per, 0), per) for i in range(mesh.size)]
            outs = mesh.map(one, bitmats, parts, valid)
            mesh.join([t for o in outs for t in o])
            home = mesh.devices[0]
            bit_sums = sum(o[2].to(home) for o in outs)
            return [o[0] for o in outs], [o[1] for o in outs], finish_scrub(bit_sums, nvalid)

        return step

    def sharded_apply(self, mesh: Mesh, data: np.ndarray):
        """Host entry for the mesh step with any batch size: sizes the
        block batch with `mesh_rows`, places each entry's slice on its
        device with its zero pad rows (`Mesh.scatter`), runs
        `sharded_step`, gathers to the host and slices the pad rows off.
        Returns numpy (parity, hashes, stats), the stats covering only the
        real blocks.  Synchronous: it ends in the device->host copies."""
        b = data.shape[0]
        x = torch.from_numpy(np.require(data, np.uint8, ("C", "W")))
        parts = mesh.scatter(x, mesh_rows(b, mesh.size))
        parities, hashes, stats = self.sharded_step(mesh)(parts, b)
        return (
            mesh.gather(parities)[:b].numpy(),
            mesh.gather(hashes)[:b].numpy(),
            stats.cpu().numpy(),
        )
