"""Whole-copy codec: the reference's replication model (n copies of the
block, one per node in the hash's replica set)."""

from __future__ import annotations

from .base import BlockCodec


class ReplicaCodec(BlockCodec):
    n_pieces = 1
    min_pieces = 1

    def encode(self, block: bytes) -> list[bytes]:
        return [block]

    def decode(self, pieces, block_len: int) -> bytes:
        return pieces[0][:block_len]

    def reconstruct_pieces(self, pieces, want, block_len: int):
        return {i: pieces[0] for i in want}

    def piece_len(self, block_len: int) -> int:
        return block_len
