"""BlockCodec: how a logical block maps onto stored pieces.

The seam between the block store and the device math.  A codec decides
how many pieces a block becomes, which subset suffices to reconstruct
it, and how reconstruction happens.

Piece indices: 0..n_pieces-1.  For ReplicaCodec n_pieces == 1 (the single
piece IS the block, each replica node stores it).  For EcCodec(k, m)
n_pieces == k+m and any k pieces reconstruct.
"""

from __future__ import annotations


class BlockCodec:
    n_pieces: int = 1
    min_pieces: int = 1  # how many distinct pieces reconstruct a block

    def encode(self, block: bytes) -> list[bytes]:
        """block -> n_pieces stored pieces."""
        raise NotImplementedError

    def decode(self, pieces: dict[int, bytes], block_len: int) -> bytes:
        """>= min_pieces pieces -> original block (exact length)."""
        raise NotImplementedError

    def reconstruct_pieces(
        self, pieces: dict[int, bytes], want: list[int], block_len: int
    ) -> dict[int, bytes]:
        """Rebuild specific missing pieces from surviving ones."""
        raise NotImplementedError

    # --- batched (default falls back to the scalar API) ----------------------

    def encode_batch(self, blocks: list[bytes]) -> list[list[bytes]]:
        return [self.encode(b) for b in blocks]

    def reconstruct_batch(
        self,
        batches: list[tuple[dict[int, bytes], list[int], int]],
        impl: str = "auto",
    ) -> list[dict[int, bytes]]:
        """[(pieces, want, block_len)] -> [reconstructed pieces]; `impl`
        is the backend policy of block/codec/ec.py (one path here)."""
        return [self.reconstruct_pieces(p, w, n) for p, w, n in batches]

    def decode_batch(
        self, items: list[tuple[dict[int, bytes], int]], impl: str = "auto"
    ) -> list[bytes]:
        """[(pieces, block_len)] -> [plaintext blocks] — the codec
        batcher's decode-lane backend (block/codec_batch.py); default
        falls back to the scalar decode."""
        return [self.decode(p, n) for p, n in items]

    def piece_len(self, block_len: int) -> int:
        raise NotImplementedError
