"""A codec of the reference's own parts, with the calls the port's codec
plane makes (`encode_batch_hashed`, `decode_batch`, `reconstruct_batch`).

It stands in the program's place for the control: with `parity="xor"`
every parity piece is the XOR of the data shards, a cheaper code that
breaks the configuration's guarantee that any k of the k+m pieces
rebuild a block.  The tests that break the timed path on purpose use it
with the Cauchy code too.
"""

from __future__ import annotations

import numpy as np

from . import blake3, gf256
from .layout import piece_len, split


class ReferenceCodec:
    def __init__(self, k: int, m: int, parity: str = "cauchy"):
        self.k, self.m = k, m
        self.n_pieces, self.min_pieces = k + m, k
        self.parity = None if parity == "cauchy" else np.ones((m, k), dtype=np.uint8)

    def piece_len(self, block_len: int) -> int:
        return piece_len(block_len, self.k)

    def encode_batch_hashed(self, blocks, impl="auto"):
        coded = []
        for b in blocks:
            data = split(b, self.k)
            coded.append(np.concatenate([data, gf256.encode(data, self.m, self.parity)]))
        out = []
        by_len: dict[int, list[int]] = {}
        for i, c in enumerate(coded):
            by_len.setdefault(c.shape[1], []).append(i)
        digests: dict[int, np.ndarray] = {}
        for _s, idx in by_len.items():
            h = blake3.hash_rows(np.concatenate([coded[i] for i in idx]))
            for j, i in enumerate(idx):
                digests[i] = h[j * self.n_pieces:(j + 1) * self.n_pieces]
        for i, c in enumerate(coded):
            out.append(([row.tobytes() for row in c], [d.tobytes() for d in digests[i]]))
        return out

    def _rows(self, pieces: dict[int, bytes], want: list[int]) -> np.ndarray:
        arrs = {p: np.frombuffer(b, dtype=np.uint8) for p, b in pieces.items()}
        return gf256.rebuild(self.k, self.m, arrs, want, self.parity)

    def decode_batch(self, items, impl="auto"):
        return [self._rows(p, list(range(self.k))).tobytes()[:blen] for p, blen in items]

    def reconstruct_batch(self, batches, impl="auto"):
        return [{w: row.tobytes() for w, row in zip(want, self._rows(p, list(want)))}
                for p, want, _blen in batches]
