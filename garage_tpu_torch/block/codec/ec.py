"""Erasure codec: GF(2^8) Cauchy Reed-Solomon, on the card or on the host.

A block becomes k data shards + m parity shards; any k of the k+m pieces
reconstruct it.  Shard size is padded to a multiple of 64 bytes so every
piece can be BLAKE3-hashed by the batched kernel.

Two backends serve the same calls, chosen by the `impl` policy of the
batched methods (`[block] batch_impl` for the block store):

  codec device   "auto"              "host"              "xla"
  CUDA           the card (K3 / K1)  native host codec   the card
  CPU            native host codec   native host codec   EcCuda's plain version

The card path sends EVERY batch to the device, a batch of one included:
on a CUDA codec the scalar API (`encode`, `decode`, `reconstruct_pieces`)
is a batch of one.  (The reference routes small batches to its native
host codec; here the card is never bypassed unless the caller asks.)
Reconstructions are grouped by erasure pattern, so thousands of blocks
repair in a handful of dispatches, and `encode_batch`, `decode_batch`
and `reconstruct_batch` fan large batches out over a mesh of devices
(`n_devices` or `mesh`, passed to `EcCuda`; by default every visible
card), as the reference's do; the fused `encode_batch_hashed` stays on
one device.

The host backend is the reference's: per-block loops over the native
C++ codec (`ops/gf.apply_matrix`, _native/gf8.cpp) and native BLAKE3,
with no batch stacking — every heavy step is a ctypes call that
releases the GIL, while numpy stacks would hold it inside the batcher's
worker thread.  On a CPU codec the scalar API takes it too.  It counts
under `path="numpy"` and records `ec_encode_host` / `ec_decode_host`
dispatches on the "host" platform, the reference's labels.  Nothing
falls back: a CUDA codec whose kernel fails raises, and so does a
failed native build.
"""

from __future__ import annotations

import numpy as np

from ... import _native
from ...ops import gf, telemetry
from ...ops.ec_cuda import EcCuda
from ...parallel.mesh import Mesh
from ...utils.metrics import registry
from .base import BlockCodec

SHARD_ALIGN = 64  # blake3 batch hashing wants multiples of 64 bytes
IMPLS = ("auto", "host", "xla")  # the `impl` policy's spellings (the config's)
HOST_PATH = "numpy"  # the host backend's `path` label (the reference's)


def _count(op: str, path: str, blocks: int, nbytes: int) -> None:
    """Codec-layer view of which path served how many blocks/bytes:
    `path` is the codec's device type ("cuda" or "cpu") on the card path,
    "numpy" on the host backend, or "systematic" for a decode that only
    joined the k data shards."""
    lbl = (("op", op), ("path", path))
    registry.incr("block_codec_blocks_total", lbl, blocks)
    registry.incr("block_codec_bytes_total", lbl, nbytes)


class EcCodec(BlockCodec):
    def __init__(self, k: int, m: int, device="cuda", n_devices: int | None = None,
                 mesh: Mesh | None = None):
        self.k, self.m = k, m
        self.n_pieces = k + m
        self.min_pieces = k
        self._ec = EcCuda(k, m, device=device, n_devices=n_devices, mesh=mesh)
        self.device = self._ec.device
        self._path = self.device.type
        self._parity_mat = gf.cauchy_parity_matrix(k, m)

    def _on_host(self, impl: str) -> bool:
        """The `impl` policy: True where the native host codec serves the
        call ("host", or "auto" on a CPU codec), False where EcCuda does."""
        if impl not in IMPLS:
            raise ValueError(f"invalid codec impl {impl!r}: want one of {IMPLS}")
        if impl == "auto":
            return telemetry.runs_on_host(self.device)
        return impl == "host"

    def piece_len(self, block_len: int) -> int:
        s = (block_len + self.k - 1) // self.k
        return (s + SHARD_ALIGN - 1) // SHARD_ALIGN * SHARD_ALIGN

    def _split(self, block: bytes) -> np.ndarray:
        s = self.piece_len(len(block))
        if len(block) == self.k * s:
            # aligned block (the common case: block_size is a multiple of
            # k * 64): a zero-copy read-only view
            return np.frombuffer(block, dtype=np.uint8).reshape(self.k, s)
        buf = np.zeros(self.k * s, dtype=np.uint8)
        buf[: len(block)] = np.frombuffer(block, dtype=np.uint8)
        return buf.reshape(self.k, s)

    def _gather(self, pieces: dict[int, bytes], present: tuple, s: int) -> np.ndarray:
        """(k, s) surviving shards in `present` order."""
        for p in present:
            if len(pieces[p]) != s:
                raise ValueError(f"piece {p} has {len(pieces[p])} bytes, expected {s}")
        return np.stack([np.frombuffer(pieces[p], dtype=np.uint8) for p in present])

    def _present(self, pieces: dict[int, bytes], what: str) -> tuple[int, ...]:
        if len(pieces) < self.k:
            raise ValueError(
                f"{what}: need {self.k} pieces to reconstruct, have {len(pieces)}"
            )
        return tuple(sorted(pieces.keys())[: self.k])

    def _by_size(self, blocks: list[bytes]) -> dict[int, list[int]]:
        groups: dict[int, list[int]] = {}
        for idx, b in enumerate(blocks):
            groups.setdefault(self.piece_len(len(b)), []).append(idx)
        return groups

    # --- scalar API: the host codec on a CPU codec, else a batch of one -----------

    def encode(self, block: bytes) -> list[bytes]:
        return self.encode_batch([block])[0]

    def decode(self, pieces: dict[int, bytes], block_len: int) -> bytes:
        if self._on_host("auto"):
            return self._decode_host(pieces, block_len)
        return self.decode_batch([(pieces, block_len)])[0]

    def reconstruct_pieces(
        self, pieces: dict[int, bytes], want: list[int], block_len: int
    ) -> dict[int, bytes]:
        return self.reconstruct_batch([(pieces, want, block_len)])[0]

    # --- batched API -------------------------------------------------------------

    def encode_batch(self, blocks: list[bytes], impl: str = "auto") -> list[list[bytes]]:
        """One encode dispatch per shard-size group (the host backend:
        one native call per block)."""
        if self._on_host(impl):
            return [self._encode_host(b) for b in blocks]
        out: list[list[bytes] | None] = [None] * len(blocks)
        for _s, idxs in self._by_size(blocks).items():
            data = np.stack([self._split(blocks[i]) for i in idxs])  # (B,k,s)
            _count("encode", self._path, len(idxs), data.nbytes)
            parity = self._ec.encode(data)  # (B,m,s)
            for j, i in enumerate(idxs):
                out[i] = [bytes(data[j, x]) for x in range(self.k)] + [
                    bytes(parity[j, x]) for x in range(self.m)
                ]
        return out  # type: ignore[return-value]

    def encode_batch_hashed(
        self, blocks: list[bytes], impl: str = "auto"
    ) -> list[tuple[list[bytes], list[bytes] | None]]:
        """ONE fused encode + BLAKE3 dispatch per shard-size group:
        `[(pieces, piece_hashes | None)]` aligned with `blocks` — the
        codec batcher's encode-lane backend.  Piece hashes cover all k+m
        pieces in piece order; on the card path None when the shard
        length is outside the batched hasher's set (the receiving node
        then hashes), on the host backend always present."""
        if self._on_host(impl):
            return self._encode_hashed_host(blocks)
        out: list[tuple[list[bytes], list[bytes] | None] | None] = [None] * len(blocks)
        for _s, idxs in self._by_size(blocks).items():
            data = np.stack([self._split(blocks[i]) for i in idxs])  # (B,k,s)
            _count("encode", self._path, len(idxs), data.nbytes)
            parity, hashes = self._ec.encode_and_hash(data)
            for j, i in enumerate(idxs):
                pieces = [bytes(data[j, x]) for x in range(self.k)] + [
                    bytes(parity[j, x]) for x in range(self.m)
                ]
                hs = (
                    None
                    if hashes is None
                    else [bytes(hashes[j, x]) for x in range(self.n_pieces)]
                )
                out[i] = (pieces, hs)
        return out  # type: ignore[return-value]

    def note_systematic_read(self, block_len: int) -> None:
        """A streamed systematic GET joins the k data shards outside the
        codec; it reports here so the decode split stays honest."""
        _count("decode", "systematic", 1, self.k * self.piece_len(block_len))

    def decode_batch(
        self, items: list[tuple[dict[int, bytes], int]], impl: str = "auto"
    ) -> list[bytes]:
        """ONE reconstruction dispatch per erasure-pattern/shard-size
        group: `[plaintext]` aligned with `items` — the codec batcher's
        decode-lane backend.  Items whose k data shards all arrived are
        systematic joins and never touch the device."""
        if self._on_host(impl):
            return self._decode_batch_host(items)
        out: list[bytes | None] = [None] * len(items)
        groups: dict[tuple, list[int]] = {}
        for idx, (pieces, block_len) in enumerate(items):
            if all(i in pieces for i in range(self.k)):
                self.note_systematic_read(block_len)
                out[idx] = b"".join(pieces[i] for i in range(self.k))[:block_len]
                continue
            present = self._present(pieces, "decode")
            want = tuple(i for i in range(self.k) if i not in pieces)
            groups.setdefault(
                (present, want, self.piece_len(block_len)), []
            ).append(idx)
        for (present, want, s), idxs in groups.items():
            shards = np.stack([self._gather(items[i][0], present, s) for i in idxs])
            _count("decode", "reconstruct", len(idxs), shards.nbytes)
            _count("reconstruct", self._path, len(idxs), shards.nbytes)
            rec = self._ec.reconstruct(shards, list(present), list(want))
            for j, i in enumerate(idxs):
                pieces, block_len = items[i]
                full = {**pieces}
                for x, w in enumerate(want):
                    full[w] = bytes(rec[j, x])
                out[i] = b"".join(full[r] for r in range(self.k))[:block_len]
        return out  # type: ignore[return-value]

    def reconstruct_batch(
        self, batches: list[tuple[dict[int, bytes], list[int], int]], impl: str = "auto"
    ) -> list[dict[int, bytes]]:
        """[(pieces, want, block_len)] -> [{piece index: bytes}], one
        dispatch per (erasure pattern, want, shard size) group."""
        present_of = [self._present(p, f"batch entry {idx}")
                      for idx, (p, _w, _n) in enumerate(batches)]
        if self._on_host(impl):
            return [self._reconstruct_host(p, w, n) for p, w, n in batches]
        out: list[dict[int, bytes] | None] = [None] * len(batches)
        groups: dict[tuple, list[int]] = {}
        for idx, (present, (_p, want, block_len)) in enumerate(zip(present_of, batches)):
            key = (present, tuple(sorted(want)), self.piece_len(block_len))
            groups.setdefault(key, []).append(idx)
        for (present, want, s), idxs in groups.items():
            shards = np.stack([self._gather(batches[i][0], present, s) for i in idxs])
            _count("reconstruct", self._path, len(idxs), shards.nbytes)
            rec = self._ec.reconstruct(shards, list(present), list(want))
            for j, i in enumerate(idxs):
                out[i] = {w: bytes(rec[j, x]) for x, w in enumerate(want)}
        return out  # type: ignore[return-value]

    # --- the host backend (the reference's native codec paths) ---------------------

    def _encode_pieces(self, block: bytes) -> list[bytes]:
        data = self._split(block)  # zero-copy view when aligned
        parity = gf.apply_matrix(self._parity_mat, data)
        return [bytes(data[i]) for i in range(self.k)] + [
            bytes(parity[i]) for i in range(self.m)
        ]

    def _encode_host(self, block: bytes) -> list[bytes]:
        _count("encode", HOST_PATH, 1, self.k * self.piece_len(len(block)))
        return self._encode_pieces(block)

    def _encode_hashed_host(
        self, blocks: list[bytes]
    ) -> list[tuple[list[bytes], list[bytes]]]:
        """A per-block loop over the native codec and native BLAKE3, one
        telemetry record for the batch.  The host path never pads, so its
        pad-waste is an honest 0."""
        nbytes = sum(self.k * self.piece_len(len(b)) for b in blocks)
        _count("encode", HOST_PATH, len(blocks), nbytes)
        out = []
        with telemetry.dispatch("ec_encode_host", "host", len(blocks), nbytes) as rec:
            rec.pad(len(blocks), len(blocks))
            with rec.compute():
                for block in blocks:
                    pieces = self._encode_pieces(block)
                    out.append((pieces, [_native.blake3(p) for p in pieces]))
        return out

    def _decode_host(self, pieces: dict[int, bytes], block_len: int) -> bytes:
        if all(i in pieces for i in range(self.k)):
            self.note_systematic_read(block_len)
            return b"".join(pieces[i] for i in range(self.k))[:block_len]
        # a degraded decode counts on the GET view (op="decode") besides
        # the op="reconstruct" count it shares with the repair plane
        _count("decode", "reconstruct", 1, self.k * self.piece_len(block_len))
        missing = [i for i in range(self.k) if i not in pieces]
        full = {**pieces, **self._reconstruct_host(pieces, missing, block_len)}
        return b"".join(full[i] for i in range(self.k))[:block_len]

    def _decode_batch_host(self, items: list[tuple[dict[int, bytes], int]]) -> list[bytes]:
        nbytes = sum(self.k * self.piece_len(n) for _p, n in items)
        with telemetry.dispatch("ec_decode_host", "host", len(items), nbytes) as rec:
            rec.pad(len(items), len(items))
            with rec.compute():
                return [self._decode_host(p, n) for p, n in items]

    def _reconstruct_host(
        self, pieces: dict[int, bytes], want: list[int], block_len: int
    ) -> dict[int, bytes]:
        present = self._present(pieces, "reconstruct")
        s = self.piece_len(block_len)
        _count("reconstruct", HOST_PATH, 1, self.k * s)
        rmat = gf.reconstruction_matrix(self.k, self.m, list(present), list(want))
        rec = gf.apply_matrix(rmat, self._gather(pieces, present, s))
        return {w: bytes(rec[j]) for j, w in enumerate(want)}
