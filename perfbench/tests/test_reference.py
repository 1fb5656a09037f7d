"""The plain reference against published vectors, against itself, and
against the port at small sizes (the port is called from here only)."""

from __future__ import annotations

import hashlib
import itertools

import numpy as np
import pytest

from perfbench.reference import blake3, gf256, layout
from perfbench.reference.codec import ReferenceCodec


def _pattern(n: int) -> bytes:
    return bytes(i % 251 for i in range(n))


# BLAKE3's official test vectors (test_vectors.json: input i % 251): full
# digests for 0 and 1 bytes, and the leading 16 bytes for lengths that
# reach block chaining, chunk chaining and uneven parent trees
OFFICIAL = {
    0: "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262",
    1: "2d3adedff11b61f14c886e35afa036736dcd87a74d27b5c1510225d0f592e213",
}
PREFIXES = {
    1023: "10108970eeda3eb932baac1428c7a216",
    1024: "42214739f095a406f3fc83deb889744a",
    1025: "d00278ae47eb27b34faecf67b4fe263f",
    2048: "e776b6028c7cd22a4d0ba182a8bf6220",
    3072: "b98cb0ff3623be03326b373de6b90952",
    4096: "015094013f57a5277b59d8475c050104",
    5120: "9cadc15fed8b5d854562b26a9536d970",
    8192: "aae792484c8efe4f19e2ca7d371d8c46",
    16384: "f875d6646de28985646f34ee13be9a57",
    102400: "bc3e3d41a1146b069abffad3c0d44860",
}


@pytest.mark.parametrize("length", sorted(OFFICIAL))
def test_blake3_official_digests(length):
    assert blake3.blake3(_pattern(length)).hex() == OFFICIAL[length]


@pytest.mark.parametrize("length", sorted(PREFIXES))
def test_blake3_official_prefixes(length):
    assert blake3.blake3(_pattern(length)).hex()[:32] == PREFIXES[length]


def test_blake3_rows_hash_alike():
    rows = np.random.default_rng(1).integers(0, 256, (5, 4096), dtype=np.uint8)
    digests = blake3.hash_rows(rows)
    for row, d in zip(rows, digests):
        assert blake3.blake3(row.tobytes()) == d.tobytes()


def test_content_hash_is_cut_blake2b():
    """The content hash the repair verifies against: BLAKE2b-512 cut to
    32 bytes (not BLAKE2b-256), the port's `blake2sum`."""
    from garage_tpu_torch.utils.data import blake2sum

    from perfbench.harness import content_hashes

    blocks = [_pattern(n) for n in (0, 1, 1000, 70000)]
    assert content_hashes(blocks) == [hashlib.blake2b(b).digest()[:32] for b in blocks]
    assert content_hashes(blocks) == [blake2sum(b) for b in blocks]


def test_field_tables():
    for a in range(1, 256):
        assert gf256.MUL[a, gf256.inv(a)] == 1
    # x^8 = x^4 + x^3 + x^2 + 1
    assert gf256.MUL[0x80, 2] == 0x1D


@pytest.mark.parametrize("k,m", [(8, 3), (10, 4), (4, 2)])
def test_any_k_pieces_rebuild(k, m):
    rng = np.random.default_rng(k * 100 + m)
    data = rng.integers(0, 256, (k, 192), dtype=np.uint8)
    coded = np.concatenate([data, gf256.encode(data, m)])
    lost_sets = list(itertools.combinations(range(k + m), m))
    for lost in lost_sets[:: max(1, len(lost_sets) // 60)]:
        pieces = {p: coded[p] for p in range(k + m) if p not in lost}
        assert np.array_equal(gf256.rebuild(k, m, pieces, list(range(k + m))), coded)


def test_xor_code_is_weaker():
    """The control's code: two parity rows are equal, so losing two data
    shards cannot be repaired from them."""
    k, m = 4, 2
    gen = gf256.generator(k, m, np.ones((m, k), dtype=np.uint8))
    with pytest.raises(ValueError):
        gf256.invert(gen[[2, 3, 4, 5]])


@pytest.mark.parametrize("k,m,block_len", [(8, 3, 8 * 1024), (10, 4, 10 * 2048), (4, 2, 3000)])
@pytest.mark.parametrize("impl", ["xla", "host"])
def test_port_agrees_with_reference(k, m, block_len, impl):
    from garage_tpu_torch.block.codec.ec import EcCodec
    from garage_tpu_torch.block.manager import wrap_piece

    codec = EcCodec(k, m, device="cpu")
    ref = ReferenceCodec(k, m)
    rng = np.random.default_rng(block_len)
    blocks = [rng.integers(0, 256, block_len, dtype=np.uint8).tobytes() for _ in range(3)]
    got = codec.encode_batch_hashed(blocks, impl)
    want = ref.encode_batch_hashed(blocks)
    for (gp, gh), (wp, wh), b in zip(got, want, blocks):
        assert gp == wp
        if gh is not None:
            assert gh == wh
        assert [wrap_piece(len(b), p, h) for p, h in zip(gp, gh or [None] * len(gp))] == [
            layout.stored(len(b), np.frombuffer(p, dtype=np.uint8)) for p in wp]
    n = k + m
    for lost in range(n):
        present = [p for p in range(n) if p != lost][:k]
        items = [({p: wp[p] for p in present}, len(b)) for (wp, _h), b in zip(want, blocks)]
        assert codec.decode_batch(items, impl) == ref.decode_batch(items) == blocks
        batches = [(p, [lost], blen) for p, blen in items]
        assert codec.reconstruct_batch(batches, impl) == ref.reconstruct_batch(batches)


def test_layout_matches_the_port():
    from garage_tpu_torch.block.codec.ec import EcCodec

    for k, n in [(8, 1 << 20), (10, 10 << 20), (4, 3000), (3, 1)]:
        assert layout.piece_len(n, k) == EcCodec(k, 1, device="cpu").piece_len(n)
