"""Fixed 32-byte identifiers and content hashes.

Mirrors reference src/util/data.rs:9 (FixedBytes32 / Uuid / Hash): node ids,
object-version uuids and block hashes are all 32-byte values, ordered
lexicographically, rendered as lowercase hex.  Content hashing uses
BLAKE2b-256 (hashlib, same construction as the reference's blake2 crate).
"""

from __future__ import annotations

import hashlib
import os

# A FixedBytes32 is simply `bytes` of length 32; these aliases document intent.
FixedBytes32 = bytes
Uuid = bytes
Hash = bytes

ZERO32: bytes = b"\x00" * 32


def gen_uuid() -> Uuid:
    """Random 128-bit-entropy 32-byte uuid (reference src/util/data.rs:122)."""
    return os.urandom(32)


def blake2sum(data: bytes) -> Hash:
    """Content hash: BLAKE2b-512 truncated to 32 bytes — same construction
    as the reference (src/util/data.rs:129-138), NOT blake2b with
    digest_size=32 (different parameter block, different output)."""
    return hashlib.blake2b(data).digest()[:32]


def sha256sum(data: bytes) -> Hash:
    return hashlib.sha256(data).digest()


def md5sum(data: bytes) -> bytes:
    return hashlib.md5(data).digest()


def hex_of(b: bytes) -> str:
    return b.hex()


def parse_hex(s: str) -> bytes:
    b = bytes.fromhex(s)
    if len(b) != 32:
        raise ValueError(f"expected 32 bytes, got {len(b)}")
    return b


def fixed_from_str(s: str) -> FixedBytes32:
    """Hash a human string into an id (used for bucket ids in tests)."""
    return blake2sum(s.encode())


def xxh3_u64(data: bytes) -> int:
    """64-bit non-cryptographic hash (reference src/util/data.rs:141 uses
    xxhash; stdlib has none, so we take the first 8 bytes of blake2b —
    only used for non-persisted in-memory purposes)."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


def hash_partition_prefix(h: bytes) -> int:
    """Top 16 bits of a hash — used with PARTITION_BITS to derive partition.

    Reference src/rpc/layout/version.rs:101-104 uses the top 8 bits (256
    partitions); we keep the helper generic and mask in the layout code.
    """
    return (h[0] << 8) | h[1]
