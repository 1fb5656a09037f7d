"""Object checksums: x-amz-checksum-{crc32,crc32c,sha1,sha256}
(reference src/api/common/signature/checksum.rs).

The client declares a checksum (base64) on upload; we compute it over the
plaintext stream, reject mismatches, persist it in the object metadata and
return it on GET/HEAD.
crc32c (Castagnoli) is table-driven Python — fine at block granularity;
the native extension can take it over later.
"""

from __future__ import annotations

import base64
import hashlib
import zlib

from .error import BadRequest

ALGOS = ("crc32", "crc32c", "sha1", "sha256")
HEADER_PREFIX = "x-amz-checksum-"

# --- crc32c (Castagnoli, reflected, poly 0x1EDC6F41) -------------------------

_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC32C_TABLE.append(_c)


class Crc32c:
    def __init__(self):
        self._crc = 0xFFFFFFFF

    def update(self, data: bytes) -> None:
        crc = self._crc
        table = _CRC32C_TABLE
        for b in data:
            crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
        self._crc = crc

    def digest(self) -> bytes:
        return ((self._crc ^ 0xFFFFFFFF) & 0xFFFFFFFF).to_bytes(4, "big")


class Crc32:
    def __init__(self):
        self._crc = 0

    def update(self, data: bytes) -> None:
        self._crc = zlib.crc32(data, self._crc)

    def digest(self) -> bytes:
        return (self._crc & 0xFFFFFFFF).to_bytes(4, "big")


def _hasher(algo: str):
    if algo == "crc32":
        return Crc32()
    if algo == "crc32c":
        return Crc32c()
    return hashlib.new(algo)


class ChecksumRequest:
    """One declared upload checksum: algorithm + expected base64 value."""

    def __init__(self, algo: str, expected_b64: str | None):
        self.algo = algo
        self.expected_b64 = expected_b64  # None until the trailer arrives
        self.hasher = _hasher(algo)

    def resolve_trailer(self, trailers: dict[str, str]) -> None:
        if self.expected_b64 is None:
            self.expected_b64 = trailers.get(HEADER_PREFIX + self.algo, "").strip()
            if not self.expected_b64:
                raise BadRequest(
                    f"declared trailer checksum {self.algo} missing from trailers"
                )

    @classmethod
    def from_headers(cls, headers) -> "ChecksumRequest | None":
        h = {k.lower(): v for k, v in headers.items()}
        found = [a for a in ALGOS if HEADER_PREFIX + a in h]
        if not found:
            # a trailer declaration means the value arrives AFTER the body
            trailer = h.get("x-amz-trailer", "").strip().lower()
            if trailer.startswith(HEADER_PREFIX):
                algo = trailer[len(HEADER_PREFIX):]
                if algo in ALGOS:
                    return cls(algo, None)
            return None
        if len(found) > 1:
            raise BadRequest("multiple checksum headers supplied")
        algo = found[0]
        return cls(algo, h[HEADER_PREFIX + algo].strip())

    def update(self, data: bytes) -> None:
        self.hasher.update(data)

    def verify(self) -> dict:
        """-> {"algo": .., "b64": ..} for the object meta; raises on
        mismatch."""
        got = base64.b64encode(self.hasher.digest()).decode()
        if got != self.expected_b64:
            raise BadRequest(
                f"checksum mismatch: computed {got}, header said "
                f"{self.expected_b64}",
                code="BadDigest",
            )
        return {"algo": self.algo, "b64": got}


def response_headers(meta: dict) -> dict[str, str]:
    cks = meta.get("cks")
    if not cks:
        return {}
    return {HEADER_PREFIX + cks["algo"]: cks["b64"]}
