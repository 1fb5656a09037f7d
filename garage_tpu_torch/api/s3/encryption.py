"""SSE-C: server-side encryption with customer-provided keys
(reference src/api/s3/encryption.rs:54-305).

The customer supplies a 256-bit key per request
(`x-amz-server-side-encryption-customer-{algorithm,key,key-MD5}`); each
block is sealed independently with AES-256-GCM (12-byte random nonce +
16-byte tag framed around the ciphertext), so ranged reads only decrypt
the blocks they touch.  Blocks are content-addressed by their CIPHERTEXT
hash (random nonces make ciphertext non-deterministic, so SSE-C blocks do
not deduplicate); plaintext never leaves the API process unencrypted.  The object records only the algorithm + key MD5; the server
stores no key material.
"""

from __future__ import annotations

import base64
import hashlib
import os

try:  # SSE-C needs real AES-GCM; everything else works without it
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:
    AESGCM = None

from ..common.error import ApiError, BadRequest

ALG_HEADER = "x-amz-server-side-encryption-customer-algorithm"
KEY_HEADER = "x-amz-server-side-encryption-customer-key"
MD5_HEADER = "x-amz-server-side-encryption-customer-key-md5"
# UploadPartCopy names the SOURCE key with these (AWS spec: the
# "x-amz-copy-source-" prefix replaces the leading "x-amz-", it does not
# stack on top of it)
COPY_ALG_HEADER = "x-amz-copy-source-server-side-encryption-customer-algorithm"

NONCE_LEN = 12
TAG_LEN = 16
OVERHEAD = NONCE_LEN + TAG_LEN  # per stored block


class EncryptionParams:
    """Parsed + validated SSE-C request parameters."""

    def __init__(self, key: bytes, key_md5_b64: str):
        if AESGCM is None:
            raise BadRequest(
                "SSE-C unavailable: the 'cryptography' package is not "
                "installed on this server"
            )
        self.key = key
        self.key_md5_b64 = key_md5_b64
        self._aead = AESGCM(key)

    @classmethod
    def from_headers(cls, headers, copy_source: bool = False) -> "EncryptionParams | None":
        def hname(base: str) -> str:
            if copy_source:
                return "x-amz-copy-source-" + base[len("x-amz-"):]
            return base

        h = {k.lower(): v for k, v in headers.items()}
        alg = h.get(hname(ALG_HEADER))
        if alg is None:
            if hname(KEY_HEADER) in h or hname(MD5_HEADER) in h:
                raise BadRequest("SSE-C key supplied without algorithm header")
            return None
        if alg != "AES256":
            raise BadRequest(f"unsupported SSE-C algorithm {alg!r}")
        try:
            key = base64.b64decode(h.get(hname(KEY_HEADER), ""))
        except Exception as e:
            raise BadRequest(f"bad SSE-C key encoding: {e}") from e
        if len(key) != 32:
            raise BadRequest("SSE-C key must be 256 bits")
        md5_b64 = h.get(hname(MD5_HEADER), "")
        if base64.b64encode(hashlib.md5(key).digest()).decode() != md5_b64:
            raise BadRequest("SSE-C key MD5 mismatch")
        return cls(key, md5_b64)

    @classmethod
    def from_copy_source_headers(cls, headers) -> "EncryptionParams | None":
        """The x-amz-copy-source-server-side-encryption-customer-* key
        naming the SOURCE object of an UploadPartCopy (reference
        encryption.rs)."""
        return cls.from_headers(headers, copy_source=True)

    # --- block sealing --------------------------------------------------------

    def encrypt_block(self, plaintext: bytes) -> bytes:
        nonce = os.urandom(NONCE_LEN)
        return nonce + self._aead.encrypt(nonce, plaintext, None)

    def decrypt_block(self, stored: bytes) -> bytes:
        if len(stored) < OVERHEAD:
            raise ApiError("encrypted block too short", status=500)
        try:
            return self._aead.decrypt(stored[:NONCE_LEN], stored[NONCE_LEN:], None)
        except Exception as e:
            raise ApiError(
                "decryption failed (wrong SSE-C key?)",
                code="AccessDenied",
                status=403,
            ) from e

    def meta(self) -> dict:
        return {"alg": "AES256", "md5": self.key_md5_b64}

    def response_headers(self) -> dict[str, str]:
        return {
            ALG_HEADER: "AES256",
            MD5_HEADER: self.key_md5_b64,
        }


def check_match(meta_enc: dict | None, params: EncryptionParams | None) -> None:
    """An encrypted object requires the matching key; a plain object
    requires no key (reference encryption.rs check)."""
    if meta_enc is None and params is None:
        return
    if meta_enc is None:
        raise BadRequest("object is not SSE-C encrypted")
    if params is None:
        raise ApiError(
            "object is SSE-C encrypted: key headers required",
            code="BadRequest",
            status=400,
        )
    if meta_enc.get("md5") != params.key_md5_b64:
        raise ApiError("wrong SSE-C key", code="AccessDenied", status=403)
