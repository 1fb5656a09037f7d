"""Crypto primitives for the handshake, with a stdlib fallback.

When the `cryptography` package is installed, this module re-exports the
real primitives and `HAVE_REAL_CRYPTO` is True — nothing changes.

When it is missing (stripped test/CI containers), a stdlib-only fallback
with the same *API shape* is provided so the whole net/rpc/chaos stack
stays importable and testable.  THE FALLBACK IS NOT SECURE:

  - "ed25519" keys are random 32-byte strings; the public key is a hash
    of the private key; "signatures" are HMACs keyed by the PUBLIC key,
    so anyone who knows a node's id can forge its signature.
  - "x25519" exchange derives the shared secret from the two public
    values only — an eavesdropper can compute it.
  - "ChaCha20Poly1305" frames are NOT encrypted: payload + a 16-byte
    HMAC-SHA256 tag (integrity/auth against accidental corruption only).

What survives in fallback mode: cluster membership still requires the
shared network key (the hello HMAC in handshake.py uses stdlib hmac), and
frames are integrity-checked.  What is lost: confidentiality and
third-party-unforgeable node identity.  That is acceptable for loopback
dev clusters and tests, and useless against a real adversary — so
handshake.py swaps the protocol VERSION_TAG in fallback mode, making a
fallback node and a real-crypto node refuse each other at the first hello
instead of silently downgrading a production cluster.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import logging
import os

logger = logging.getLogger("garage.net")

try:  # real primitives
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    HAVE_REAL_CRYPTO = True
except ImportError:  # stdlib fallback
    HAVE_REAL_CRYPTO = False
    logger.warning(
        "python 'cryptography' package unavailable: using the INSECURE "
        "stdlib transport fallback (authenticated by network key only, "
        "no encryption). Do not expose RPC ports on untrusted networks."
    )

    class _InvalidSignature(Exception):
        pass

    class Ed25519PublicKey:  # type: ignore[no-redef]
        def __init__(self, raw: bytes):
            self._raw = raw

        @classmethod
        def from_public_bytes(cls, raw: bytes) -> "Ed25519PublicKey":
            return cls(bytes(raw))

        def public_bytes_raw(self) -> bytes:
            return self._raw

        def verify(self, signature: bytes, message: bytes) -> None:
            want = hmac_mod.new(
                b"garage-fallback-sig" + self._raw, message, hashlib.sha256
            ).digest()
            if not hmac_mod.compare_digest(signature, want):
                raise _InvalidSignature("fallback signature mismatch")

    class Ed25519PrivateKey:  # type: ignore[no-redef]
        def __init__(self, raw: bytes):
            self._raw = raw

        @classmethod
        def generate(cls) -> "Ed25519PrivateKey":
            return cls(os.urandom(32))

        @classmethod
        def from_private_bytes(cls, raw: bytes) -> "Ed25519PrivateKey":
            return cls(bytes(raw))

        def private_bytes_raw(self) -> bytes:
            return self._raw

        def public_key(self) -> Ed25519PublicKey:
            return Ed25519PublicKey(
                hashlib.sha256(b"garage-fallback-ed25519" + self._raw).digest()
            )

        def sign(self, message: bytes) -> bytes:
            pub = self.public_key().public_bytes_raw()
            return hmac_mod.new(
                b"garage-fallback-sig" + pub, message, hashlib.sha256
            ).digest()

    class X25519PublicKey:  # type: ignore[no-redef]
        def __init__(self, raw: bytes):
            self._raw = raw

        @classmethod
        def from_public_bytes(cls, raw: bytes) -> "X25519PublicKey":
            return cls(bytes(raw))

        def public_bytes_raw(self) -> bytes:
            return self._raw

    class X25519PrivateKey:  # type: ignore[no-redef]
        def __init__(self, raw: bytes):
            self._raw = raw

        @classmethod
        def generate(cls) -> "X25519PrivateKey":
            return cls(os.urandom(32))

        def public_key(self) -> X25519PublicKey:
            return X25519PublicKey(
                hashlib.sha256(b"garage-fallback-x25519" + self._raw).digest()
            )

        def exchange(self, peer: X25519PublicKey) -> bytes:
            # symmetric in the two public values; offers NO secrecy
            a = self.public_key().public_bytes_raw()
            b = peer.public_bytes_raw()
            lo, hi = (a, b) if a <= b else (b, a)
            return hashlib.sha256(b"garage-fallback-dh" + lo + hi).digest()

    class ChaCha20Poly1305:  # type: ignore[no-redef]
        """Tag-only frame protection: plaintext + HMAC-SHA256[:16]."""

        TAG = 16

        def __init__(self, key: bytes):
            self._key = key

        def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
            tag = hmac_mod.new(
                self._key, nonce + (aad or b"") + data, hashlib.sha256
            ).digest()[: self.TAG]
            return data + tag

        def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
            body, tag = data[: -self.TAG], data[-self.TAG :]
            want = hmac_mod.new(
                self._key, nonce + (aad or b"") + body, hashlib.sha256
            ).digest()[: self.TAG]
            if not hmac_mod.compare_digest(tag, want):
                raise ValueError("fallback frame tag mismatch")
            return body


__all__ = [
    "HAVE_REAL_CRYPTO",
    "Ed25519PrivateKey",
    "Ed25519PublicKey",
    "X25519PrivateKey",
    "X25519PublicKey",
    "ChaCha20Poly1305",
]
