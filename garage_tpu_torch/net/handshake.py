"""Connection handshake: mutual authentication + session encryption.

Same guarantees as the reference's kuska secret-handshake + box
(src/net/client.rs:55-74, server.rs:69-88) with a Noise-style construction
from the `cryptography` package primitives (NOT a port):

  1. Both sides exchange: version tag, 32-byte nonce, X25519 ephemeral
     public key, and an HMAC(network_key) over those — only holders of the
     cluster's shared network key produce a valid hello (the version tag
     gates incompatible protocol versions up front, reference
     netapp.rs:33-40).
  2. Session keys = HKDF(x25519_shared, salt=network_key, info=nonces):
     one ChaCha20-Poly1305 key per direction; forward secrecy from the
     ephemeral DH.
  3. Over the encrypted channel, each side sends its static ed25519 public
     key (= node id) and a signature over (role tag || its own static key
     || the handshake transcript), proving node identity.  Binding the
     signer's role and static key into the signed message (as the
     reference's secret-handshake does) prevents reflection: a peer that
     only knows the network key cannot echo our own auth frame back as its
     identity proof — the role tag differs per side, and an identical
     frame is rejected outright.  The client may pin an expected peer id.

Frames after the handshake: [u32 len][ChaCha20-Poly1305 ciphertext], nonce
= 4-byte direction tag + 8-byte counter.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import struct
from dataclasses import dataclass

from .crypto_compat import (
    HAVE_REAL_CRYPTO,
    ChaCha20Poly1305,
    Ed25519PrivateKey,
    Ed25519PublicKey,
    X25519PrivateKey,
    X25519PublicKey,
)

# protocol version gate (2: stream flow control).  The insecure stdlib
# fallback transport (crypto_compat.py) announces a DIFFERENT tag, so a
# fallback node and a real-crypto node refuse each other at the first
# hello instead of silently downgrading the cluster's transport security.
VERSION_TAG = b"grg_tpu2" if HAVE_REAL_CRYPTO else b"grg_tpuF"
MAX_FRAME = 20 * 1024


class HandshakeError(Exception):
    pass


@dataclass
class SessionKeys:
    send_key: bytes
    recv_key: bytes
    peer_id: bytes  # peer's ed25519 public key bytes


def _hkdf(key_material: bytes, salt: bytes, info: bytes, n: int) -> bytes:
    prk = hmac_mod.new(salt, key_material, hashlib.sha256).digest()
    out, t, i = b"", b"", 1
    while len(out) < n:
        t = hmac_mod.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:n]


def gen_node_key() -> bytes:
    """Generate an ed25519 private key, returned as 32 raw bytes."""
    return Ed25519PrivateKey.generate().private_bytes_raw()


def node_id_of(privkey_raw: bytes) -> bytes:
    return (
        Ed25519PrivateKey.from_private_bytes(privkey_raw)
        .public_key()
        .public_bytes_raw()
    )


class FramedBox:
    """Length-prefixed AEAD framing over an asyncio stream pair."""

    def __init__(self, reader, writer, keys: SessionKeys):
        self.reader = reader
        self.writer = writer
        self.peer_id = keys.peer_id
        self._send = ChaCha20Poly1305(keys.send_key)
        self._recv = ChaCha20Poly1305(keys.recv_key)
        self._send_ctr = 0
        self._recv_ctr = 0

    def send_frame(self, plaintext: bytes) -> None:
        nonce = b"send" + struct.pack("<Q", self._send_ctr)
        self._send_ctr += 1
        ct = self._send.encrypt(nonce, plaintext, None)
        self.writer.write(struct.pack("<I", len(ct)) + ct)

    async def drain(self) -> None:
        await self.writer.drain()

    async def recv_frame(self) -> bytes:
        hdr = await self.reader.readexactly(4)
        (n,) = struct.unpack("<I", hdr)
        if n > MAX_FRAME + 256:
            raise HandshakeError(f"oversized frame {n}")
        ct = await self.reader.readexactly(n)
        nonce = b"send" + struct.pack("<Q", self._recv_ctr)
        self._recv_ctr += 1
        return self._recv.decrypt(nonce, ct, None)


async def handshake(
    reader,
    writer,
    network_key: bytes,
    node_privkey_raw: bytes,
    is_server: bool,
    expected_peer_id: bytes | None = None,
) -> FramedBox:
    """Run the 3-step handshake; returns the encrypted framed channel."""
    my_nonce = os.urandom(32)
    eph = X25519PrivateKey.generate()
    eph_pub = eph.public_key().public_bytes_raw()

    hello_body = VERSION_TAG + my_nonce + eph_pub
    mac = hmac_mod.new(network_key, hello_body, hashlib.sha256).digest()
    writer.write(hello_body + mac)
    await writer.drain()

    peer_hello = await reader.readexactly(len(hello_body) + 32)
    peer_body, peer_mac = peer_hello[:-32], peer_hello[-32:]
    if not hmac_mod.compare_digest(
        peer_mac, hmac_mod.new(network_key, peer_body, hashlib.sha256).digest()
    ):
        raise HandshakeError("peer does not know the network key")
    if peer_body[: len(VERSION_TAG)] != VERSION_TAG:
        raise HandshakeError(
            f"protocol version mismatch: {peer_body[:len(VERSION_TAG)]!r}"
        )
    peer_nonce = peer_body[len(VERSION_TAG) : len(VERSION_TAG) + 32]
    peer_eph = peer_body[len(VERSION_TAG) + 32 :]

    shared = eph.exchange(X25519PublicKey.from_public_bytes(peer_eph))
    # deterministic transcript ordering: server material first
    if is_server:
        info = my_nonce + peer_nonce
        k_server, k_client = (
            _hkdf(shared, network_key, info + b"s2c", 32),
            _hkdf(shared, network_key, info + b"c2s", 32),
        )
        send_key, recv_key = k_server, k_client
    else:
        info = peer_nonce + my_nonce
        k_server, k_client = (
            _hkdf(shared, network_key, info + b"s2c", 32),
            _hkdf(shared, network_key, info + b"c2s", 32),
        )
        send_key, recv_key = k_client, k_server

    keys = SessionKeys(send_key=send_key, recv_key=recv_key, peer_id=b"")
    box = FramedBox(reader, writer, keys)

    # step 3: prove static identity over the encrypted channel
    sk = Ed25519PrivateKey.from_private_bytes(node_privkey_raw)
    my_id = sk.public_key().public_bytes_raw()
    transcript = info + eph_pub + peer_eph if is_server else info + peer_eph + eph_pub
    my_role, peer_role = (b"server", b"client") if is_server else (b"client", b"server")
    sig = sk.sign(b"garage-tpu-auth" + my_role + my_id + transcript)
    my_auth = my_id + sig
    box.send_frame(my_auth)
    await box.drain()

    peer_auth = await box.recv_frame()
    if hmac_mod.compare_digest(peer_auth, my_auth):
        raise HandshakeError("peer echoed our own auth frame (reflection)")
    peer_id, peer_sig = peer_auth[:32], peer_auth[32:]
    try:
        Ed25519PublicKey.from_public_bytes(peer_id).verify(
            peer_sig, b"garage-tpu-auth" + peer_role + peer_id + transcript
        )
    except Exception as e:
        raise HandshakeError(f"peer identity signature invalid: {e}") from e
    if expected_peer_id is not None and peer_id != expected_peer_id:
        raise HandshakeError(
            f"peer id mismatch: expected {expected_peer_id.hex()[:16]}, "
            f"got {peer_id.hex()[:16]}"
        )
    keys.peer_id = peer_id
    box.peer_id = peer_id
    return box
