"""Authenticated RPC mesh over TCP (asyncio).

Capability-parity with the reference's netapp fork (src/net/, SURVEY.md
§2.2) re-designed for asyncio rather than translated:

  - node identity = ed25519 keypair; node id = 32-byte public key
    (reference src/net/netapp.rs:26-30)
  - connections authenticated against a cluster-wide network key and
    encrypted: X25519 ephemeral DH bound to the network key via HKDF,
    ed25519 transcript signatures, ChaCha20-Poly1305 frames
    (reference uses the kuska secret-handshake, src/net/client.rs:55-74)
  - typed endpoints addressed by path strings; msgpack message bodies
    (reference src/net/endpoint.rs:17-45, message.rs:96-99)
  - chunked multiplexing with 3-level priority QoS and round-robin
    chunk scheduling so background traffic never starves interactive
    RPC (reference src/net/send.rs:17-110)
  - request/response bodies may carry an attached byte stream, delivered
    incrementally (reference src/net/stream.rs:20)
  - PeeringManager: full mesh, periodic pings, peer-list exchange
    (reference src/net/peering.rs:23-50)
"""

from .fault import FaultPlan, FaultRule
from .message import PRIO_BACKGROUND, PRIO_HIGH, PRIO_NORMAL
from .netapp import NetApp, RpcError

__all__ = [
    "NetApp",
    "RpcError",
    "FaultPlan",
    "FaultRule",
    "PRIO_HIGH",
    "PRIO_NORMAL",
    "PRIO_BACKGROUND",
]
