"""Canonical msgpack encoding — THE wire/persistence serialization.

One definition so the RPC layer, CRDTs and persisted state can never fork
their encoding options.
"""

from __future__ import annotations

from typing import Any

import msgpack


def pack(obj: Any) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False, strict_map_key=False, use_list=True)
