"""RangeSeenMarker: which items of a polled range the client has seen
(reference src/model/k2v/seen.rs:1-105).

Two parts:
  - a vector clock: for each writer node, every item whose entry for that
    node is <= the clock value has been seen;
  - per-item causal contexts for items that are newer than the global
    clock (the "frontier" the clock can't express).

`canonicalize` drops per-item entries the global clock already covers, so
the marker stays small as the poller's view catches up.  Encoded
base64(zlib(msgpack)) — an opaque token to clients, like the reference's
base64(zstd(msgpack)).
"""

from __future__ import annotations

import base64
import zlib

from ...utils.serde import pack, unpack


def vclock_gt(a: dict[bytes, int], b: dict[bytes, int]) -> bool:
    """True iff `a` contains progress `b` hasn't seen."""
    return any(t > b.get(node, 0) for node, t in a.items())


def vclock_max(a: dict[bytes, int], b: dict[bytes, int]) -> dict[bytes, int]:
    out = dict(a)
    for node, t in b.items():
        if t > out.get(node, 0):
            out[node] = t
    return out


class RangeSeenMarker:
    def __init__(
        self,
        vector_clock: dict[bytes, int] | None = None,
        items: dict[str, dict[bytes, int]] | None = None,
    ):
        self.vector_clock = vector_clock or {}
        self.items = items or {}

    def restrict(self, start: str | None, end: str | None, prefix: str | None) -> None:
        """Drop per-item entries outside the polled range (seen.rs:36-46)."""
        self.items = {
            sk: vc
            for sk, vc in self.items.items()
            if (start is None or sk >= start)
            and (end is None or sk < end)
            and (prefix is None or sk.startswith(prefix))
        }

    def mark_seen_node_items(self, node: bytes, items) -> None:
        """Record a node's poll response: bump that node's clock entry to
        the max it reported, and pin still-unseen items individually
        (seen.rs:48-72)."""
        for item in items:
            vv = item.causal_context().vv
            if node in vv:
                self.vector_clock[node] = max(
                    self.vector_clock.get(node, 0), vv[node]
                )
            if vclock_gt(vv, self.vector_clock):
                cur = self.items.get(item.sort_key)
                self.items[item.sort_key] = (
                    vclock_max(cur, vv) if cur is not None else dict(vv)
                )

    def canonicalize(self) -> None:
        self.items = {
            sk: vc for sk, vc in self.items.items()
            if vclock_gt(vc, self.vector_clock)
        }

    def is_new_item(self, item) -> bool:
        vv = item.causal_context().vv
        if not vclock_gt(vv, self.vector_clock):
            return False
        pinned = self.items.get(item.sort_key)
        return pinned is None or vclock_gt(vv, pinned)

    def encode(self) -> str:
        self.canonicalize()
        payload = pack(
            [
                sorted([[n, t] for n, t in self.vector_clock.items()]),
                sorted(
                    [
                        [sk, sorted([[n, t] for n, t in vc.items()])]
                        for sk, vc in self.items.items()
                    ]
                ),
            ]
        )
        return base64.b64encode(zlib.compress(payload)).decode()

    @classmethod
    def decode(cls, s: str) -> "RangeSeenMarker | None":
        try:
            vc_rows, item_rows = unpack(zlib.decompress(base64.b64decode(s)))
            return cls(
                {bytes(n): int(t) for n, t in vc_rows},
                {
                    sk: {bytes(n): int(t) for n, t in vc}
                    for sk, vc in item_rows
                },
            )
        # graft-lint: allow-swallow(malformed client token decodes to None by contract)
        except Exception:  # noqa: BLE001 — any malformed token is invalid
            return None
