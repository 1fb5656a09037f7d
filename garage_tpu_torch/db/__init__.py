"""Metadata KV-store abstraction.

Mirrors reference src/db/lib.rs:28-121 (`IDb` / `ITx` trait objects): named
trees of (bytes → bytes) with ordered range iteration and cross-tree
transactions.  Engines (the reference ships LMDB + SQLite,
src/db/lmdb_adapter.rs + sqlite_adapter.rs): `sqlite` (stdlib), `log` — a
durable log-structured engine filling the LMDB slot (log_engine.py), and
`memory` for tests/ephemeral nodes.  The same test suite runs against every
engine (reference src/db/test.rs:127-144 pattern).
"""

from __future__ import annotations

from typing import Callable, Iterator, TypeVar

T = TypeVar("T")


class TxAbort(Exception):
    """Raise inside a transaction closure to roll back and return a value."""

    def __init__(self, value=None):
        super().__init__("transaction aborted")
        self.value = value


class Tx:
    """Transaction handle: atomic get/insert/remove across trees."""

    def get(self, tree: "Tree", k: bytes) -> bytes | None:
        raise NotImplementedError

    def insert(self, tree: "Tree", k: bytes, v: bytes) -> None:
        raise NotImplementedError

    def remove(self, tree: "Tree", k: bytes) -> None:
        raise NotImplementedError

    def len(self, tree: "Tree") -> int:
        raise NotImplementedError


class Tree:
    """A named ordered keyspace; all single ops are auto-committed."""

    name: str

    def get(self, k: bytes) -> bytes | None:
        raise NotImplementedError

    def insert(self, k: bytes, v: bytes) -> None:
        raise NotImplementedError

    def remove(self, k: bytes) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def iter_range(
        self,
        start: bytes | None = None,
        end: bytes | None = None,
        reverse: bool = False,
    ) -> Iterator[tuple[bytes, bytes]]:
        """Iterate (k, v) with start <= k < end (end exclusive), ordered.

        Consistency contract (the WEAKEST the engines provide, so callers
        must assume it): keys inserted/deleted by OTHER transactions while
        the iterator is live MAY or MAY NOT be observed — the log engine
        snapshots the key range up front, the native engine pages through
        the live map in chunks, sqlite depends on statement caching.  A
        caller that mutates ahead of its own cursor (merkle/GC workers
        queue work instead) must not rely on seeing — or not seeing —
        those keys.  Pinned by tests/test_db.py
        test_iter_range_mid_iteration_contract."""
        raise NotImplementedError

    def iter_prefix(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        end = _prefix_end(prefix)
        return self.iter_range(prefix, end)

    def first(self) -> tuple[bytes, bytes] | None:
        for kv in self.iter_range():
            return kv
        return None

    def get_gt(self, k: bytes) -> tuple[bytes, bytes] | None:
        """First entry with key strictly greater than k."""
        for kk, vv in self.iter_range(start=k + b"\x00"):
            return (kk, vv)
        return None


class Db:
    engine: str

    def open_tree(self, name: str) -> Tree:
        raise NotImplementedError

    def list_trees(self) -> list[str]:
        raise NotImplementedError

    def transaction(self, fn: Callable[[Tx], T]) -> T:
        """Run `fn(tx)`; commit on return, rollback on exception.

        A `TxAbort` exception rolls back and returns `exc.value`.
        """
        raise NotImplementedError

    def snapshot(self, to_dir: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _prefix_end(prefix: bytes) -> bytes | None:
    p = bytearray(prefix)
    while p:
        if p[-1] != 0xFF:
            p[-1] += 1
            return bytes(p)
        p.pop()
    return None


from .open import open_db  # noqa: E402

__all__ = ["Db", "Tree", "Tx", "TxAbort", "open_db"]
