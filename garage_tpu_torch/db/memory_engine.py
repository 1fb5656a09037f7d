"""Ordered in-memory engine: dict + bisect-maintained sorted key list.

Stands in for the reference's LMDB adapter (src/db/lmdb_adapter.rs) as the
second engine the dual-engine test suite runs against; also used for
ephemeral/test nodes.
"""

from __future__ import annotations

import bisect
from typing import Callable, Iterator, TypeVar

from . import Db, Tree, Tx, TxAbort

T = TypeVar("T")


class _MemTreeData:
    __slots__ = ("d", "keys")

    def __init__(self) -> None:
        self.d: dict[bytes, bytes] = {}
        self.keys: list[bytes] = []

    def put(self, k: bytes, v: bytes) -> None:
        if k not in self.d:
            bisect.insort(self.keys, k)
        self.d[k] = v

    def delete(self, k: bytes) -> None:
        if k in self.d:
            del self.d[k]
            i = bisect.bisect_left(self.keys, k)
            del self.keys[i]


class MemTree(Tree):
    def __init__(self, db: "MemDb", name: str):
        self.db = db
        self.name = name
        self.data = _MemTreeData()

    def get(self, k: bytes) -> bytes | None:
        return self.data.d.get(k)

    def insert(self, k: bytes, v: bytes) -> None:
        self.db.assert_not_in_tx()
        self.data.put(k, v)

    def remove(self, k: bytes) -> None:
        self.db.assert_not_in_tx()
        self.data.delete(k)

    def __len__(self) -> int:
        return len(self.data.d)

    def iter_range(
        self,
        start: bytes | None = None,
        end: bytes | None = None,
        reverse: bool = False,
    ) -> Iterator[tuple[bytes, bytes]]:
        # Re-bisect from the last yielded key on every step so callers may
        # mutate the tree mid-iteration (GC/sync workers do exactly that) —
        # same contract as the sqlite engine's paged iteration.
        keys = self.data.keys
        last: bytes | None = None
        while True:
            if reverse:
                hi = (
                    (len(keys) if end is None else bisect.bisect_left(keys, end))
                    if last is None
                    else bisect.bisect_left(keys, last)
                )
                i = hi - 1
                if i < 0:
                    return
                k = keys[i]
                if start is not None and k < start:
                    return
            else:
                lo = (
                    (0 if start is None else bisect.bisect_left(keys, start))
                    if last is None
                    else bisect.bisect_right(keys, last)
                )
                if lo >= len(keys):
                    return
                k = keys[lo]
                if end is not None and k >= end:
                    return
            last = k
            v = self.data.d.get(k)
            if v is not None:
                yield (k, v)


class _MemTx(Tx):
    def __init__(self, db: "MemDb"):
        self.db = db
        # journal of (tree, key, old_value | None-if-absent) for rollback
        self.journal: list[tuple[MemTree, bytes, bytes | None]] = []

    def get(self, tree: Tree, k: bytes) -> bytes | None:
        assert isinstance(tree, MemTree)
        return tree.data.d.get(k)

    def insert(self, tree: Tree, k: bytes, v: bytes) -> None:
        assert isinstance(tree, MemTree)
        self.journal.append((tree, k, tree.data.d.get(k)))
        tree.data.put(k, v)

    def remove(self, tree: Tree, k: bytes) -> None:
        assert isinstance(tree, MemTree)
        self.journal.append((tree, k, tree.data.d.get(k)))
        tree.data.delete(k)

    def len(self, tree: Tree) -> int:
        assert isinstance(tree, MemTree)
        return len(tree.data.d)

    def rollback(self) -> None:
        for tree, k, old in reversed(self.journal):
            if old is None:
                tree.data.delete(k)
            else:
                tree.data.put(k, old)


class MemDb(Db):
    engine = "memory"

    def __init__(self) -> None:
        self.trees: dict[str, MemTree] = {}
        self._in_tx = False

    def open_tree(self, name: str) -> Tree:
        if name not in self.trees:
            self.trees[name] = MemTree(self, name)
        return self.trees[name]

    def list_trees(self) -> list[str]:
        return sorted(self.trees)

    def assert_not_in_tx(self) -> None:
        # same contract as the sqlite engine: no auto-commit ops mid-tx
        if self._in_tx:
            raise RuntimeError(
                "auto-commit Tree op called inside a transaction(); "
                "use the Tx handle instead"
            )

    def transaction(self, fn: Callable[[Tx], T]) -> T:
        tx = _MemTx(self)
        self._in_tx = True
        try:
            return fn(tx)
        except TxAbort as a:
            tx.rollback()
            return a.value
        except BaseException:
            tx.rollback()
            raise
        finally:
            self._in_tx = False

    def snapshot(self, to_dir: str) -> None:
        raise NotImplementedError("memory engine has no snapshot")
