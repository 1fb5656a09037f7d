"""SQLite engine (reference src/db/sqlite_adapter.rs:1-596).

One SQL table per tree (`tree_<hex(name)>`), BLOB key/value, WAL mode.
Transactions use a process-wide lock + BEGIN IMMEDIATE; iteration during a
write transaction is served from the same connection (sqlite allows reads
mid-transaction).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Callable, Iterator, TypeVar

from . import Db, Tree, Tx, TxAbort

T = TypeVar("T")


def _tbl(name: str) -> str:
    return "tree_" + name.encode().hex()


class SqliteTree(Tree):
    def __init__(self, db: "SqliteDb", name: str):
        self.db = db
        self.name = name
        self.tbl = _tbl(name)

    def get(self, k: bytes) -> bytes | None:
        with self.db.lock:
            row = self.db.conn.execute(
                f"SELECT v FROM {self.tbl} WHERE k = ?", (k,)
            ).fetchone()
        return row[0] if row else None

    def insert(self, k: bytes, v: bytes) -> None:
        with self.db.lock:
            self.db.assert_not_in_tx()
            self.db.conn.execute(
                f"INSERT INTO {self.tbl}(k, v) VALUES(?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (k, v),
            )
            self.db.conn.commit()

    def remove(self, k: bytes) -> None:
        with self.db.lock:
            self.db.assert_not_in_tx()
            self.db.conn.execute(f"DELETE FROM {self.tbl} WHERE k = ?", (k,))
            self.db.conn.commit()

    def __len__(self) -> int:
        with self.db.lock:
            (n,) = self.db.conn.execute(f"SELECT COUNT(*) FROM {self.tbl}").fetchone()
        return n

    def iter_range(
        self,
        start: bytes | None = None,
        end: bytes | None = None,
        reverse: bool = False,
    ) -> Iterator[tuple[bytes, bytes]]:
        q = f"SELECT k, v FROM {self.tbl}"
        conds, params = [], []
        if start is not None:
            conds.append("k >= ?")
            params.append(start)
        if end is not None:
            conds.append("k < ?")
            params.append(end)
        if conds:
            q += " WHERE " + " AND ".join(conds)
        q += " ORDER BY k" + (" DESC" if reverse else "")
        # fetch in pages so callers may mutate between yields
        last: bytes | None = None
        while True:
            qq, pp = q, list(params)
            if last is not None:
                op = "k < ?" if reverse else "k > ?"
                qq = f"SELECT k, v FROM {self.tbl} WHERE {op}"
                pp = [last]
                if start is not None:
                    qq += " AND k >= ?"
                    pp.append(start)
                if end is not None:
                    qq += " AND k < ?"
                    pp.append(end)
                qq += " ORDER BY k" + (" DESC" if reverse else "")
            with self.db.lock:
                rows = self.db.conn.execute(qq + " LIMIT 256", pp).fetchall()
            if not rows:
                return
            for k, v in rows:
                yield (bytes(k), bytes(v))
            last = bytes(rows[-1][0])


class _SqliteTx(Tx):
    def __init__(self, db: "SqliteDb"):
        self.db = db

    def get(self, tree: Tree, k: bytes) -> bytes | None:
        assert isinstance(tree, SqliteTree)
        row = self.db.conn.execute(
            f"SELECT v FROM {tree.tbl} WHERE k = ?", (k,)
        ).fetchone()
        return bytes(row[0]) if row else None

    def insert(self, tree: Tree, k: bytes, v: bytes) -> None:
        assert isinstance(tree, SqliteTree)
        self.db.conn.execute(
            f"INSERT INTO {tree.tbl}(k, v) VALUES(?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
            (k, v),
        )

    def remove(self, tree: Tree, k: bytes) -> None:
        assert isinstance(tree, SqliteTree)
        self.db.conn.execute(f"DELETE FROM {tree.tbl} WHERE k = ?", (k,))

    def len(self, tree: Tree) -> int:
        assert isinstance(tree, SqliteTree)
        (n,) = self.db.conn.execute(f"SELECT COUNT(*) FROM {tree.tbl}").fetchone()
        return n


class SqliteDb(Db):
    engine = "sqlite"

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.lock = threading.RLock()
        self.conn.execute("PRAGMA journal_mode = WAL")
        # WAL + NORMAL already skips the per-commit fsync (it syncs only
        # at checkpoints), so that is the fsync=False setting; OFF would
        # additionally skip checkpoint syncs and can corrupt the whole DB
        # on power loss.  fsync=True buys per-commit durability (FULL).
        self.conn.execute(
            "PRAGMA synchronous = " + ("FULL" if fsync else "NORMAL")
        )
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS _trees (name TEXT PRIMARY KEY)"
        )
        self.conn.commit()
        self._trees: dict[str, SqliteTree] = {}

    def open_tree(self, name: str) -> Tree:
        if name not in self._trees:
            with self.lock:
                self.conn.execute(
                    f"CREATE TABLE IF NOT EXISTS {_tbl(name)} "
                    "(k BLOB PRIMARY KEY, v BLOB NOT NULL)"
                )
                self.conn.execute(
                    "INSERT OR IGNORE INTO _trees(name) VALUES(?)", (name,)
                )
                self.conn.commit()
            self._trees[name] = SqliteTree(self, name)
        return self._trees[name]

    def list_trees(self) -> list[str]:
        with self.lock:
            rows = self.conn.execute("SELECT name FROM _trees ORDER BY name").fetchall()
        return [r[0] for r in rows]

    def assert_not_in_tx(self) -> None:
        # Auto-commit Tree ops inside a transaction() closure would commit
        # the half-done outer transaction; force callers to use the Tx handle.
        if self.conn.in_transaction:
            raise RuntimeError(
                "auto-commit Tree op called inside a transaction(); "
                "use the Tx handle instead"
            )

    def transaction(self, fn: Callable[[Tx], T]) -> T:
        with self.lock:
            self.conn.execute("BEGIN IMMEDIATE")
            tx = _SqliteTx(self)
            try:
                res = fn(tx)
                self.conn.commit()
                return res
            except TxAbort as a:
                self.conn.rollback()
                return a.value
            except BaseException:
                self.conn.rollback()
                raise

    def snapshot(self, to_dir: str) -> None:
        os.makedirs(to_dir, exist_ok=True)
        dest_path = os.path.join(to_dir, "db.sqlite")
        with self.lock:
            dest = sqlite3.connect(dest_path)
            try:
                self.conn.backup(dest)
            finally:
                dest.close()

    def close(self) -> None:
        with self.lock:
            self.conn.close()
