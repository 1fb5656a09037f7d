"""Durable log-structured engine (the second production engine beside
sqlite — filling the reference's LMDB slot, src/db/lmdb_adapter.rs, with a
write-optimized design instead of a binding we don't have).

Bitcask/WAL architecture:

  - ALL mutations append to one log file as crc-framed commit batches; a
    transaction is exactly one frame, so atomicity = frame integrity and
    recovery is "replay frames until the first bad/short one" (a torn
    write at the tail rolls back the interrupted commit and nothing else).
  - The full keyspace lives in RAM as ordered per-tree maps (dict +
    sorted key list), so reads and range scans never touch disk — the
    right trade for metadata tables that fit memory (same bet LMDB's
    mmap makes, minus the page cache misses).
  - When the log exceeds COMPACT_RATIO x the live data size it is
    rewritten: full state into `<path>.new`, fsync, atomic rename.
    Compaction also runs on close() and snapshot().

Frame format (little-endian):
    [u32 payload_len][u32 crc32(payload)][payload]
payload = concatenated records:
    [u8 op 1=put 2=del][u16 tree_len][tree][u32 klen][k]([u32 vlen][v] if put)
"""

from __future__ import annotations

import bisect
import os
import shutil
import struct
import zlib
from typing import Callable, Iterator, TypeVar

from . import Db, Tree, Tx, TxAbort

T = TypeVar("T")

COMPACT_RATIO = 3  # compact when log bytes > ratio * live bytes
COMPACT_MIN_BYTES = 4 * 1024 * 1024

_PUT, _DEL = 1, 2


def _enc_record(op: int, tree: str, k: bytes, v: bytes | None) -> bytes:
    t = tree.encode()
    out = [struct.pack("<BH", op, len(t)), t, struct.pack("<I", len(k)), k]
    if op == _PUT:
        out += [struct.pack("<I", len(v)), v]
    return b"".join(out)


class _Data:
    """Ordered map: dict + bisect-maintained key list."""

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
            del self.keys[bisect.bisect_left(self.keys, k)]


class LogTree(Tree):
    def __init__(self, db: "LogDb", name: str):
        self.db = db
        self.name = name
        self.data = _Data()

    def get(self, k: bytes) -> bytes | None:
        return self.data.d.get(k)

    def insert(self, k: bytes, v: bytes) -> None:
        self.db._autocommit([(self, _PUT, bytes(k), bytes(v))])

    def remove(self, k: bytes) -> None:
        self.db._autocommit([(self, _DEL, bytes(k), None)])

    def __len__(self) -> int:
        return len(self.data.d)

    def iter_range(
        self,
        start: bytes | None = None,
        end: bytes | None = None,
        reverse: bool = False,
    ) -> Iterator[tuple[bytes, bytes]]:
        keys = self.data.keys
        lo = bisect.bisect_left(keys, start) if start is not None else 0
        hi = bisect.bisect_left(keys, end) if end is not None else len(keys)
        # snapshot the key range: workers mutate the tree mid-iteration
        snap = keys[lo:hi]
        if reverse:
            snap.reverse()
        d = self.data.d
        for k in snap:
            v = d.get(k)
            if v is not None:  # deleted since the snapshot
                yield (k, v)


class LogTx(Tx):
    def __init__(self, db: "LogDb"):
        self.db = db
        # overlay: (tree_name, key) -> (op, value); reads see the overlay
        self.writes: dict[tuple[str, bytes], tuple[int, bytes | None]] = {}
        self.order: list[tuple[LogTree, int, bytes, bytes | None]] = []

    def get(self, tree: LogTree, k: bytes) -> bytes | None:
        ent = self.writes.get((tree.name, bytes(k)))
        if ent is not None:
            return ent[1]
        return tree.data.d.get(bytes(k))

    def insert(self, tree: LogTree, k: bytes, v: bytes) -> None:
        k, v = bytes(k), bytes(v)
        self.writes[(tree.name, k)] = (_PUT, v)
        self.order.append((tree, _PUT, k, v))

    def remove(self, tree: LogTree, k: bytes) -> None:
        k = bytes(k)
        self.writes[(tree.name, k)] = (_DEL, None)
        self.order.append((tree, _DEL, k, None))

    def len(self, tree: LogTree) -> int:
        n = len(tree.data.d)
        for (tname, k), (op, _v) in self.writes.items():
            if tname != tree.name:
                continue
            present = k in tree.data.d
            if op == _PUT and not present:
                n += 1
            elif op == _DEL and present:
                n -= 1
        return n


class LogDb(Db):
    engine = "log"

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self.trees: dict[str, LogTree] = {}
        self._live_bytes = 0
        self._in_tx = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._replay()
        self._f = open(path, "ab")
        self._log_bytes = self._f.tell()

    # --- recovery -------------------------------------------------------------

    def _replay(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        pos = 0
        valid_end = 0
        while pos + 8 <= len(buf):
            plen, crc = struct.unpack_from("<II", buf, pos)
            if pos + 8 + plen > len(buf):
                break  # torn tail
            payload = buf[pos + 8 : pos + 8 + plen]
            if zlib.crc32(payload) != crc:
                break  # corrupt frame: everything after is suspect
            self._apply_payload(payload)
            pos += 8 + plen
            valid_end = pos
        if valid_end < len(buf):
            # roll the interrupted commit back on disk too
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)

    def _apply_payload(self, payload: bytes) -> None:
        pos = 0
        while pos < len(payload):
            op, tlen = struct.unpack_from("<BH", payload, pos)
            pos += 3
            tree = payload[pos : pos + tlen].decode()
            pos += tlen
            (klen,) = struct.unpack_from("<I", payload, pos)
            pos += 4
            k = payload[pos : pos + klen]
            pos += klen
            t = self.open_tree(tree)
            if op == _PUT:
                (vlen,) = struct.unpack_from("<I", payload, pos)
                pos += 4
                v = payload[pos : pos + vlen]
                pos += vlen
                old = t.data.d.get(k)
                if old is not None:
                    self._live_bytes -= len(k) + len(old)
                t.data.put(k, v)
                self._live_bytes += len(k) + len(v)
            else:
                old = t.data.d.get(k)
                if old is not None:
                    self._live_bytes -= len(k) + len(old)
                t.data.delete(k)

    # --- commit ---------------------------------------------------------------

    def _write_frame(self, records: list[tuple[LogTree, int, bytes, bytes | None]]):
        payload = b"".join(
            _enc_record(op, t.name, k, v) for t, op, k, v in records
        )
        frame = struct.pack("<II", len(payload), zlib.crc32(payload)) + payload
        self._f.write(frame)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._log_bytes += len(frame)

    def _apply_mem(self, records) -> None:
        for t, op, k, v in records:
            old = t.data.d.get(k)
            if old is not None:
                self._live_bytes -= len(k) + len(old)
            if op == _PUT:
                t.data.put(k, v)
                self._live_bytes += len(k) + len(v)
            else:
                t.data.delete(k)

    def _autocommit(self, records) -> None:
        if self._in_tx:
            raise RuntimeError(
                "direct tree mutation inside a transaction; use the tx handle"
            )
        self._write_frame(records)
        self._apply_mem(records)
        self._maybe_compact()

    # --- Db interface ---------------------------------------------------------

    def open_tree(self, name: str) -> LogTree:
        t = self.trees.get(name)
        if t is None:
            t = self.trees[name] = LogTree(self, name)
        return t

    def list_trees(self) -> list[str]:
        return sorted(self.trees)

    def transaction(self, fn: Callable[[Tx], T]) -> T:
        self._in_tx = True
        tx = LogTx(self)
        try:
            res = fn(tx)
        except TxAbort as e:
            return e.value
        finally:
            self._in_tx = False
        if tx.order:
            self._write_frame(tx.order)
            self._apply_mem(tx.order)
            self._maybe_compact()
        return res

    def snapshot(self, to_dir: str) -> None:
        os.makedirs(to_dir, exist_ok=True)
        dst = os.path.join(to_dir, os.path.basename(self.path))
        self._compact()  # snapshot the compacted form
        shutil.copy2(self.path, dst)

    def close(self) -> None:
        if getattr(self, "_f", None) is None:
            return
        self._compact()
        self._f.close()
        self._f = None

    # --- compaction -----------------------------------------------------------

    def _maybe_compact(self) -> None:
        if (
            self._log_bytes > COMPACT_MIN_BYTES
            and self._log_bytes > COMPACT_RATIO * max(self._live_bytes, 1)
        ):
            self._compact()

    def _compact(self) -> None:
        """Rewrite the log as one frame per tree of live state; atomic
        swap via rename."""
        tmp = self.path + ".new"
        with open(tmp, "wb") as f:
            total = 0
            for name in sorted(self.trees):
                t = self.trees[name]
                if not t.data.d:
                    continue
                records = [
                    (t, _PUT, k, t.data.d[k]) for k in t.data.keys
                ]
                payload = b"".join(
                    _enc_record(_PUT, name, k, v) for _t, _op, k, v in records
                )
                frame = (
                    struct.pack("<II", len(payload), zlib.crc32(payload))
                    + payload
                )
                f.write(frame)
                total += len(frame)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._log_bytes = total
