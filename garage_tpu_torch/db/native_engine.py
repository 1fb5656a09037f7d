"""`db_engine = "native"` — the C++ metadata engine (_native/kvlog.cpp)
behind the generic Db/Tree/Tx interface.

Fills the reference's LMDB slot (src/db/lmdb_adapter.rs) with native-speed
point ops and range scans: the keyspace lives in C++ ordered maps, every
commit is one crc-framed append to a write-ahead log, recovery truncates
torn tails, compaction bounds the log.  The WAL format is byte-identical
to the Python log engine (db/log_engine.py) — a store written by either
opens in the other, so switching engines needs no convert-db.

Binding: the CPython C-API module (_native/kvpy.cpp) — ~100 ns per call
— or, when this interpreter has no Python.h, the ctypes library (~3 us
per call).  `NativeDb.binding` names the one in use.  A failed g++ build
raises `_native.NativeBuildError`: there is no Python path behind this
engine.

Transactions keep the log engine's overlay design: buffered writes with
read-your-writes, then the whole batch becomes ONE native commit (one
frame, atomic by construction).
"""

from __future__ import annotations

import logging
import os
import shutil
import struct
from typing import Callable, Iterator, TypeVar

from . import Db, Tree, Tx, TxAbort
from .log_engine import _DEL, _PUT, _enc_record

T = TypeVar("T")

logger = logging.getLogger("garage.db")

_ITER_BUF = 256 * 1024  # per-chunk scan buffer (grown when a value exceeds it)


class _CtypesBinding:
    """kv_* via ctypes, shaped like the garage_kv extension module."""

    def __init__(self, l):
        import ctypes

        self._ct = ctypes
        self._l = l

    def open(self, path: str, sync_mode: int) -> int:
        h = self._l.kv_open(path.encode(), int(sync_mode))
        if not h:
            raise OSError(f"cannot open native kv log at {path!r}")
        return h

    def close(self, h) -> None:
        self._l.kv_close(h)

    def sync_barrier(self, h) -> None:
        if self._l.kv_sync_barrier(h) != 0:
            raise OSError("native kv sync barrier failed")

    def commit(self, h, payload: bytes) -> None:
        rc = self._l.kv_commit(h, payload, len(payload))
        if rc != 0:
            raise OSError(f"native kv commit failed (rc={rc})")

    def get(self, h, tree: bytes, key: bytes) -> bytes | None:
        ct = self._ct
        out = ct.c_void_p()
        outlen = ct.c_size_t()
        found = self._l.kv_get(
            h, tree, len(tree), key, len(key), ct.byref(out), ct.byref(outlen)
        )
        if not found:
            return None
        return ct.string_at(out.value, outlen.value)

    def tree_len(self, h, tree: bytes) -> int:
        return self._l.kv_tree_len(h, tree, len(tree))

    def tree_names(self, h) -> bytes:
        ct = self._ct
        cap = 4096
        while True:
            buf = ct.create_string_buffer(cap)
            need = self._l.kv_tree_names(h, buf, cap)
            if need <= cap:
                return buf.raw[:need]
            cap = need

    def iter_chunk(
        self, h, tree: bytes, start, end, reverse: bool, max_items: int, cap: int
    ) -> tuple[bytes, bool]:
        ct = self._ct
        buf = ct.create_string_buffer(cap)
        done = ct.c_int(0)
        n = self._l.kv_iter_chunk(
            h, tree, len(tree),
            start, len(start) if start is not None else 0,
            1 if start is not None else 0,
            end, len(end) if end is not None else 0,
            1 if end is not None else 0,
            1 if reverse else 0,
            max_items, buf, cap, ct.byref(done),
        )
        return buf.raw[:n], bool(done.value)

    def compact(self, h) -> None:
        if self._l.kv_compact_now(h) != 0:
            raise OSError("native kv compaction failed")

    def log_bytes(self, h) -> int:
        return self._l.kv_log_bytes(h)

    def live_bytes(self, h) -> int:
        return self._l.kv_live_bytes(h)

    def sync_failures(self, h) -> int:
        return self._l.kv_sync_failures(h)


def _binding():
    """(binding, its name): the extension module, else the ctypes
    library; a failed build raises."""
    from .. import _native

    kv = _native.kv_module()
    if kv is not None:
        return kv, "extension"
    return _CtypesBinding(_native.lib()), "ctypes"


class NativeTree(Tree):
    __slots__ = ("db", "name", "_bname")

    def __init__(self, db: "NativeDb", name: str):
        self.db = db
        self.name = name
        self._bname = name.encode()

    def get(self, k: bytes) -> bytes | None:
        return self.db.kv.get(self.db.h, self._bname, bytes(k))

    def insert(self, k: bytes, v: bytes) -> None:
        self.db._autocommit(_enc_record(_PUT, self.name, bytes(k), bytes(v)))

    def remove(self, k: bytes) -> None:
        self.db._autocommit(_enc_record(_DEL, self.name, bytes(k), None))

    def __len__(self) -> int:
        return self.db.kv.tree_len(self.db.h, self._bname)

    def iter_range(
        self,
        start: bytes | None = None,
        end: bytes | None = None,
        reverse: bool = False,
    ) -> Iterator[tuple[bytes, bytes]]:
        return self.db._iter(self._bname, start, end, reverse)

    def first(self) -> tuple[bytes, bytes] | None:
        for kv in self.db._iter(self._bname, None, None, False, max_items=1):
            return kv
        return None

    def get_gt(self, k: bytes) -> tuple[bytes, bytes] | None:
        it = self.db._iter(
            self._bname, bytes(k) + b"\x00", None, False, max_items=1
        )
        for kv in it:
            return kv
        return None


class NativeTx(Tx):
    """Overlay transaction: same semantics as log_engine.LogTx."""

    def __init__(self, db: "NativeDb"):
        self.db = db
        self.writes: dict[tuple[str, bytes], tuple[int, bytes | None]] = {}
        self.order: list[bytes] = []  # encoded records, commit order

    def get(self, tree: NativeTree, k: bytes) -> bytes | None:
        ent = self.writes.get((tree.name, bytes(k)))
        if ent is not None:
            return ent[1]
        return tree.get(k)

    def insert(self, tree: NativeTree, k: bytes, v: bytes) -> None:
        k, v = bytes(k), bytes(v)
        self.writes[(tree.name, k)] = (_PUT, v)
        self.order.append(_enc_record(_PUT, tree.name, k, v))

    def remove(self, tree: NativeTree, k: bytes) -> None:
        k = bytes(k)
        self.writes[(tree.name, k)] = (_DEL, None)
        self.order.append(_enc_record(_DEL, tree.name, k, None))

    def len(self, tree: NativeTree) -> int:
        n = len(tree)
        for (tname, k), (op, _v) in self.writes.items():
            if tname != tree.name:
                continue
            present = tree.get(k) is not None
            if op == _PUT and not present:
                n += 1
            elif op == _DEL and present:
                n -= 1
        return n


class NativeDb(Db):
    engine = "native"

    def __init__(self, path: str, fsync: bool | str = True, binding=None):
        """`fsync` selects the durability mode: True = fdatasync inside
        every commit; "group" = group commit (commits ack immediately, a
        C++ flusher thread runs fdatasync continuously — durability
        window ~ one fdatasync, same class as sqlite WAL+NORMAL and the
        reference's default metadata_fsync=false LMDB posture;
        `sync_barrier()` forces full durability); False = sync only at
        compaction/close.

        `binding` overrides the kv backend (an object shaped like the
        garage_kv module, such as `_CtypesBinding(_native.lib())`)."""
        if binding is not None:
            self.kv = binding
            self.binding = "ctypes" if isinstance(binding, _CtypesBinding) else "extension"
        else:
            self.kv, self.binding = _binding()
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        mode = 2 if fsync == "group" else (1 if fsync else 0)
        self.h = self.kv.open(path, mode)
        logger.info("native metadata engine: %s through the %s binding", path, self.binding)
        self.trees: dict[str, NativeTree] = {}
        self._in_tx = False
        for name in self._native_tree_names():
            self.trees[name] = NativeTree(self, name)

    # --- helpers --------------------------------------------------------------

    def _iter(
        self,
        bname: bytes,
        start: bytes | None,
        end: bytes | None,
        reverse: bool,
        max_items: int = 0,
    ) -> Iterator[tuple[bytes, bytes]]:
        cap = _ITER_BUF
        unpack = struct.unpack_from
        while True:
            chunk, done = self.kv.iter_chunk(
                self.h, bname, start, end, reverse, max_items, cap
            )
            n = len(chunk)
            if n == 0 and not done:
                cap *= 2  # one entry exceeds the buffer
                continue
            pos = 0
            last = None
            while pos < n:
                (klen,) = unpack("<I", chunk, pos)
                k = chunk[pos + 4 : pos + 4 + klen]
                pos += 4 + klen
                (vlen,) = unpack("<I", chunk, pos)
                v = chunk[pos + 4 : pos + 4 + vlen]
                pos += 4 + vlen
                last = k
                yield (k, v)
            if done or last is None:
                return
            if max_items:
                return  # caller asked for a bounded prefix only
            if reverse:
                end = last  # exclusive upper bound for the next chunk
            else:
                start = last + b"\x00"

    def _native_tree_names(self) -> list[str]:
        raw = self.kv.tree_names(self.h)
        names, pos = [], 0
        while pos < len(raw):
            (n,) = struct.unpack_from("<H", raw, pos)
            names.append(raw[pos + 2 : pos + 2 + n].decode())
            pos += 2 + n
        return names

    def _autocommit(self, payload: bytes) -> None:
        if self._in_tx:
            raise RuntimeError(
                "direct tree mutation inside a transaction; use the tx handle"
            )
        self.kv.commit(self.h, payload)

    # --- Db interface ---------------------------------------------------------

    def open_tree(self, name: str) -> NativeTree:
        t = self.trees.get(name)
        if t is None:
            t = self.trees[name] = NativeTree(self, name)
        return t

    def list_trees(self) -> list[str]:
        return sorted(set(self.trees) | set(self._native_tree_names()))

    def transaction(self, fn: Callable[[Tx], T]) -> T:
        self._in_tx = True
        tx = NativeTx(self)
        try:
            res = fn(tx)
        except TxAbort as e:
            return e.value
        finally:
            self._in_tx = False
        if tx.order:
            self.kv.commit(self.h, b"".join(tx.order))
        return res

    def sync_barrier(self) -> None:
        """Block until every acknowledged commit is on stable storage
        (group mode waits out the flusher; other modes fdatasync)."""
        self.kv.sync_barrier(self.h)

    def snapshot(self, to_dir: str) -> None:
        os.makedirs(to_dir, exist_ok=True)
        self.kv.compact(self.h)
        shutil.copy2(
            self.path, os.path.join(to_dir, os.path.basename(self.path))
        )

    def close(self) -> None:
        if getattr(self, "h", None):
            self.kv.close(self.h)
            self.h = None
