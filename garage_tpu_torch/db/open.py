"""Engine selection (reference src/db/open.rs)."""

from __future__ import annotations

import os

from . import Db


def open_db(path: str, engine: str = "sqlite", fsync: bool = True) -> Db:
    if engine == "sqlite":
        from .sqlite_engine import SqliteDb

        if os.path.isdir(path) or not os.path.splitext(path)[1]:
            path = os.path.join(path, "db.sqlite")
        return SqliteDb(path, fsync=fsync)
    if engine == "log":
        from .log_engine import LogDb

        if os.path.isdir(path) or not os.path.splitext(path)[1]:
            path = os.path.join(path, "db.log")
        return LogDb(path, fsync=fsync)
    if engine == "native":
        from .native_engine import NativeDb

        if os.path.isdir(path) or not os.path.splitext(path)[1]:
            path = os.path.join(path, "db.log")  # WAL-compatible with "log"
        return NativeDb(path, fsync=fsync)
    if engine == "memory":
        from .memory_engine import MemDb

        return MemDb()
    raise ValueError(
        f"unknown db engine {engine!r} (supported: sqlite, log, native, memory)"
    )
