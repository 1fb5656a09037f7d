"""Engine selection (reference src/db/open.rs)."""

from __future__ import annotations

import importlib.util
import os

from . import Db


def _require_ported(engine: str, module: str) -> None:
    """The log and native engines are not in this package yet: asking for
    one names it instead of failing on a missing module."""
    if importlib.util.find_spec(f"{__package__}.{module}") is None:
        raise ValueError(
            f"db engine {engine!r} is not yet ported to this package "
            f"(db/{module}.py); use sqlite or memory"
        )


def open_db(path: str, engine: str = "sqlite", fsync: bool = True) -> Db:
    if engine == "sqlite":
        from .sqlite_engine import SqliteDb

        if os.path.isdir(path) or not os.path.splitext(path)[1]:
            path = os.path.join(path, "db.sqlite")
        return SqliteDb(path, fsync=fsync)
    if engine == "log":
        _require_ported(engine, "log_engine")
        from .log_engine import LogDb

        if os.path.isdir(path) or not os.path.splitext(path)[1]:
            path = os.path.join(path, "db.log")
        return LogDb(path, fsync=fsync)
    if engine == "native":
        _require_ported(engine, "native_engine")
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
