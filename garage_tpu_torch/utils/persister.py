"""Atomic save/load of versioned values to a file.

Mirrors reference src/util/persister.rs:10-112: write to a temp file in the
same directory, fsync, rename over the target — so a crash never leaves a
half-written state file.
"""

from __future__ import annotations

import os
from typing import Generic, TypeVar

from .migrate import Migratable

T = TypeVar("T", bound=Migratable)


class Persister(Generic[T]):
    def __init__(self, directory: str, name: str, typ: type[T]):
        self.path = os.path.join(directory, name)
        self.typ = typ
        # serializes _write_raw across the loop thread (sync save from
        # operator one-shots) and save_in_thread's worker thread: both
        # share one <path>.tmp, and an unsynchronized second open("wb")
        # would truncate it mid-write
        import threading

        self._write_mu = threading.Lock()

    def load(self) -> T | None:
        try:
            with open(self.path, "rb") as f:
                return self.typ.decode(f.read())
        except FileNotFoundError:
            return None

    def save(self, value: T) -> None:
        self._write_raw(value.encode())

    async def save_in_thread(self, value: T) -> None:
        """Checkpoint from a coroutine: encode ON the loop thread (the
        value may be mutated by other coroutines — a thread-side encode
        would race it), then run the write/fsync/rename in a worker
        thread so the disk flush never stalls the event loop."""
        import asyncio

        data = value.encode()
        await asyncio.to_thread(self._write_raw, data)

    def _write_raw(self, data: bytes) -> None:
        with self._write_mu:
            tmp = self.path + ".tmp"
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)

    def load_raw(self) -> bytes | None:
        try:
            with open(self.path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def save_raw(self, data: bytes) -> None:
        self._write_raw(data)
