"""Versioned serialization with in-place upgrade chains.

Mirrors reference src/util/migrate.rs:5-45: every persisted struct carries a
version-marker byte string prefix; decoding tries the current version first,
then walks back through the chain of previous versions, decoding with the
old schema and applying `migrate` hops forward.  This is what lets nodes of
different versions coexist and lets on-disk state upgrade in place.

A versioned class declares:

    class Thing(Migratable):
        VERSION_MARKER = b"G0thing"
        PREVIOUS: type | None = ThingV0   # or None for the initial format
        def to_obj(self) -> Any: ...
        @classmethod
        def from_obj(cls, obj) -> "Thing": ...
        @classmethod
        def migrate_from(cls, prev) -> "Thing": ...   # if PREVIOUS set

Encoded bytes are `VERSION_MARKER + msgpack(to_obj())`.
"""

from __future__ import annotations

from typing import Any, TypeVar

from .serde import pack, unpack  # noqa: F401 — canonical encoding, re-exported

M = TypeVar("M", bound="Migratable")


class Migratable:
    VERSION_MARKER: bytes = b""
    PREVIOUS: type | None = None

    def to_obj(self) -> Any:
        raise NotImplementedError

    @classmethod
    def from_obj(cls: type[M], obj: Any) -> M:
        raise NotImplementedError

    @classmethod
    def migrate_from(cls: type[M], prev: Any) -> M:
        raise NotImplementedError

    # --- encode/decode -----------------------------------------------------

    def encode(self) -> bytes:
        return self.VERSION_MARKER + pack(self.to_obj())

    @classmethod
    def decode(cls: type[M], data: bytes) -> M:
        if cls.VERSION_MARKER and data.startswith(cls.VERSION_MARKER):
            # A payload that fails to parse under the current schema falls
            # through to the previous version, like the reference
            # (src/util/migrate.rs:19-27 tries each version in turn).
            try:
                return cls.from_obj(unpack(data[len(cls.VERSION_MARKER):]))
            except Exception:
                if cls.PREVIOUS is None:
                    raise
        if not cls.VERSION_MARKER:
            # unversioned initial format
            return cls.from_obj(unpack(data))
        if cls.PREVIOUS is not None:
            prev = cls.PREVIOUS.decode(data)
            return cls.migrate_from(prev)
        raise ValueError(
            f"{cls.__name__}: unknown version marker in {data[:16]!r}"
        )
