"""Conflict-free replicated data types.

Mirrors reference src/util/crdt/ (mod.rs:12-26): the `Crdt` trait with an
idempotent, commutative, associative `merge`, and the standard instances the
table schemas are built from: `Lww`, `LwwMap`, `Map`, `Bool`, `Deletable`.

Values stored inside CRDTs must be msgpack-encodable trees (or themselves
CRDTs for `Map`/`Deletable`).  Where the reference relies on `Ord` to break
ties deterministically, we order by the msgpack encoding of the value, which
is a total order on encodable values and identical on every node.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Generic, Iterator, TypeVar

from .serde import pack as _serde_pack

T = TypeVar("T")


def _ord_key(v: Any) -> bytes:
    """Deterministic total order for tie-breaking, same on all nodes."""
    if isinstance(v, Crdt):
        v = v.to_obj()
    return _serde_pack(v)


def _adopt(v: Any) -> Any:
    """Deep-copy a value taken from the other side of a merge.

    Rust gets this for free from clone-on-merge; without it, the merged-into
    object and the mutator would alias the same mutable value, so a later
    local edit would silently corrupt an update object the caller may
    re-broadcast (the `update_mutator` pattern)."""
    if isinstance(v, (bytes, str, int, float, bool, type(None))):
        return v
    return copy.deepcopy(v)


class Crdt:
    """Base CRDT: in-place merge; must be idempotent/commutative/associative."""

    def merge(self, other: "Crdt") -> None:
        raise NotImplementedError

    # msgpack-tree serialization
    def to_obj(self) -> Any:
        raise NotImplementedError

    @classmethod
    def from_obj(cls, obj: Any) -> "Crdt":
        raise NotImplementedError


def merge_values(a: Any, b: Any) -> Any:
    """Merge two values that may be CRDTs or plain comparable values.

    Plain values follow AutoCrdt semantics (reference src/util/crdt/mod.rs
    `AutoCrdt`): if they differ, keep the larger in the deterministic order.
    """
    if isinstance(a, Crdt):
        a.merge(b)
        return a
    if a == b:
        return a
    return _adopt(b) if _ord_key(b) > _ord_key(a) else a


class Lww(Crdt, Generic[T]):
    """Last-writer-wins register (reference src/util/crdt/lww.rs).

    Ties on timestamp are broken by the deterministic value order; the inner
    value is itself CRDT-merged when timestamps and order keys are equal.
    """

    __slots__ = ("ts", "value")

    def __init__(self, value: T, ts: int | None = None):
        from .time_util import now_msec

        self.ts = now_msec() if ts is None else ts
        self.value = value

    @classmethod
    def raw(cls, ts: int, value: T) -> "Lww[T]":
        return cls(value, ts=ts)

    def get(self) -> T:
        return self.value

    def update(self, value: T) -> None:
        """Set a new value with a timestamp strictly above the current one."""
        from .time_util import increment_logical_clock

        self.ts = increment_logical_clock(self.ts)
        self.value = value

    def merge(self, other: "Lww[T]") -> None:
        if other.ts > self.ts:
            self.ts, self.value = other.ts, _adopt(other.value)
        elif other.ts == self.ts:
            if isinstance(self.value, Crdt):
                self.value.merge(other.value)
            elif _ord_key(other.value) > _ord_key(self.value):
                self.value = _adopt(other.value)

    def to_obj(self) -> Any:
        v = self.value.to_obj() if isinstance(self.value, Crdt) else self.value
        return [self.ts, v]

    @classmethod
    def from_obj(cls, obj: Any, value_from: Callable[[Any], T] | None = None) -> "Lww[T]":
        ts, v = obj
        return cls(value_from(v) if value_from else v, ts=ts)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Lww)
            and self.ts == other.ts
            and _ord_key(self.value) == _ord_key(other.value)
        )

    def __repr__(self) -> str:
        return f"Lww(ts={self.ts}, value={self.value!r})"


class LwwMap(Crdt, Generic[T]):
    """Map of independent LWW registers, stored as a sorted assoc list
    (reference src/util/crdt/lww_map.rs)."""

    __slots__ = ("vals",)

    def __init__(self, vals: list[tuple[Any, int, T]] | None = None):
        self.vals = sorted(vals or [], key=lambda kv: _ord_key(kv[0]))

    def get(self, k: Any) -> T | None:
        for key, _ts, v in self.vals:
            if key == k:
                return v
        return None

    def get_timestamp(self, k: Any) -> int:
        for key, ts, _v in self.vals:
            if key == k:
                return ts
        return 0

    def update_in_place(self, k: Any, v: T) -> None:
        """Insert/overwrite with a fresh monotone timestamp."""
        from .time_util import increment_logical_clock

        ts = increment_logical_clock(self.get_timestamp(k))
        self.merge(LwwMap([(k, ts, v)]))

    def update_mutator(self, k: Any, v: T) -> "LwwMap[T]":
        """A single-entry LwwMap that, merged in, performs the update."""
        from .time_util import increment_logical_clock

        ts = increment_logical_clock(self.get_timestamp(k))
        return LwwMap([(k, ts, v)])

    def remove(self, k: Any) -> None:
        self.vals = [e for e in self.vals if e[0] != k]

    def items(self) -> list[tuple[Any, T]]:
        return [(k, v) for k, _ts, v in self.vals]

    def merge(self, other: "LwwMap[T]") -> None:
        out: dict[bytes, tuple[Any, int, T]] = {_ord_key(k): (k, ts, v) for k, ts, v in self.vals}
        for k, ts, v in other.vals:
            kk = _ord_key(k)
            cur = out.get(kk)
            if cur is None or ts > cur[1]:
                out[kk] = (k, ts, _adopt(v))
            elif ts == cur[1]:
                # timestamp tie: CRDT-merge the two values (reference
                # lww_map.rs merge_raw, Ordering::Equal branch)
                out[kk] = (k, ts, merge_values(cur[2], v))
        self.vals = [out[kk] for kk in sorted(out)]

    def to_obj(self) -> Any:
        return [
            [k, ts, v.to_obj() if isinstance(v, Crdt) else v] for k, ts, v in self.vals
        ]

    @classmethod
    def from_obj(cls, obj: Any, value_from: Callable[[Any], T] | None = None) -> "LwwMap[T]":
        return cls(
            [(k, ts, value_from(v) if value_from else v) for k, ts, v in obj]
        )

    def __len__(self) -> int:
        return len(self.vals)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, LwwMap) and self.to_obj() == other.to_obj()

    def __repr__(self) -> str:
        return f"LwwMap({self.vals!r})"


class CrdtMap(Crdt, Generic[T]):
    """Map whose values are themselves CRDTs, merged key-wise
    (reference src/util/crdt/map.rs)."""

    __slots__ = ("vals",)

    def __init__(self, vals: list[tuple[Any, T]] | None = None):
        self.vals = sorted(vals or [], key=lambda kv: _ord_key(kv[0]))

    def get(self, k: Any) -> T | None:
        for key, v in self.vals:
            if key == k:
                return v
        return None

    def put(self, k: Any, v: T) -> None:
        self.merge(CrdtMap([(k, v)]))

    def items(self) -> list[tuple[Any, T]]:
        return list(self.vals)

    def merge(self, other: "CrdtMap[T]") -> None:
        out: dict[bytes, tuple[Any, T]] = {_ord_key(k): (k, v) for k, v in self.vals}
        for k, v in other.vals:
            kk = _ord_key(k)
            if kk in out:
                out[kk] = (k, merge_values(out[kk][1], v))
            else:
                out[kk] = (k, _adopt(v))
        self.vals = [out[kk] for kk in sorted(out)]

    def to_obj(self) -> Any:
        return [[k, v.to_obj() if isinstance(v, Crdt) else v] for k, v in self.vals]

    @classmethod
    def from_obj(cls, obj: Any, value_from: Callable[[Any], T] | None = None) -> "CrdtMap[T]":
        return cls([(k, value_from(v) if value_from else v) for k, v in obj])

    def __len__(self) -> int:
        return len(self.vals)

    def __iter__(self) -> Iterator[tuple[Any, T]]:
        return iter(self.vals)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, CrdtMap) and self.to_obj() == other.to_obj()


class Bool(Crdt):
    """OR-merged boolean; used for tombstone `deleted` flags
    (reference src/util/crdt/bool.rs)."""

    __slots__ = ("value",)

    def __init__(self, value: bool = False):
        self.value = bool(value)

    def get(self) -> bool:
        return self.value

    def set(self) -> None:
        self.value = True

    def merge(self, other: "Bool") -> None:
        self.value = self.value or other.value

    def to_obj(self) -> Any:
        return self.value

    @classmethod
    def from_obj(cls, obj: Any) -> "Bool":
        return cls(bool(obj))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Bool) and self.value == other.value

    def __repr__(self) -> str:
        return f"Bool({self.value})"


class Deletable(Crdt, Generic[T]):
    """Present(inner CRDT) | Deleted, deletion winning
    (reference src/util/crdt/deletable.rs)."""

    __slots__ = ("inner",)

    def __init__(self, inner: T | None):
        self.inner = inner

    @classmethod
    def present(cls, v: T) -> "Deletable[T]":
        return cls(v)

    @classmethod
    def deleted(cls) -> "Deletable[T]":
        return cls(None)

    def is_deleted(self) -> bool:
        return self.inner is None

    def get(self) -> T | None:
        return self.inner

    def merge(self, other: "Deletable[T]") -> None:
        if other.inner is None:
            self.inner = None
        elif self.inner is not None:
            self.inner = merge_values(self.inner, other.inner)
        # note: Present never resurrects a Deleted (deletion wins)

    def to_obj(self) -> Any:
        if self.inner is None:
            return None
        return [self.inner.to_obj() if isinstance(self.inner, Crdt) else self.inner]

    @classmethod
    def from_obj(cls, obj: Any, value_from: Callable[[Any], T] | None = None) -> "Deletable[T]":
        if obj is None:
            return cls(None)
        (v,) = obj
        return cls(value_from(v) if value_from else v)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Deletable) and self.to_obj() == other.to_obj()
