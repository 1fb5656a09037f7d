"""Admin helpers: bucket/key lifecycle with invariant checks.

Reference src/model/helper/{bucket,key,locked}.rs — admin mutations that
touch several entries (bucket + alias + key permissions) are serialized
through one lock per node; cross-node races converge by CRDT (two
concurrent create-bucket calls for the same alias: the LWW alias points to
one winner, the loser's bucket remains unaliased and can be cleaned up).
"""

from __future__ import annotations

import asyncio

from ..utils.crdt import Deletable, Lww
from ..utils.data import gen_uuid
from ..utils.error import Error
from .bucket_alias_table import BucketAlias, valid_bucket_name
from .bucket_table import Bucket
from .key_table import Key
from .permission import BucketKeyPerm
from .s3.object_table import Object


class GarageHelper:
    def __init__(self, garage):
        self.garage = garage
        self.lock = asyncio.Lock()

    # --- resolution -----------------------------------------------------------

    async def resolve_bucket(self, name: str, key: Key | None = None) -> bytes:
        """Bucket name -> id: local alias of the key first, then global
        alias (reference helper/bucket.rs resolve_bucket)."""
        if key is not None and key.params() is not None:
            local = key.params().local_aliases.get(name)
            if local:
                return bytes(local)
        alias = await self.garage.bucket_alias_table.get(name.encode(), b"")
        if alias is not None and alias.state.get() is not None:
            return bytes(alias.state.get())
        raise Error(f"bucket {name!r} not found")

    async def get_bucket(self, bucket_id: bytes) -> Bucket:
        b = await self.garage.bucket_table.get(bucket_id, b"")
        if b is None or b.is_deleted():
            raise Error(f"bucket {bucket_id.hex()[:16]} not found")
        return b

    async def get_key(self, key_id: str) -> Key:
        k = await self.garage.key_table.get(key_id.encode(), b"")
        if k is None or k.is_deleted():
            raise Error(f"key {key_id} not found")
        return k

    # --- bucket lifecycle -----------------------------------------------------

    async def create_bucket(self, name: str) -> bytes:
        if not valid_bucket_name(name, self.garage.config.allow_punycode):
            raise Error(f"invalid bucket name {name!r}")
        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            existing = await self.garage.bucket_alias_table.get(name.encode(), b"")
            if existing is not None and existing.state.get() is not None:
                raise Error(f"bucket {name!r} already exists")
            bucket = Bucket.new(gen_uuid())
            bucket.params().aliases.update_in_place(name, True)
            await self.garage.bucket_table.insert(bucket)
            if existing is not None:
                existing.state.update(bucket.id)
                await self.garage.bucket_alias_table.insert(existing)
            else:
                await self.garage.bucket_alias_table.insert(
                    BucketAlias.new(name, bucket.id)
                )
            return bucket.id

    async def delete_bucket(self, bucket_id: bytes) -> None:
        """Delete an EMPTY bucket and its aliases."""
        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            bucket = await self.get_bucket(bucket_id)
            objs = await self.garage.object_table.get_range(
                bucket_id, None, "visible", 1
            )
            if objs:
                raise Error("bucket is not empty")
            params = bucket.params()
            for name, v in params.aliases.items():
                if v:
                    alias = await self.garage.bucket_alias_table.get(name.encode(), b"")
                    if alias and alias.state.get() == bucket_id:
                        alias.state.update(None)
                        await self.garage.bucket_alias_table.insert(alias)
            bucket.state = Deletable.deleted()
            await self.garage.bucket_table.insert(bucket)

    async def list_buckets(self) -> list[Bucket]:
        out = []
        aliases = await self.garage.bucket_alias_table.get_all_local()
        seen = set()
        for a in aliases:
            bid = a.state.get()
            if bid is not None and bytes(bid) not in seen:
                seen.add(bytes(bid))
                try:
                    out.append(await self.get_bucket(bytes(bid)))
                except Error:
                    pass
        return out

    # --- aliases (reference helper/locked.rs alias ops) -----------------------

    async def set_global_alias(self, bucket_id: bytes, alias: str) -> None:
        if not valid_bucket_name(alias, self.garage.config.allow_punycode):
            raise Error(f"invalid alias {alias!r}")
        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            bucket = await self.get_bucket(bucket_id)
            existing = await self.garage.bucket_alias_table.get(alias.encode(), b"")
            if (
                existing is not None
                and existing.state.get() is not None
                and bytes(existing.state.get()) != bucket_id
            ):
                raise Error(f"alias {alias!r} already points to another bucket")
            if existing is not None:
                existing.state.update(bucket_id)
                await self.garage.bucket_alias_table.insert(existing)
            else:
                await self.garage.bucket_alias_table.insert(
                    BucketAlias.new(alias, bucket_id)
                )
            bucket.params().aliases.update_in_place(alias, True)
            await self.garage.bucket_table.insert(bucket)

    async def unset_global_alias(self, bucket_id: bytes, alias: str) -> None:
        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            bucket = await self.get_bucket(bucket_id)
            params = bucket.params()
            live = [n for n, v in params.aliases.items() if v]
            has_local = any(
                True
                for k in await self.list_keys()
                for n, b in k.params().local_aliases.items()
                if b is not None and bytes(b) == bucket_id
            )
            if live == [alias] and not has_local:
                raise Error(
                    f"{alias!r} is the bucket's last alias; removing it would "
                    "make the bucket unreachable"
                )
            a = await self.garage.bucket_alias_table.get(alias.encode(), b"")
            if a is None or a.state.get() is None or bytes(a.state.get()) != bucket_id:
                raise Error(f"alias {alias!r} does not point to this bucket")
            a.state.update(None)
            await self.garage.bucket_alias_table.insert(a)
            params.aliases.update_in_place(alias, False)
            await self.garage.bucket_table.insert(bucket)

    async def set_local_alias(self, bucket_id: bytes, key_id: str, alias: str) -> None:
        if not valid_bucket_name(alias, self.garage.config.allow_punycode):
            raise Error(f"invalid alias {alias!r}")
        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            await self.get_bucket(bucket_id)
            key = await self.get_key(key_id)
            cur = key.params().local_aliases.get(alias)
            if cur is not None and bytes(cur) != bucket_id:
                raise Error(f"key already uses alias {alias!r} for another bucket")
            key.params().local_aliases.update_in_place(alias, bucket_id)
            await self.garage.key_table.insert(key)

    async def unset_local_alias(self, bucket_id: bytes, key_id: str, alias: str) -> None:
        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            key = await self.get_key(key_id)
            cur = key.params().local_aliases.get(alias)
            if cur is None or bytes(cur) != bucket_id:
                raise Error(f"alias {alias!r} does not point to this bucket")
            key.params().local_aliases.update_in_place(alias, None)
            await self.garage.key_table.insert(key)

    # --- key lifecycle --------------------------------------------------------

    async def create_key(self, name: str = "") -> Key:
        key = Key.new(name)
        await self.garage.key_table.insert(key)
        return key

    async def delete_key(self, key_id: str) -> None:
        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            key = await self.get_key(key_id)
            key.state = Deletable.deleted()
            await self.garage.key_table.insert(key)

    async def list_keys(self) -> list[Key]:
        ks = await self.garage.key_table.get_all_local()
        return [k for k in ks if not k.is_deleted()]

    async def update_key(
        self,
        key_id: str,
        name: str | None = None,
        allow_create_bucket: bool | None = None,
    ) -> Key:
        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            key = await self.get_key(key_id)
            if name is not None:
                key.params().name.update(name)
            if allow_create_bucket is not None:
                key.params().allow_create_bucket.update(allow_create_bucket)
            await self.garage.key_table.insert(key)
            return key

    async def import_key(self, key_id: str, secret: str, name: str = "") -> Key:
        """Import an existing credential pair (reference key import)."""
        from .key_table import KeyParams
        from ..utils.crdt import Deletable

        if not key_id.startswith("GK") or len(secret) != 64:
            raise Error("malformed key id or secret")
        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            existing = await self.garage.key_table.get(key_id.encode(), b"")
            if existing is not None:
                # a deleted key leaves a delete-wins CRDT tombstone: an
                # import under the same id would silently converge back to
                # deleted — refuse instead of lying
                raise Error(
                    f"key {key_id} already exists"
                    if not existing.is_deleted()
                    else f"key id {key_id} was deleted and cannot be reused"
                )
            params = KeyParams(secret)
            params.name.update(name)
            key = Key(key_id, Deletable.present(params))
            await self.garage.key_table.insert(key)
            return key

    async def set_bucket_key_permissions(
        self, bucket_id: bytes, key_id: str, read: bool, write: bool, owner: bool
    ) -> None:
        from ..utils.time_util import now_msec

        async with self.lock:  # graft-lint: allow-lock-await(admin-plane RMW serialization: the global helper lock must span the table quorum ops; no nested locks, RPC timeouts bound the hold)
            key = await self.get_key(key_id)
            await self.get_bucket(bucket_id)  # must exist
            perm = BucketKeyPerm(now_msec(), read, write, owner)
            key.params().authorized_buckets.update_in_place(bucket_id, perm.to_obj())
            await self.garage.key_table.insert(key)

    # --- object listing (used by delete_bucket and the CLI) -------------------

    async def bucket_is_empty(self, bucket_id: bytes) -> bool:
        objs = await self.garage.object_table.get_range(bucket_id, None, "visible", 1)
        return not objs
