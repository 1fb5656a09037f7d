"""The port's data model (garage_tpu_torch/model) held to the reference
on the CPU.

  - the reference's own model tests (tests/test_model.py) on the port's
    object table;
  - each schema (object, version, block_ref, multipart upload, bucket,
    alias, key, counter, K2V item) encodes the same seeded entries to the
    reference's bytes, decodes the reference's bytes to an entry that
    encodes back to them (and the other way round), puts them under the
    same tree key, and CRDT-merges two seeded entries of one key to the
    reference's merge, byte for byte;
  - every row that a seeded S3 and K2V workload leaves in the tables of
    one node of either package decodes in the other package and encodes
    back to the same bytes.
"""

import asyncio
import random
import types

import pytest
import torch

import garage_tpu.model.bucket_alias_table as j_alias
import garage_tpu.model.bucket_table as j_bucket
import garage_tpu.model.index_counter as j_counter
import garage_tpu.model.k2v.item_table as j_item
import garage_tpu.model.key_table as j_key
import garage_tpu.model.permission as j_perm
import garage_tpu.model.s3.block_ref_table as j_block_ref
import garage_tpu.model.s3.mpu_table as j_mpu
import garage_tpu.model.s3.object_table as j_object
import garage_tpu.model.s3.version_table as j_version
import garage_tpu.utils.crdt as j_crdt
import garage_tpu.utils.serde as j_serde
import garage_tpu_torch.model.bucket_alias_table as t_alias
import garage_tpu_torch.model.bucket_table as t_bucket
import garage_tpu_torch.model.index_counter as t_counter
import garage_tpu_torch.model.k2v.item_table as t_item
import garage_tpu_torch.model.key_table as t_key
import garage_tpu_torch.model.permission as t_perm
import garage_tpu_torch.model.s3.block_ref_table as t_block_ref
import garage_tpu_torch.model.s3.mpu_table as t_mpu
import garage_tpu_torch.model.s3.object_table as t_object
import garage_tpu_torch.model.s3.version_table as t_version
import garage_tpu_torch.utils.crdt as t_crdt
import garage_tpu_torch.utils.serde as t_serde
import test_s3_api as ref_s3
from test_torch_s3 import mirrored_tests, port_mirror, s3_mirror
from torch_mirror import time_limit

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

# a test still running after 3 minutes ends its worker process, so that no
# scenario can hold the suite past its clock
_limit = time_limit(180)

model_mirror = port_mirror("test_model.py")
globals().update(mirrored_tests(model_mirror, "model"))


def package(crdt, serde, obj, ver, ref, mpu, bucket, alias, key, perm, counter, item):
    """One package's model classes and schemas, under the names `seeded` uses."""
    return types.SimpleNamespace(
        Lww=crdt.Lww, LwwMap=crdt.LwwMap, CrdtMap=crdt.CrdtMap, Bool=crdt.Bool,
        Deletable=crdt.Deletable, pack=serde.pack, unpack=serde.unpack,
        Object=obj.Object, ObjectVersion=obj.ObjectVersion, Version=ver.Version,
        BlockRef=ref.BlockRef, MultipartUpload=mpu.MultipartUpload,
        Bucket=bucket.Bucket, BucketParams=bucket.BucketParams,
        BucketAlias=alias.BucketAlias, Key=key.Key, KeyParams=key.KeyParams,
        BucketKeyPerm=perm.BucketKeyPerm, CounterEntry=counter.CounterEntry,
        K2VItem=item.K2VItem,
        schemas={
            "object": obj.ObjectTable(), "version": ver.VersionTable(),
            "block_ref": ref.BlockRefTable(), "multipart_upload": mpu.MpuTable(),
            "bucket": bucket.BucketTable(), "bucket_alias": alias.BucketAliasTable(),
            "key": key.KeyTable(), "bucket_object_counter":
                counter.CounterTable("bucket_object_counter"),
            "k2v_item": item.K2VItemTable(),
        },
    )


J = package(j_crdt, j_serde, j_object, j_version, j_block_ref, j_mpu, j_bucket, j_alias,
            j_key, j_perm, j_counter, j_item)
T = package(t_crdt, t_serde, t_object, t_version, t_block_ref, t_mpu, t_bucket, t_alias,
            t_key, t_perm, t_counter, t_item)


def seeded(P, table: str, seed: int, ident: bytes):
    """A seeded entry of `table` built with package P's classes; `ident`
    fixes its key, so two seeds give two replicas of one entry."""
    rng = random.Random(seed)
    b, n = rng.randbytes, lambda: rng.randint(1, 1 << 40)
    name = "k-" + ident.hex()[:12]
    if table == "object":
        versions = []
        for state, kind in (("complete", "inline"), ("complete", "first_block"),
                            ("uploading", "first_block"), ("aborted", "first_block"),
                            ("complete", "delete_marker"))[rng.randint(0, 2):]:
            uuid = b(32)
            data = {"t": kind}
            if kind != "delete_marker":
                data["meta"] = {"size": rng.randint(0, 1 << 30), "etag": b(16).hex(),
                                "headers": [["content-type", "application/octet-stream"]]}
            if kind == "inline":
                data["bytes"] = b(rng.randint(0, 64))
            elif kind == "first_block":
                data["vid"] = uuid
            versions.append(P.ObjectVersion(uuid, n(), state, data))
        return P.Object(ident, name, versions)
    if table == "version":
        blocks = P.CrdtMap()
        for i in range(rng.randint(1, 6)):
            blocks.put([rng.randint(0, 3), i * 8192], {"h": b(32), "s": rng.randint(1, 8192)})
        parts = P.CrdtMap()
        for p in range(rng.randint(0, 3)):
            parts.put(p + 1, b(16).hex())
        return P.Version(ident, b(32), name, blocks, parts, P.Bool(rng.random() < 0.3))
    if table == "block_ref":
        return P.BlockRef(ident, b(32), P.Bool(rng.random() < 0.5))
    if table == "multipart_upload":
        parts = P.CrdtMap()
        for p in range(rng.randint(1, 4)):
            parts.put([p + 1, n()], {"vid": b(32), "etag": b(16).hex(), "size": n()})
        return P.MultipartUpload(ident, b(32), name, n(), parts, P.Bool(rng.random() < 0.3),
                                 {"alg": "AES256", "md5": b(16).hex()} if rng.random() < 0.5
                                 else None, [["content-type", "text/plain"]])
    if table == "bucket":
        params = P.BucketParams(
            creation_date=n(), aliases=P.LwwMap([(name, n(), True)]),
            local_aliases=P.LwwMap([([b(8).hex(), name], n(), rng.random() < 0.5)]),
            website=P.Lww.raw(n(), {"index_document": "index.html", "error_document": None}),
            cors=P.Lww.raw(n(), None), lifecycle=P.Lww.raw(n(), []),
            quotas=P.Lww.raw(n(), {"max_size": n(), "max_objects": None}))
        state = P.Deletable.deleted() if rng.random() < 0.2 else P.Deletable.present(params)
        return P.Bucket(ident, state)
    if table == "bucket_alias":
        return P.BucketAlias(name, P.Lww.raw(n(), b(32) if rng.random() < 0.7 else None))
    if table == "key":
        perms = P.LwwMap([(b(32), n(), P.BucketKeyPerm(n(), True, rng.random() < 0.5,
                                                       False).to_obj())])
        params = P.KeyParams(b(32).hex(), P.Lww.raw(n(), name), P.Lww.raw(n(), True), perms,
                             P.LwwMap([(name, n(), b(32))]))
        return P.Key("GK" + ident.hex()[:24], P.Deletable.present(params))
    if table == "bucket_object_counter":
        values = {c: {b(32): [n(), rng.randint(0, 1 << 20)] for _ in range(rng.randint(1, 3))}
                  for c in ("objects", "bytes", "unfinished_uploads")}
        return P.CounterEntry(ident, b"", values)
    if table == "k2v_item":
        items = {b(32): {"t": rng.randint(0, 9), "v": [[rng.randint(10, 20), b(8)],
                                                       [rng.randint(21, 30), None]]}
                 for _ in range(rng.randint(1, 3))}
        return P.K2VItem(ident, name, "sort/" + b(3).hex(), items)
    raise KeyError(table)


def encode(P, table: str, entry) -> bytes:
    return P.pack(P.schemas[table].encode_entry(entry))


def decode(P, table: str, blob: bytes):
    return P.schemas[table].decode_entry(P.unpack(blob))


def tree_key(P, table: str, entry) -> bytes:
    s = P.schemas[table]
    return s.tree_key(s.entry_partition_key(entry), s.entry_sort_key(entry))


TABLES = sorted(J.schemas)


@pytest.mark.parametrize("table", TABLES)
def test_schema_encodes_decodes_and_merges_like_the_reference(table):
    for seed in range(20):
        ident = random.Random(1000 + seed).randbytes(32)
        je, te = seeded(J, table, seed, ident), seeded(T, table, seed, ident)
        jb, tb = encode(J, table, je), encode(T, table, te)
        assert tb == jb, (table, seed)
        assert tree_key(T, table, te) == tree_key(J, table, je)
        # each package decodes the other's bytes to an entry that encodes back
        assert encode(T, table, decode(T, table, jb)) == jb
        assert encode(J, table, decode(J, table, tb)) == tb
        # two replicas of one key: merged in either order, as the reference merges
        jx, tx = seeded(J, table, seed + 500, ident), seeded(T, table, seed + 500, ident)
        for first, second in ((0, 1), (1, 0)):
            jm = [decode(J, table, encode(J, table, e)) for e in (je, jx)]
            tm = [decode(T, table, encode(T, table, e)) for e in (te, tx)]
            jr = J.schemas[table].merge_entries(jm[first], jm[second])
            tr = T.schemas[table].merge_entries(tm[first], tm[second])
            assert encode(T, table, tr) == encode(J, table, jr), (table, seed, first)


async def workload(make_daemon, tmp_path) -> dict[str, list[bytes]]:
    """A seeded S3 and K2V workload on one node of the package whose
    `make_daemon` is given; returns every table's stored rows."""
    rng = random.Random(5)
    garage, s3, endpoint = await make_daemon(tmp_path, block_size=4096)
    try:
        key = await garage.helper.create_key("model-key")
        key.params().allow_create_bucket.update(True)
        await garage.key_table.insert(key)
        client = s3_mirror.S3Client(endpoint, key.key_id, key.secret())
        try:
            await client.create_bucket("model-bucket")
            for i, size in enumerate((10, 3000, 20000, 9000, 5000, 10)):
                await client.put_object("model-bucket", f"obj/{i}", rng.randbytes(size))
            await client.delete_object("model-bucket", "obj/0")
            uid = await client.create_multipart_upload("model-bucket", "mpu/done")
            etag = await client.upload_part("model-bucket", "mpu/done", uid, 1,
                                            rng.randbytes(9000))
            await client.complete_multipart_upload("model-bucket", "mpu/done", uid,
                                                   [(1, etag)])
            uid = await client.create_multipart_upload("model-bucket", "mpu/open")
            await client.upload_part("model-bucket", "mpu/open", uid, 1, rng.randbytes(5000))
        finally:
            await client.close()
        bucket_id = await garage.helper.resolve_bucket("model-bucket", key)
        for i in range(4):
            await garage.k2v_rpc.insert(bucket_id, "part", f"item/{i}", None, rng.randbytes(16))
        for _ in range(200):  # until the insert queue has written the counters
            if len(garage.object_counter_table.data.store) and len(
                    garage.k2v_counter_table.data.store):
                break
            await asyncio.sleep(0.05)
        return {t.schema.table_name: [v for _k, v in t.data.store.iter_range()]
                for t in garage.tables}
    finally:
        await ref_s3.teardown(garage, s3)


async def port_daemon(tmp_path, block_size):
    return await s3_mirror.make_daemon(tmp_path, block_size=block_size)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_workload_rows_cross_decode_bit_exact(tmp_path, writer):
    make = ref_s3.make_daemon if writer == "reference" else port_daemon
    rows = asyncio.run(asyncio.wait_for(workload(make, tmp_path), 60))
    reader = T if writer == "reference" else J
    assert sorted(rows) == sorted([*J.schemas, "k2v_index_counter"])
    for table, blobs in rows.items():
        schema = "bucket_object_counter" if table == "k2v_index_counter" else table
        assert blobs, table
        for blob in blobs:
            assert encode(reader, schema, decode(reader, schema, blob)) == blob, table
    assert len(rows["object"]) == 8 and len(rows["version"]) >= 4
    assert len(rows["block_ref"]) >= 4 and len(rows["multipart_upload"]) == 2
    assert len(rows["k2v_item"]) == 4
