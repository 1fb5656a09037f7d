"""Multipart uploads (reference src/api/s3/multipart.rs).

Create/UploadPart/Complete/Abort/ListParts/ListMultipartUploads.  Each
part gets its own Version entry whose blocks are written with the normal
bounded pipeline; Complete assembles a final Version referencing every
kept part's blocks as [part_number, offset] keys, inserts fresh block
refs for it, then tombstones the part versions (stale re-uploads
included) — refcounts make the handoff safe.
"""

from __future__ import annotations

import asyncio
import hashlib
import xml.etree.ElementTree as ET

from aiohttp import web

from ...model.s3.block_ref_table import BlockRef
from ...model.s3.mpu_table import MultipartUpload
from ...model.s3.object_table import Object, ObjectVersion
from ...model.s3.version_table import Version
from ...utils.data import blake2sum, gen_uuid
from ...utils.latency import mark_op, phase_span
from ...utils.time_util import now_msec
from ..common.error import ApiError, BadRequest, NoSuchKey, NoSuchUpload
from .objects import PUT_BLOCKS_MAX_PARALLEL, _check_sha256, extract_meta_headers
from .xml_util import xml_doc


async def _gather_chunked(coros, window: int = 64) -> list:
    """Await independent metadata ops in bounded concurrent windows: one
    round-trip per window instead of one per op, without letting a
    1000-part complete flood the RPC layer all at once."""
    out: list = []
    for i in range(0, len(coros), window):
        try:
            # return_exceptions: the whole window DRAINS before a
            # failure re-raises — a plain gather would return on the
            # first error while its sibling tasks keep mutating the
            # metadata tables behind the handler's 500
            res = await asyncio.gather(
                *coros[i : i + window], return_exceptions=True
            )
        except BaseException:
            # caller cancelled: gather already cancelled the window
            for c in coros[i + window :]:
                c.close()  # never-awaited coroutines would warn at GC
            raise
        err = next((r for r in res if isinstance(r, BaseException)), None)
        if err is not None:
            for c in coros[i + window :]:
                c.close()
            raise err
        out.extend(res)
    return out


async def handle_create_multipart_upload(garage, bucket_id, key, request):
    from .encryption import EncryptionParams

    from .objects import next_timestamp

    enc = EncryptionParams.from_headers(request.headers)
    upload_id = gen_uuid()
    headers = extract_meta_headers(request)
    existing = await garage.object_table.get(bucket_id, key.encode())
    mpu = MultipartUpload(
        upload_id, bucket_id, key, timestamp=next_timestamp(existing),
        enc=enc.meta() if enc else None, hdrs=headers,
    )
    await garage.mpu_table.insert(mpu)
    # an uploading object version marks the in-flight upload in listings
    ov = ObjectVersion(
        upload_id, mpu.timestamp, "uploading",
        {"t": "first_block", "vid": upload_id, "mpu": True, "hdrs": headers},
    )
    await garage.object_table.insert(Object(bucket_id, key, [ov]))
    return web.Response(
        text=xml_doc(
            "InitiateMultipartUploadResult",
            [("Bucket", ""), ("Key", key), ("UploadId", upload_id.hex())],
        ),
        content_type="application/xml",
    )


async def _get_mpu(garage, bucket_id, key, upload_id_hex) -> MultipartUpload:
    try:
        upload_id = bytes.fromhex(upload_id_hex)
        assert len(upload_id) == 32
    except (ValueError, AssertionError) as e:
        raise NoSuchUpload(f"malformed upload id") from e
    mpu = await garage.mpu_table.get(upload_id, b"")
    if mpu is None or mpu.deleted.get() or mpu.bucket_id != bucket_id or mpu.key != key:
        raise NoSuchUpload("upload not found")
    return mpu


async def handle_upload_part(garage, bucket_id, key, request, ctx=None):
    mark_op("upload_part")
    q = request.query
    part_number = int(q.get("partNumber", "0"))
    if not (1 <= part_number <= 10000):
        raise BadRequest("partNumber must be in 1..10000")
    with phase_span("index_read"):
        mpu = await _get_mpu(garage, bucket_id, key, q.get("uploadId", ""))

    from ..common.checksum import ChecksumRequest
    from .encryption import EncryptionParams, check_match

    enc = EncryptionParams.from_headers(request.headers)
    check_match(mpu.enc, enc)  # SSE-C fixed at create; parts must match
    cks = ChecksumRequest.from_headers(request.headers)

    vid = gen_uuid()  # this part's own version
    with phase_span("meta_commit"):
        await garage.version_table.insert(Version(vid, bucket_id, key))
    from .objects import stream_blocks

    try:
        md5_hex, sha, total, _blocks = await stream_blocks(
            garage, vid, bucket_id, key, part_number,
            request.content, garage.config.block_size,
            transform=enc.encrypt_block if enc else None, extra_hash=cks,
        )
        _check_sha256(ctx, sha)
        if cks is not None:
            cks.verify()
    except BaseException:
        await garage.version_table.insert(
            Version.deleted_marker(vid, bucket_id, key)
        )
        raise

    etag = md5_hex
    upd = MultipartUpload(mpu.upload_id, bucket_id, key, timestamp=mpu.timestamp)
    upd.parts.put([part_number, now_msec()], {"vid": vid, "etag": etag, "s": total})
    with phase_span("meta_commit"):
        await garage.mpu_table.insert(upd)
    return web.Response(status=200, headers={"ETag": f'"{etag}"'})


class _GenBody:
    """Adapts an async chunk generator to the .read(n) body interface the
    stream_blocks pipeline consumes."""

    def __init__(self, gen):
        self._gen = gen
        self._buf = b""

    async def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                self._buf += await self._gen.__anext__()
            except StopAsyncIteration:
                break
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def _parse_copy_source_range(request, size: int) -> tuple[int, int]:
    """x-amz-copy-source-range: "bytes=a-b" (both bounds inclusive and
    required, unlike a GET Range)."""
    hdr = request.headers.get("x-amz-copy-source-range")
    if hdr is None:
        return (0, size)
    if not hdr.startswith("bytes="):
        raise BadRequest(f"bad x-amz-copy-source-range {hdr!r}")
    a_s, _, b_s = hdr[len("bytes="):].partition("-")
    try:
        a, b = int(a_s), int(b_s)
    except ValueError as e:
        raise BadRequest(f"bad x-amz-copy-source-range {hdr!r}") from e
    if a > b or b >= size:
        raise ApiError(
            f"copy source range {hdr!r} outside object of size {size}",
            code="InvalidRange",
            status=416,
        )
    return (a, b + 1)


async def handle_upload_part_copy(
    garage, helper, api_key, bucket_id, key, request, ctx=None
):
    """UploadPartCopy (reference src/api/s3/copy.rs:353
    handle_upload_part_copy): read the source object (decrypting SSE-C
    with the x-amz-copy-source-…-customer-* key when present), re-chunk
    the plaintext at this cluster's block size, and store it as a part of
    the destination upload under the destination's own encryption — the
    cross-encryption path re-seals every block."""
    q = request.query
    part_number = int(q.get("partNumber", "0"))
    if not (1 <= part_number <= 10000):
        raise BadRequest("partNumber must be in 1..10000")
    mpu = await _get_mpu(garage, bucket_id, key, q.get("uploadId", ""))

    from .copy_delete import resolve_copy_source
    from .encryption import EncryptionParams, check_match
    from .objects import plain_block_stream, stream_blocks

    dst_enc = EncryptionParams.from_headers(request.headers)
    check_match(mpu.enc, dst_enc)
    sv = await resolve_copy_source(garage, helper, api_key, request)
    src_meta = sv.data.get("meta", {})
    src_enc = EncryptionParams.from_copy_source_headers(request.headers)
    check_match(src_meta.get("enc"), src_enc)
    size = src_meta.get("size", 0)
    start, end = _parse_copy_source_range(request, size)

    if sv.data.get("t") == "inline":
        data = sv.data["bytes"]
        if src_enc is not None:
            data = src_enc.decrypt_block(data)

        async def _one():
            yield data[start:end]

        body = _GenBody(_one())
    else:
        src_ver = await garage.version_table.get(bytes(sv.data["vid"]), b"")
        if src_ver is None or src_ver.deleted.get():
            raise NoSuchKey("copy source data missing")
        body = _GenBody(
            plain_block_stream(garage, src_ver.sorted_blocks(), start, end, src_enc)
        )

    vid = gen_uuid()
    await garage.version_table.insert(Version(vid, bucket_id, key))
    try:
        md5_hex, _sha, total, _blocks = await stream_blocks(
            garage, vid, bucket_id, key, part_number,
            body, garage.config.block_size,
            transform=dst_enc.encrypt_block if dst_enc else None,
        )
    except BaseException:
        await garage.version_table.insert(
            Version.deleted_marker(vid, bucket_id, key)
        )
        raise

    etag = md5_hex
    ts = now_msec()
    upd = MultipartUpload(mpu.upload_id, bucket_id, key, timestamp=mpu.timestamp)
    upd.parts.put([part_number, ts], {"vid": vid, "etag": etag, "s": total})
    await garage.mpu_table.insert(upd)
    from .xml_util import http_iso

    return web.Response(
        text=xml_doc(
            "CopyPartResult",
            [("LastModified", http_iso(ts)), ("ETag", f'"{etag}"')],
        ),
        content_type="application/xml",
    )


async def handle_complete_multipart_upload(garage, bucket_id, key, request, ctx=None):
    body = await request.read()
    from ..common.signature import check_payload

    await check_payload(body, ctx) if ctx else None
    mpu = await _get_mpu(garage, bucket_id, key, request.query.get("uploadId", ""))
    try:
        root = ET.fromstring(body.decode())
        req_parts = []
        for p in root.iter():
            if p.tag.endswith("Part"):
                pn = etag = None
                for c in p:
                    if c.tag.endswith("PartNumber"):
                        pn = int(c.text)
                    elif c.tag.endswith("ETag"):
                        etag = c.text.strip().strip('"')
                req_parts.append((pn, etag))
    except ET.ParseError as e:
        raise BadRequest(f"malformed CompleteMultipartUpload XML: {e}") from e
    if not req_parts:
        raise BadRequest("no parts in CompleteMultipartUpload")
    # strictly increasing (reference multipart.rs InvalidPartOrder): a
    # duplicated PartNumber would be assembled once but double-counted in
    # size/ETag-part-count metadata
    pns = [p for p, _ in req_parts]
    if any(p1 >= p2 for p1, p2 in zip(pns, pns[1:])):
        raise BadRequest(
            "parts must be listed in strictly ascending order",
            code="InvalidPartOrder",
        )

    have = mpu.latest_parts()
    for pn, etag in req_parts:
        if pn not in have or have[pn]["etag"] != etag:
            raise ApiError("part missing or etag mismatch", code="InvalidPart", status=400)

    # assemble the final version from the kept parts' blocks.  The part
    # versions are independent rows: fetch them in one concurrent window
    # instead of one quorum read per part (a 1000-part complete used to
    # pay 1000 sequential round-trips here).
    final = Version(mpu.upload_id, bucket_id, key)
    total = 0
    etags_md5 = hashlib.md5()
    kept_vids = []
    part_versions = await _gather_chunked(
        [
            garage.version_table.get(bytes(have[pn]["vid"]), b"")
            for pn, _etag in req_parts
        ]
    )
    for (pn, _etag), pv in zip(req_parts, part_versions):
        part = have[pn]
        kept_vids.append(bytes(part["vid"]))
        etags_md5.update(bytes.fromhex(part["etag"]))
        if pv is None or pv.deleted.get():
            raise ApiError("part data lost", code="InvalidPart", status=400)
        for (p_pn, off), blk in pv.sorted_blocks():
            final.blocks.put([pn, off], {"h": blk["h"], "s": blk["s"]})
            total += blk["s"]
            if mpu.enc is not None:
                from .encryption import OVERHEAD

                total -= OVERHEAD  # meta size is plaintext
    await garage.version_table.insert(final)
    # fresh refs for the final version BEFORE tombstoning part versions
    # (same ordering guarantee as the sequential loop — every ref commit
    # completes before any tombstone below is issued)
    await _gather_chunked(
        [
            garage.block_ref_table.insert(BlockRef(blk["h"], final.uuid))
            for _k, blk in final.sorted_blocks()
        ]
    )
    etag = f"{etags_md5.hexdigest()}-{len(req_parts)}"
    # metadata captured at CreateMultipartUpload lives on the mpu row
    # (the uploading marker version can be pruned by a concurrent
    # complete PutObject; upgrade path: fall back to the marker for
    # uploads created before hdrs moved here)
    hdrs = [list(h) for h in mpu.hdrs] if mpu.hdrs else []
    if not hdrs:
        obj = await garage.object_table.get(bucket_id, key.encode())
        if obj is not None:
            for v in obj.versions:
                if bytes(v.uuid) == bytes(mpu.upload_id):
                    hdrs = [list(h) for h in v.data.get("hdrs", [])]
                    break
    meta = {"size": total, "etag": etag, "headers": hdrs}
    if mpu.enc is not None:
        meta["enc"] = mpu.enc
    ov = ObjectVersion(
        mpu.upload_id,
        mpu.timestamp,
        "complete",
        {"t": "first_block", "vid": final.uuid, "meta": meta},
    )
    await garage.object_table.insert(Object(bucket_id, key, [ov]))
    # warm the metadata fast path with the assembled final version (the
    # exact row quorum-committed above) — the next GET skips the
    # version quorum read
    garage.version_cache.put(final.uuid, final)
    # tombstone part versions (incl. stale re-uploads) and close the mpu
    await _gather_chunked(
        [
            garage.version_table.insert(
                Version.deleted_marker(bytes(v["vid"]), bucket_id, key)
            )
            for _k, v in mpu.parts.items()
            if bytes(v["vid"]) != final.uuid
        ]
    )
    closed = MultipartUpload(mpu.upload_id, bucket_id, key, timestamp=mpu.timestamp)
    closed.deleted.set()
    await garage.mpu_table.insert(closed)
    return web.Response(
        text=xml_doc(
            "CompleteMultipartUploadResult",
            [("Bucket", ""), ("Key", key), ("ETag", f'"{etag}"')],
        ),
        content_type="application/xml",
    )


async def handle_abort_multipart_upload(garage, bucket_id, key, request):
    mpu = await _get_mpu(garage, bucket_id, key, request.query.get("uploadId", ""))
    closed = MultipartUpload(mpu.upload_id, bucket_id, key, timestamp=mpu.timestamp)
    closed.deleted.set()
    await garage.mpu_table.insert(closed)  # cascade deletes part versions
    aborted = ObjectVersion(
        mpu.upload_id, mpu.timestamp, "aborted", {"t": "first_block", "vid": mpu.upload_id}
    )
    await garage.object_table.insert(Object(bucket_id, key, [aborted]))
    return web.Response(status=204)


async def handle_list_parts(garage, bucket_id, key, request):
    mpu = await _get_mpu(garage, bucket_id, key, request.query.get("uploadId", ""))
    # pagination (reference list.rs ListParts state machine):
    # part-number-marker is exclusive, max-parts caps the page
    q = request.query
    max_parts = max(1, min(int(q.get("max-parts", "1000")), 1000))
    marker = int(q.get("part-number-marker", "0"))
    parts = mpu.latest_parts()
    pns = [pn for pn in sorted(parts) if pn > marker]
    page, rest = pns[:max_parts], pns[max_parts:]
    children = [
        ("Bucket", ""),
        ("Key", key),
        ("UploadId", mpu.upload_id.hex()),
        ("StorageClass", "STANDARD"),
        ("MaxParts", max_parts),
        ("PartNumberMarker", marker) if marker else None,
        ("IsTruncated", bool(rest)),
    ]
    if rest:
        children.append(("NextPartNumberMarker", page[-1]))
    for pn in page:
        p = parts[pn]
        children.append(
            (
                "Part",
                [
                    ("PartNumber", pn),
                    ("ETag", f'"{p["etag"]}"'),
                    ("Size", p["s"]),
                ],
            )
        )
    return web.Response(
        text=xml_doc("ListPartsResult", children), content_type="application/xml"
    )


async def handle_list_multipart_uploads(garage, bucket_id, bucket_name, request):
    """In-flight uploads = objects holding an uploading mpu version.
    One paginated pass over (key, upload_id) with prefix/delimiter folding
    (reference list.rs ListMultipartUploads state machine); the object
    table is scanned only as far as the page needs."""
    q = request.query
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter", "")
    max_uploads = max(1, min(int(q.get("max-uploads", "1000")), 1000))
    key_marker = q.get("key-marker", "")
    uid_marker = q.get("upload-id-marker", "")

    uploads: list[tuple[str, str]] = []
    prefixes: list[str] = []
    # the last entry emitted IN SORT ORDER — uploads and prefixes
    # interleave, so the continuation marker must track both kinds
    last_emitted: tuple[str, str | None] | None = None
    truncated = False

    def page_full() -> bool:
        return len(uploads) + len(prefixes) >= max_uploads

    cursor = max(key_marker, prefix).encode() if (key_marker or prefix) else None
    done = False
    while not done:
        objs = await garage.object_table.get_range(bucket_id, cursor, None, 1000)
        if not objs:
            break
        for o in objs:
            k = o.key
            if prefix and not k.startswith(prefix):
                if k > prefix:
                    done = True
                    break
                continue
            pairs = sorted(
                (k, v.uuid.hex())
                for v in o.versions
                if v.state == "uploading" and v.data.get("mpu")
            )
            for k, uid in pairs:
                # markers: exclusive on key alone, or on (key, upload_id)
                # when an upload-id-marker narrows within the key
                if uid_marker:
                    if k < key_marker or (k == key_marker and uid <= uid_marker):
                        continue
                elif key_marker and k <= key_marker:
                    continue
                if delimiter and delimiter in k[len(prefix):]:
                    cp = prefix + k[len(prefix):].split(delimiter)[0] + delimiter
                    # a CommonPrefix consumes its whole group
                    if cp <= key_marker or (prefixes and prefixes[-1] == cp):
                        continue
                    if page_full():
                        truncated, done = True, True
                        break
                    prefixes.append(cp)
                    last_emitted = (cp, None)
                    continue
                if page_full():
                    truncated, done = True, True
                    break
                uploads.append((k, uid))
                last_emitted = (k, uid)
            if done:
                break
        else:
            if len(objs) < 1000:
                break
            cursor = objs[-1].key.encode() + b"\x00"
            continue
        break

    children = [
        ("Bucket", bucket_name),
        ("Prefix", prefix),
        ("Delimiter", delimiter) if delimiter else None,
        ("KeyMarker", key_marker) if key_marker else None,
        ("UploadIdMarker", uid_marker) if uid_marker else None,
        ("MaxUploads", max_uploads),
        ("IsTruncated", truncated),
    ]
    if truncated and last_emitted is not None:
        children.append(("NextKeyMarker", last_emitted[0]))
        if last_emitted[1] is not None:
            children.append(("NextUploadIdMarker", last_emitted[1]))
    for k, uid in uploads:
        children.append(
            (
                "Upload",
                [
                    ("Key", k),
                    ("UploadId", uid),
                    ("StorageClass", "STANDARD"),
                ],
            )
        )
    for cp in prefixes:
        children.append(("CommonPrefixes", [("Prefix", cp)]))
    return web.Response(
        text=xml_doc("ListMultipartUploadsResult", children),
        content_type="application/xml",
    )