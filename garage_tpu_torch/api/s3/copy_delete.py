"""CopyObject + DeleteObjects batch (reference src/api/s3/copy.rs,
delete.rs).

CopyObject is metadata-only for block objects: the new version references
the same content-addressed blocks (fresh block refs, no data movement) —
dedup makes server-side copy O(metadata).
"""

from __future__ import annotations

import urllib.parse
import xml.etree.ElementTree as ET

from aiohttp import web

from ...model.s3.block_ref_table import BlockRef
from ...model.s3.object_table import Object, ObjectVersion
from ...model.s3.version_table import Version
from ...utils.data import gen_uuid
from ..common.error import BadRequest, NoSuchKey
from .objects import handle_delete_object
from .xml_util import http_iso as _http_iso, xml_doc


async def resolve_copy_source(garage, helper, api_key, request):
    """Resolve x-amz-copy-source to its newest visible version, enforcing
    read permission and the x-amz-copy-source-if-* preconditions
    (reference copy.rs source resolution, shared with UploadPartCopy)."""
    from .objects import Preconditions

    src = urllib.parse.unquote(request.headers["x-amz-copy-source"])
    src = src.lstrip("/")
    if "/" not in src:
        raise BadRequest("x-amz-copy-source must be bucket/key")
    src_bucket_name, src_key = src.split("/", 1)
    src_bucket_id = await helper.resolve_bucket(src_bucket_name, api_key)
    perm = api_key.bucket_permissions(src_bucket_id)
    if not perm.allow_read:
        from ..common.error import Forbidden

        raise Forbidden("no read permission on copy source")

    obj = await garage.object_table.get(src_bucket_id, src_key.encode())
    sv = obj.last_visible() if obj else None
    if sv is None:
        raise NoSuchKey("copy source not found")
    Preconditions.parse_copy_source(request).check_copy_source(sv)
    return sv


async def handle_copy_object(garage, helper, api_key, dest_bucket_id, dest_key, request):
    from .objects import next_timestamp

    sv = await resolve_copy_source(garage, helper, api_key, request)
    meta = dict(sv.data.get("meta", {}))
    # x-amz-metadata-directive: REPLACE takes the new metadata from this
    # request instead of copying the source's (reference copy.rs:84-89);
    # etag/size stay with the (unchanged) content.  Unknown directive
    # values are rejected, not silently treated as COPY.
    directive = request.headers.get("x-amz-metadata-directive", "COPY").upper()
    if directive not in ("COPY", "REPLACE"):
        raise BadRequest(
            f"invalid x-amz-metadata-directive {directive!r}",
            code="InvalidArgument",
        )
    if directive == "REPLACE":
        from .objects import extract_meta_headers

        meta["headers"] = extract_meta_headers(request)
    dest_existing = await garage.object_table.get(dest_bucket_id, dest_key.encode())
    ts = next_timestamp(dest_existing)
    new_uuid = gen_uuid()

    if sv.data.get("t") == "inline":
        nv = ObjectVersion(
            new_uuid, ts, "complete",
            {"t": "inline", "bytes": sv.data["bytes"], "meta": meta},
        )
        await garage.object_table.insert(Object(dest_bucket_id, dest_key, [nv]))
    else:
        src_ver = await garage.version_table.get(bytes(sv.data["vid"]), b"")
        if src_ver is None or src_ver.deleted.get():
            raise NoSuchKey("copy source data missing")
        dst_ver = Version(new_uuid, dest_bucket_id, dest_key)
        for (pn, off), blk in src_ver.sorted_blocks():
            dst_ver.blocks.put([pn, off], {"h": blk["h"], "s": blk["s"]})
        await garage.version_table.insert(dst_ver)
        for _k, blk in dst_ver.sorted_blocks():
            await garage.block_ref_table.insert(BlockRef(blk["h"], new_uuid))
        nv = ObjectVersion(
            new_uuid, ts, "complete",
            {"t": "first_block", "vid": new_uuid, "meta": meta},
        )
        await garage.object_table.insert(Object(dest_bucket_id, dest_key, [nv]))

    return web.Response(
        text=xml_doc(
            "CopyObjectResult",
            [("LastModified", _http_iso(ts)), ("ETag", f'"{meta.get("etag", "")}"')],
        ),
        content_type="application/xml",
    )


async def handle_delete_objects(garage, bucket_id, request, ctx=None):
    body = await request.read()
    from ..common.signature import check_payload

    if ctx:
        await check_payload(body, ctx)
    try:
        root = ET.fromstring(body.decode())
    except ET.ParseError as e:
        raise BadRequest(f"malformed Delete XML: {e}") from e
    quiet = any(
        c.tag.endswith("Quiet") and (c.text or "").strip() == "true" for c in root
    )
    keys = []
    for obj in root.iter():
        if obj.tag.endswith("Object"):
            for c in obj:
                if c.tag.endswith("Key"):
                    keys.append(c.text)
    children = []
    for k in keys:
        try:
            await handle_delete_object(garage, bucket_id, k)
            if not quiet:
                children.append(("Deleted", [("Key", k)]))
        except Exception as e:  # noqa: BLE001
            children.append(
                (
                    "Error",
                    [("Key", k), ("Code", "InternalError"), ("Message", repr(e))],
                )
            )
    return web.Response(
        text=xml_doc("DeleteResult", children), content_type="application/xml"
    )