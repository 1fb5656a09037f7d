"""Object listings: ListObjectsV2 / V1 (reference src/api/s3/list.rs —
the pagination state machines over CRDT version lists)."""

from __future__ import annotations

import base64

from aiohttp import web

from .xml_util import http_iso as _http_iso, xml_doc


async def _collect(
    garage,
    bucket_id: bytes,
    prefix: str,
    delimiter: str,
    start_after: str,
    max_keys: int,
):
    """Walk the object table; fold keys under `delimiter` into common
    prefixes.  Returns (entries, common_prefixes, truncated, next_start)
    where next_start is the LAST PROCESSED key — the continuation resumes
    strictly after it, so no key is dropped at page boundaries."""
    entries = []
    prefixes: set[str] = set()
    # seek straight to the interesting range; only start_after is an
    # EXCLUSIVE bound — a key exactly equal to the prefix must be listed
    cursor = max(start_after, prefix).encode() if prefix else start_after.encode()
    floor = start_after  # strictly-greater-than bound
    last = floor or cursor.decode(errors="surrogateescape")
    while True:
        batch = await garage.object_table.get_range(
            bucket_id, cursor, "visible", 1000
        )
        if not batch:
            break
        for obj in batch:
            k = obj.key
            if floor and k <= floor:
                continue
            if prefix:
                if not k.startswith(prefix):
                    if k > prefix:
                        return entries, sorted(prefixes), False, ""  # past range
                    continue
            if delimiter:
                rest = k[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    if cp not in prefixes:
                        if len(entries) + len(prefixes) + 1 > max_keys:
                            return entries, sorted(prefixes), True, last
                        prefixes.add(cp)
                    last = k
                    continue
            if len(entries) + len(prefixes) + 1 > max_keys:
                return entries, sorted(prefixes), True, last
            v = obj.last_visible()
            meta = v.data.get("meta", {})
            entries.append(
                {
                    "key": k,
                    "size": meta.get("size", 0),
                    "etag": meta.get("etag", ""),
                    "ts": v.timestamp,
                }
            )
            last = k
        cursor = batch[-1].key.encode()
        floor = batch[-1].key  # next batch starts strictly after
        if len(batch) < 1000:
            break
    return entries, sorted(prefixes), False, ""


def uriencode(s: str, encode_slash: bool = False) -> str:
    """S3 `encoding-type=url` key encoding: RFC 3986 unreserved characters
    kept verbatim, '/' kept unless encode_slash (reference
    src/api/common/encoding.rs uri_encode) — the SigV4 canonical encoding."""
    from ..common.signature import _uri_encode

    return _uri_encode(s, encode_slash=encode_slash)


# Owner/Initiator are access-control concepts Garage doesn't model per
# object; fixed placeholder identity (reference list.rs:25-26 does the same)
OWNER_XML = ("Owner", [("ID", "garage-tpu-owner"), ("DisplayName", "garage-tpu")])


def _maybe_enc(s: str, urlencode: bool) -> str:
    return uriencode(s) if urlencode else s


def _contents_xml(e: dict, urlencode: bool, with_owner: bool):
    fields = [
        ("Key", _maybe_enc(e["key"], urlencode)),
        ("LastModified", _http_iso(e["ts"])),
        ("ETag", f'"{e["etag"]}"'),
        ("Size", e["size"]),
        ("StorageClass", "STANDARD"),
    ]
    if with_owner:
        fields.append(OWNER_XML)
    return ("Contents", fields)


async def handle_list_objects_v2(garage, bucket_id: bytes, bucket_name: str, request):
    q = request.query
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter", "")
    max_keys = min(int(q.get("max-keys", "1000")), 1000)
    urlencode = q.get("encoding-type") == "url"
    fetch_owner = q.get("fetch-owner") == "true"
    token = q.get("continuation-token")
    start_after = q.get("start-after", "")
    if token:
        start_after = base64.urlsafe_b64decode(token.encode()).decode()

    entries, prefixes, truncated, next_start = await _collect(
        garage, bucket_id, prefix, delimiter, start_after, max_keys
    )
    children = [
        ("Name", bucket_name),
        ("Prefix", _maybe_enc(prefix, urlencode)),
        ("KeyCount", len(entries) + len(prefixes)),
        ("MaxKeys", max_keys),
        ("Delimiter", _maybe_enc(delimiter, urlencode)) if delimiter else None,
        ("EncodingType", "url") if urlencode else None,
        (
            "StartAfter", _maybe_enc(q.get("start-after", ""), urlencode)
        ) if q.get("start-after") else None,
        ("IsTruncated", truncated),
    ]
    if truncated:
        children.append(
            (
                "NextContinuationToken",
                base64.urlsafe_b64encode(next_start.encode()).decode(),
            )
        )
    for e in entries:
        children.append(_contents_xml(e, urlencode, fetch_owner))
    for p in prefixes:
        children.append(("CommonPrefixes", [("Prefix", _maybe_enc(p, urlencode))]))
    return web.Response(
        text=xml_doc("ListBucketResult", children),
        content_type="application/xml",
    )


async def handle_list_objects_v1(garage, bucket_id: bytes, bucket_name: str, request):
    q = request.query
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter", "")
    max_keys = min(int(q.get("max-keys", "1000")), 1000)
    urlencode = q.get("encoding-type") == "url"
    marker = q.get("marker", "")
    entries, prefixes, truncated, next_start = await _collect(
        garage, bucket_id, prefix, delimiter, marker, max_keys
    )
    children = [
        ("Name", bucket_name),
        ("Prefix", _maybe_enc(prefix, urlencode)),
        ("Marker", _maybe_enc(marker, urlencode)),
        ("MaxKeys", max_keys),
        ("Delimiter", _maybe_enc(delimiter, urlencode)) if delimiter else None,
        ("EncodingType", "url") if urlencode else None,
        ("IsTruncated", truncated),
    ]
    if truncated and next_start:
        children.append(("NextMarker", _maybe_enc(next_start, urlencode)))
    for e in entries:
        # V1 always reports the owner
        children.append(_contents_xml(e, urlencode, with_owner=True))
    for p in prefixes:
        children.append(("CommonPrefixes", [("Prefix", _maybe_enc(p, urlencode))]))
    return web.Response(
        text=xml_doc("ListBucketResult", children),
        content_type="application/xml",
    )
