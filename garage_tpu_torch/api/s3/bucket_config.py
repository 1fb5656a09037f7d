"""Bucket configuration subresources: website, CORS, lifecycle
(reference src/api/s3/{website,cors,lifecycle}.rs).

Configs are stored as LWW registers in the bucket params and consumed by
the web server (website/CORS) and the lifecycle worker.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from aiohttp import web

from ..common.error import ApiError, BadRequest
from .xml_util import xml_doc


def _tag(e):  # strip xmlns
    return e.tag.rsplit("}", 1)[-1]


async def _read_checked(request, ctx) -> bytes:
    body = await request.read()
    if ctx is not None:
        from ..common.signature import check_payload

        await check_payload(body, ctx)
    return body


def _parse(body: bytes):
    try:
        return ET.fromstring(body.decode())
    except ET.ParseError as e:
        raise BadRequest(f"malformed XML: {e}") from e


# --- website ------------------------------------------------------------------

async def handle_put_website(garage, bucket, request, ctx=None):
    root = _parse(await _read_checked(request, ctx))
    index = error = None
    for e in root.iter():
        if _tag(e) == "IndexDocument":
            for c in e:
                if _tag(c) == "Suffix":
                    index = c.text
        if _tag(e) == "ErrorDocument":
            for c in e:
                if _tag(c) == "Key":
                    error = c.text
    if not index:
        raise BadRequest("IndexDocument.Suffix is required")
    bucket.params().website.update({"index_document": index, "error_document": error})
    await garage.bucket_table.insert(bucket)
    return web.Response(status=200)


async def handle_get_website(garage, bucket, request):
    w = bucket.params().website.get()
    if not w:
        raise ApiError(
            "no website configuration", code="NoSuchWebsiteConfiguration", status=404
        )
    children = [("IndexDocument", [("Suffix", w["index_document"])])]
    if w.get("error_document"):
        children.append(("ErrorDocument", [("Key", w["error_document"])]))
    return web.Response(
        text=xml_doc("WebsiteConfiguration", children), content_type="application/xml"
    )


async def handle_delete_website(garage, bucket, request):
    bucket.params().website.update(None)
    await garage.bucket_table.insert(bucket)
    return web.Response(status=204)


# --- CORS ---------------------------------------------------------------------

async def handle_put_cors(garage, bucket, request, ctx=None):
    root = _parse(await _read_checked(request, ctx))
    rules = []
    for e in root:
        if _tag(e) != "CORSRule":
            continue
        rule = {"origins": [], "methods": [], "headers": [], "expose": [], "max_age": None}
        for c in e:
            t = _tag(c)
            if t == "AllowedOrigin":
                rule["origins"].append(c.text)
            elif t == "AllowedMethod":
                rule["methods"].append(c.text)
            elif t == "AllowedHeader":
                rule["headers"].append(c.text)
            elif t == "ExposeHeader":
                rule["expose"].append(c.text)
            elif t == "MaxAgeSeconds":
                rule["max_age"] = int(c.text)
        rules.append(rule)
    bucket.params().cors.update(rules)
    await garage.bucket_table.insert(bucket)
    return web.Response(status=200)


async def handle_get_cors(garage, bucket, request):
    rules = bucket.params().cors.get()
    if not rules:
        raise ApiError("no CORS configuration", code="NoSuchCORSConfiguration", status=404)
    children = []
    for r in rules:
        rc = (
            [("AllowedOrigin", o) for o in r["origins"]]
            + [("AllowedMethod", m) for m in r["methods"]]
            + [("AllowedHeader", h) for h in r["headers"]]
            + [("ExposeHeader", h) for h in r["expose"]]
        )
        if r.get("max_age") is not None:
            rc.append(("MaxAgeSeconds", r["max_age"]))
        children.append(("CORSRule", rc))
    return web.Response(
        text=xml_doc("CORSConfiguration", children), content_type="application/xml"
    )


async def handle_delete_cors(garage, bucket, request):
    bucket.params().cors.update(None)
    await garage.bucket_table.insert(bucket)
    return web.Response(status=204)


def find_matching_cors_rule(params, origin: str, method: str) -> dict | None:
    rules = params.cors.get() or []
    for r in rules:
        if method not in r["methods"] and "*" not in r["methods"]:
            continue
        for o in r["origins"]:
            if o == "*" or o == origin:
                return r
            if "*" in o:
                pre, _, suf = o.partition("*")
                if origin.startswith(pre) and origin.endswith(suf):
                    return r
    return None


def add_cors_headers(resp, rule: dict, origin: str) -> None:
    resp.headers["Access-Control-Allow-Origin"] = (
        "*" if "*" in rule["origins"] else origin
    )
    resp.headers["Access-Control-Allow-Methods"] = ", ".join(rule["methods"])
    if rule["headers"]:
        resp.headers["Access-Control-Allow-Headers"] = ", ".join(rule["headers"])
    if rule["expose"]:
        resp.headers["Access-Control-Expose-Headers"] = ", ".join(rule["expose"])
    if rule.get("max_age") is not None:
        resp.headers["Access-Control-Max-Age"] = str(rule["max_age"])


# --- lifecycle ----------------------------------------------------------------

async def handle_put_lifecycle(garage, bucket, request, ctx=None):
    root = _parse(await _read_checked(request, ctx))
    rules = []
    for e in root:
        if _tag(e) != "Rule":
            continue
        rule = {
            "id": None, "enabled": True, "prefix": "",
            "expiration_days": None, "expiration_date": None,
            "abort_mpu_days": None,
        }
        for c in e:
            t = _tag(c)
            if t == "ID":
                rule["id"] = c.text
            elif t == "Status":
                rule["enabled"] = c.text == "Enabled"
            elif t == "Prefix":
                rule["prefix"] = c.text or ""
            elif t == "Filter":
                for f in c.iter():
                    if _tag(f) == "Prefix":
                        rule["prefix"] = f.text or ""
            elif t == "Expiration":
                for f in c:
                    if _tag(f) == "Days":
                        rule["expiration_days"] = int(f.text)
                    elif _tag(f) == "Date":
                        rule["expiration_date"] = f.text
            elif t == "AbortIncompleteMultipartUpload":
                for f in c:
                    if _tag(f) == "DaysAfterInitiation":
                        rule["abort_mpu_days"] = int(f.text)
        if rule["expiration_days"] is not None and rule["expiration_days"] <= 0:
            raise BadRequest("Expiration.Days must be positive")
        rules.append(rule)
    bucket.params().lifecycle.update(rules)
    await garage.bucket_table.insert(bucket)
    return web.Response(status=200)


async def handle_get_lifecycle(garage, bucket, request):
    rules = bucket.params().lifecycle.get()
    if not rules:
        raise ApiError(
            "no lifecycle configuration",
            code="NoSuchLifecycleConfiguration",
            status=404,
        )
    children = []
    for r in rules:
        rc = [
            ("ID", r["id"] or ""),
            ("Status", "Enabled" if r["enabled"] else "Disabled"),
            ("Filter", [("Prefix", r["prefix"])]),
        ]
        if r["expiration_days"] is not None:
            rc.append(("Expiration", [("Days", r["expiration_days"])]))
        if r["expiration_date"]:
            rc.append(("Expiration", [("Date", r["expiration_date"])]))
        if r["abort_mpu_days"] is not None:
            rc.append(
                (
                    "AbortIncompleteMultipartUpload",
                    [("DaysAfterInitiation", r["abort_mpu_days"])],
                )
            )
        children.append(("Rule", rc))
    return web.Response(
        text=xml_doc("LifecycleConfiguration", children),
        content_type="application/xml",
    )


async def handle_delete_lifecycle(garage, bucket, request):
    bucket.params().lifecycle.update(None)
    await garage.bucket_table.insert(bucket)
    return web.Response(status=204)