"""PostObject: browser-based form uploads (reference src/api/s3/
post_object.rs, 530 LoC).

A multipart/form-data POST to the bucket URL carrying a signed POLICY
document instead of a SigV4 Authorization header: the policy (base64
JSON) states expiration and conditions (bucket, key prefix/eq,
content-length-range, ...) and is signed with the same SigV4 key
derivation; the signature authenticates exactly that policy, so a web
page can let end users upload without holding credentials.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
from datetime import datetime, timezone

from aiohttp import web

from ..common.error import ApiError, BadRequest, Forbidden
from ..common.signature import signing_key
from .objects import handle_put_object

MAX_FIELD = 64 * 1024


async def handle_post_object(server, bucket_name: str, request) -> web.Response:
    reader = await request.multipart()
    fields: dict[str, str] = {}
    file_part = None
    while True:
        part = await reader.next()
        if part is None:
            break
        name = (part.name or "").lower()
        if name == "file":
            file_part = part
            break  # per the S3 spec, fields after `file` are ignored
        data = await part.read()
        if len(data) > MAX_FIELD:
            raise BadRequest(f"form field {name!r} too large")
        fields[name] = data.decode()
    if file_part is None:
        raise BadRequest("no file field in POST body")

    policy_b64 = fields.get("policy")
    if not policy_b64:
        raise Forbidden("POST without policy is not allowed")
    try:
        policy = json.loads(base64.b64decode(policy_b64))
    except Exception as e:
        raise BadRequest(f"malformed policy: {e}") from e

    # --- verify the policy signature -----------------------------------------
    try:
        cred = fields["x-amz-credential"].split("/")
        key_id, date, region, service = cred[0], cred[1], cred[2], cred[3]
        signature = fields["x-amz-signature"]
        algorithm = fields.get("x-amz-algorithm", "")
    except (KeyError, IndexError) as e:
        raise Forbidden(f"missing signature fields: {e}") from e
    if algorithm != "AWS4-HMAC-SHA256":
        raise BadRequest(f"unsupported x-amz-algorithm {algorithm!r}")
    secret = await server._get_secret(key_id)
    if secret is None:
        raise Forbidden(f"unknown access key {key_id}")
    key = signing_key(secret, date, region, service)
    expected = hmac.new(key, policy_b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expected, signature):
        raise Forbidden("policy signature does not match")

    # --- check policy conditions ----------------------------------------------
    try:
        exp_str = policy["expiration"].rstrip("Z").split(".")[0]
        exp = datetime.strptime(exp_str, "%Y-%m-%dT%H:%M:%S").replace(
            tzinfo=timezone.utc
        )
    except (KeyError, ValueError) as e:
        raise BadRequest(f"bad policy expiration: {e}") from e
    if datetime.now(timezone.utc) > exp:
        raise Forbidden("policy expired")

    object_key = fields.get("key", "")
    if "${filename}" in object_key:
        object_key = object_key.replace("${filename}", file_part.filename or "file")
    def field_value(name: str) -> str:
        if name == "bucket":
            return bucket_name
        if name == "key":
            return object_key
        return fields.get(name, "")

    length_range = None
    for cond in policy.get("conditions", []):
        if isinstance(cond, dict):
            for k, v in cond.items():
                if field_value(k.lower()) != v:
                    raise Forbidden(f"policy condition failed for {k}")
        elif isinstance(cond, list) and len(cond) == 3:
            op, name, val = cond[0], str(cond[1]).lstrip("$").lower(), cond[2]
            if op == "eq":
                if field_value(name) != val:
                    raise Forbidden(f"policy eq condition failed for {name}")
            elif op == "starts-with":
                if not field_value(name).startswith(val):
                    raise Forbidden(f"policy starts-with failed for {name}")
            elif op == "content-length-range":
                try:
                    length_range = (int(cond[1]), int(cond[2]))
                except (TypeError, ValueError) as e:
                    raise BadRequest(f"bad content-length-range: {e}") from e
    if not object_key:
        raise BadRequest("no key for POST upload")

    # --- authorization + store ------------------------------------------------
    api_key = await server.garage.helper.get_key(key_id)
    bucket_id = await server.garage.helper.resolve_bucket(bucket_name, api_key)
    if not api_key.bucket_permissions(bucket_id).allow_write:
        raise Forbidden("key has no write permission on this bucket")

    class _FormBody:
        """Adapts the file part to the .read(n) interface of the put path,
        enforcing content-length-range as bytes stream in."""

        def __init__(self, part, length_range):
            self.part = part
            self.range = length_range
            self.total = 0

        async def read(self, n: int) -> bytes:
            chunk = await self.part.read_chunk(n)
            self.total += len(chunk)
            if self.range and self.total > self.range[1]:
                raise ApiError(
                    "upload exceeds policy content-length-range",
                    code="EntityTooLarge",
                    status=400,
                )
            return chunk

    body = _FormBody(file_part, length_range)
    saved_headers = {}
    if "content-type" in fields:
        saved_headers["content-type"] = fields["content-type"]

    class _FakeRequest:
        content = body
        headers = saved_headers

    resp = await handle_put_object(server.garage, bucket_id, object_key, _FakeRequest())
    if length_range and body.total < length_range[0]:
        # the object was already stored: roll it back before failing
        from .objects import handle_delete_object

        await handle_delete_object(server.garage, bucket_id, object_key)
        raise ApiError(
            "upload below policy content-length-range",
            code="EntityTooSmall",
            status=400,
        )
    try:
        status = int(fields.get("success_action_status", "204"))
    except ValueError:
        status = 204
    if status not in (200, 201, 204):
        status = 204
    if status == 201:
        from .xml_util import xml_doc

        return web.Response(
            status=201,
            text=xml_doc(
                "PostResponse",
                [("Bucket", bucket_name), ("Key", object_key),
                 ("ETag", resp.headers.get("ETag", ""))],
            ),
            content_type="application/xml",
        )
    return web.Response(status=status, headers={"ETag": resp.headers.get("ETag", "")})
