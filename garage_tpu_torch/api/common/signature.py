"""AWS Signature Version 4 verification + signing.

Reference src/api/common/signature/payload.rs (canonical request, scope,
key derivation) — implemented from the SigV4 spec, both header-based
`Authorization` and presigned query (`X-Amz-Signature`) forms.  Payload
policy: `x-amz-content-sha256` of UNSIGNED-PAYLOAD, the hex sha256 of the
body (checked), or the aws-chunked streaming forms (see streaming.py).

The same functions sign outgoing requests for the in-repo client
(no boto3 in this environment) and the integration tests.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from datetime import datetime, timezone

from .error import AuthError, BadRequest, Forbidden

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED = "UNSIGNED-PAYLOAD"


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query_items: list[tuple[str, str]], skip: set[str] = frozenset()) -> str:
    items = sorted(
        (_uri_encode(k), _uri_encode(v)) for k, v in query_items if k not in skip
    )
    return "&".join(f"{k}={v}" for k, v in items)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str = "s3") -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_request(
    method: str,
    path: str,
    query_items: list[tuple[str, str]],
    headers: dict[str, str],
    signed_headers: list[str],
    payload_hash: str,
    skip_query: set[str] = frozenset(),
) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers
    )
    return "\n".join(
        [
            method.upper(),
            _uri_encode(path, encode_slash=False),
            canonical_query(query_items, skip_query),
            canon_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )


def string_to_sign(timestamp: str, scope: str, canon_req: str) -> str:
    return "\n".join(
        [ALGORITHM, timestamp, scope, hashlib.sha256(canon_req.encode()).hexdigest()]
    )


def compute_signature(
    secret: str,
    method: str,
    path: str,
    query_items: list[tuple[str, str]],
    headers: dict[str, str],
    signed_headers: list[str],
    payload_hash: str,
    timestamp: str,
    date: str,
    region: str,
    service: str = "s3",
    skip_query: set[str] = frozenset(),
) -> str:
    scope = f"{date}/{region}/{service}/aws4_request"
    creq = canonical_request(
        method, path, query_items, headers, signed_headers, payload_hash, skip_query
    )
    sts = string_to_sign(timestamp, scope, creq)
    key = signing_key(secret, date, region, service)
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()


class AuthContext:
    """Parsed+verified request authentication."""

    def __init__(self, key_id: str, payload_hash: str | None, streaming=None):
        self.key_id = key_id
        self.content_sha256 = payload_hash  # None = unsigned
        # "signed" | "unsigned-trailer" framing context (StreamingContext
        # or the string "unsigned"); None = plain body
        self.streaming = streaming


def parse_authorization(auth: str) -> tuple[str, str, str, str, list[str], str]:
    """-> (key_id, date, region, service, signed_headers, signature)"""
    if not auth.startswith(ALGORITHM):
        raise AuthError("unsupported authorization algorithm")
    parts = {}
    for item in auth[len(ALGORITHM):].strip().split(","):
        k, _, v = item.strip().partition("=")
        parts[k] = v
    try:
        cred = parts["Credential"].split("/")
        key_id, date, region, service = cred[0], cred[1], cred[2], cred[3]
        signed_headers = parts["SignedHeaders"].split(";")
        signature = parts["Signature"]
    except (KeyError, IndexError) as e:
        raise AuthError(f"malformed Authorization header: {e}") from e
    return key_id, date, region, service, signed_headers, signature


async def verify_request(request, get_secret, region: str) -> AuthContext:
    """Verify an aiohttp request.  `get_secret(key_id) -> secret | None`
    (async).  Returns the auth context; raises AuthError/Forbidden."""
    headers = {k.lower(): v for k, v in request.headers.items()}
    query_items = [(k, v) for k, v in request.query.items()]
    path = request.path

    if "x-amz-signature" in {k.lower() for k, _ in query_items}:
        return await _verify_presigned(
            request, headers, query_items, path, get_secret, region
        )

    auth = headers.get("authorization")
    if not auth:
        raise Forbidden("missing Authorization header")
    key_id, date, req_region, service, signed_headers, signature = (
        parse_authorization(auth)
    )
    if req_region != region:
        raise AuthError(f"wrong region {req_region!r}, expected {region!r}")
    timestamp = headers.get("x-amz-date") or headers.get("date", "")
    if not timestamp:
        raise AuthError("missing x-amz-date")
    # clock-skew window + scope-date consistency (replay resistance)
    try:
        t0 = datetime.strptime(timestamp, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=timezone.utc
        )
    except ValueError as e:
        raise AuthError(f"bad x-amz-date: {e}") from e
    if abs((datetime.now(timezone.utc) - t0).total_seconds()) > 15 * 60:
        raise AuthError("request timestamp outside the allowed window")
    if timestamp[:8] != date:
        raise AuthError("x-amz-date does not match credential scope date")
    payload_hash = headers.get("x-amz-content-sha256", UNSIGNED)
    secret = await get_secret(key_id)
    if secret is None:
        raise Forbidden(f"unknown access key {key_id}")
    expected = compute_signature(
        secret, request.method, path, query_items, headers, signed_headers,
        payload_hash, timestamp, date, req_region, service,
    )
    if not hmac.compare_digest(expected, signature):
        raise AuthError("request signature does not match")
    from .streaming import (
        STREAMING_SIGNED,
        STREAMING_UNSIGNED_TRAILER,
        StreamingContext,
    )

    if payload_hash == STREAMING_SIGNED:
        scope = f"{date}/{req_region}/{service}/aws4_request"
        sctx = StreamingContext(
            signing_key(secret, date, req_region, service),
            timestamp, scope, expected,
        )
        return AuthContext(key_id, None, streaming=sctx)
    if payload_hash == STREAMING_UNSIGNED_TRAILER:
        return AuthContext(key_id, None, streaming="unsigned")
    return AuthContext(key_id, None if payload_hash == UNSIGNED else payload_hash)


async def _verify_presigned(request, headers, query_items, path, get_secret, region):
    q = {k.lower(): v for k, v in query_items}
    try:
        cred = q["x-amz-credential"].split("/")
        key_id, date, req_region, service = cred[0], cred[1], cred[2], cred[3]
        timestamp = q["x-amz-date"]
        signature = q["x-amz-signature"]
        signed_headers = q["x-amz-signedheaders"].split(";")
        expires = int(q.get("x-amz-expires", "86400"))
    except (KeyError, IndexError) as e:
        raise AuthError(f"malformed presigned query: {e}") from e
    if req_region != region:
        raise AuthError(f"wrong region {req_region!r}")
    # mirror the header path's checks: expires bounds (AWS max 7 days),
    # scope-date consistency, and no far-future timestamps
    if not 1 <= expires <= 604800:
        raise AuthError("X-Amz-Expires must be between 1 and 604800 seconds")
    if timestamp[:8] != date:
        raise AuthError("X-Amz-Date does not match credential scope date")
    try:
        t0 = datetime.strptime(timestamp, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=timezone.utc
        )
        age = (datetime.now(timezone.utc) - t0).total_seconds()
        if age > expires:
            raise AuthError("presigned URL expired")
        if age < -15 * 60:
            raise AuthError("X-Amz-Date is in the future")
    except ValueError as e:
        raise AuthError(f"bad X-Amz-Date: {e}") from e
    secret = await get_secret(key_id)
    if secret is None:
        raise Forbidden(f"unknown access key {key_id}")
    expected = compute_signature(
        secret, request.method, path,
        [(k, v) for k, v in query_items if k.lower() != "x-amz-signature"],
        headers, signed_headers, UNSIGNED, timestamp, date, req_region, service,
    )
    if not hmac.compare_digest(expected, signature):
        raise AuthError("presigned signature does not match")
    return AuthContext(key_id, None)


async def check_payload(body: bytes, ctx: AuthContext) -> None:
    if ctx.content_sha256 is not None:
        if hashlib.sha256(body).hexdigest() != ctx.content_sha256:
            raise BadRequest(
                "payload sha256 does not match x-amz-content-sha256",
                code="XAmzContentSHA256Mismatch",
            )


# --- client-side signing (in-repo client + tests) ----------------------------


def sign_request_headers(
    method: str,
    url_path: str,
    query_items: list[tuple[str, str]],
    headers: dict[str, str],
    body: bytes,
    key_id: str,
    secret: str,
    region: str,
    service: str = "s3",
) -> dict[str, str]:
    """Returns headers with Authorization added (lowercased names kept)."""
    now = datetime.now(timezone.utc)
    timestamp = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")
    h = {k.lower(): v for k, v in headers.items()}
    h["x-amz-date"] = timestamp
    payload_hash = h.get("x-amz-content-sha256") or hashlib.sha256(body).hexdigest()
    h["x-amz-content-sha256"] = payload_hash
    signed_headers = sorted(set(list(h.keys()) + ["host"]))
    sig = compute_signature(
        secret, method, url_path, query_items, h, signed_headers,
        payload_hash, timestamp, date, region, service,
    )
    scope = f"{date}/{region}/{service}/aws4_request"
    h["authorization"] = (
        f"{ALGORITHM} Credential={key_id}/{scope}, "
        f"SignedHeaders={';'.join(signed_headers)}, Signature={sig}"
    )
    return h
