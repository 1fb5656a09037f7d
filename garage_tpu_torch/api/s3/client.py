"""Minimal async S3 client with SigV4 signing.

Replaces the aws-sdk client the reference uses in its integration tests
(src/garage/tests/ uses aws-sdk-s3 + a custom requester; this image has
no boto3).  Also used by the CLI and the smoke scripts.
"""

from __future__ import annotations

import urllib.parse
import xml.etree.ElementTree as ET

import aiohttp

from ..common.signature import sign_request_headers


class S3Error(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(f"{status} {code}: {message}")
        self.status = status
        self.code = code


class S3Client:
    def __init__(self, endpoint: str, key_id: str, secret: str, region: str = "garage"):
        self.endpoint = endpoint.rstrip("/")
        self.key_id = key_id
        self.secret = secret
        self.region = region
        host = urllib.parse.urlparse(self.endpoint).netloc
        self.host = host
        self._session: aiohttp.ClientSession | None = None

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    async def _req(
        self,
        method: str,
        path: str,
        query: list[tuple[str, str]] | None = None,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
    ) -> tuple[int, dict, bytes]:
        query = query or []
        h = dict(headers or {})
        h["host"] = self.host
        signed = sign_request_headers(
            method, path, query, h, body, self.key_id, self.secret, self.region
        )
        qs = urllib.parse.urlencode(query)
        url = self.endpoint + urllib.parse.quote(path) + ("?" + qs if qs else "")
        async with self._sess().request(
            method, url, data=body, headers=signed, skip_auto_headers=["Content-Type"]
        ) as resp:
            data = await resp.read()
            return resp.status, resp.headers.copy(), data  # case-insensitive

    def _check(self, status: int, data: bytes, ok=(200, 204, 206)):
        if status not in ok:
            code, msg = "Unknown", data.decode(errors="replace")[:200]
            try:
                root = ET.fromstring(data.decode())
                code = root.findtext("Code") or code
                msg = root.findtext("Message") or msg
            except ET.ParseError:
                pass
            raise S3Error(status, code, msg)

    # --- operations -----------------------------------------------------------

    async def create_bucket(self, bucket: str) -> None:
        st, _h, data = await self._req("PUT", f"/{bucket}")
        self._check(st, data)

    async def delete_bucket(self, bucket: str) -> None:
        st, _h, data = await self._req("DELETE", f"/{bucket}")
        self._check(st, data)

    async def list_buckets(self) -> list[str]:
        st, _h, data = await self._req("GET", "/")
        self._check(st, data)
        ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
        root = ET.fromstring(data.decode())
        return [e.text for e in root.findall(".//s3:Bucket/s3:Name", ns)]

    async def put_object(
        self, bucket: str, key: str, body: bytes,
        content_type: str | None = None,
        metadata: dict[str, str] | None = None,
    ) -> str:
        """`metadata` entries become x-amz-meta-* user metadata."""
        headers = {"content-type": content_type} if content_type else {}
        for k, v in (metadata or {}).items():
            headers[f"x-amz-meta-{k}"] = v
        st, h, data = await self._req("PUT", f"/{bucket}/{key}", body=body, headers=headers)
        self._check(st, data)
        return h.get("ETag", "").strip('"')

    async def get_object(
        self,
        bucket: str,
        key: str,
        range_: str | None = None,
        part_number: int | None = None,
        headers: dict[str, str] | None = None,
    ) -> bytes:
        h = dict(headers or {})
        if range_:
            h["range"] = range_
        q = [("partNumber", str(part_number))] if part_number is not None else []
        st, _h, data = await self._req("GET", f"/{bucket}/{key}", query=q, headers=h)
        self._check(st, data)
        return data

    async def get_object_full(
        self,
        bucket: str,
        key: str,
        part_number: int | None = None,
        headers: dict[str, str] | None = None,
    ) -> tuple[int, dict, bytes]:
        """Raw (status, headers, body) — for conditional/part-read tests."""
        q = [("partNumber", str(part_number))] if part_number is not None else []
        return await self._req("GET", f"/{bucket}/{key}", query=q, headers=headers)

    async def head_object(
        self, bucket: str, key: str, part_number: int | None = None
    ) -> dict:
        q = [("partNumber", str(part_number))] if part_number is not None else []
        st, h, data = await self._req("HEAD", f"/{bucket}/{key}", query=q)
        self._check(st, data)
        return h

    async def upload_part_copy(
        self,
        bucket: str,
        key: str,
        upload_id: str,
        part_number: int,
        src_bucket: str,
        src_key: str,
        src_range: str | None = None,
        headers: dict[str, str] | None = None,
    ) -> str:
        h = dict(headers or {})
        h["x-amz-copy-source"] = f"/{src_bucket}/{src_key}"
        if src_range:
            h["x-amz-copy-source-range"] = src_range
        st, _h, data = await self._req(
            "PUT",
            f"/{bucket}/{key}",
            query=[("partNumber", str(part_number)), ("uploadId", upload_id)],
            headers=h,
        )
        self._check(st, data)
        ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
        root = ET.fromstring(data.decode())
        return (root.findtext("s3:ETag", namespaces=ns) or "").strip('"')

    async def delete_object(self, bucket: str, key: str) -> None:
        st, _h, data = await self._req("DELETE", f"/{bucket}/{key}")
        self._check(st, data)

    async def list_objects_v2(
        self,
        bucket: str,
        prefix: str = "",
        delimiter: str = "",
        max_keys: int = 1000,
        continuation_token: str | None = None,
    ) -> dict:
        q = [("list-type", "2"), ("max-keys", str(max_keys))]
        if prefix:
            q.append(("prefix", prefix))
        if delimiter:
            q.append(("delimiter", delimiter))
        if continuation_token:
            q.append(("continuation-token", continuation_token))
        st, _h, data = await self._req("GET", f"/{bucket}", query=q)
        self._check(st, data)
        ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
        root = ET.fromstring(data.decode())
        return {
            "keys": [
                {
                    "key": c.findtext("s3:Key", namespaces=ns),
                    "size": int(c.findtext("s3:Size", namespaces=ns) or 0),
                    "etag": (c.findtext("s3:ETag", namespaces=ns) or "").strip('"'),
                }
                for c in root.findall("s3:Contents", ns)
            ],
            "common_prefixes": [
                p.findtext("s3:Prefix", namespaces=ns)
                for p in root.findall("s3:CommonPrefixes", ns)
            ],
            "truncated": root.findtext("s3:IsTruncated", namespaces=ns) == "true",
            "next_token": root.findtext("s3:NextContinuationToken", namespaces=ns),
        }

    async def put_object_streaming(
        self, bucket: str, key: str, body: bytes, chunk_size: int = 65536
    ) -> str:
        """PUT with aws-chunked signed streaming (per-chunk signatures)."""
        from datetime import datetime, timezone

        from ..common.signature import compute_signature, signing_key
        from ..common.streaming import (
            STREAMING_SIGNED,
            StreamingContext,
            encode_chunked,
        )

        now = datetime.now(timezone.utc)
        timestamp = now.strftime("%Y%m%dT%H%M%SZ")
        date = now.strftime("%Y%m%d")
        path = f"/{bucket}/{key}"
        h = {
            "host": self.host,
            "x-amz-date": timestamp,
            "x-amz-content-sha256": STREAMING_SIGNED,
            "content-encoding": "aws-chunked",
            "x-amz-decoded-content-length": str(len(body)),
        }
        signed_headers = sorted(h.keys())
        seed = compute_signature(
            self.secret, "PUT", path, [], h, signed_headers,
            STREAMING_SIGNED, timestamp, date, self.region,
        )
        scope = f"{date}/{self.region}/s3/aws4_request"
        sctx = StreamingContext(
            signing_key(self.secret, date, self.region), timestamp, scope, seed
        )
        h["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.key_id}/{scope}, "
            f"SignedHeaders={';'.join(signed_headers)}, Signature={seed}"
        )
        wire = encode_chunked(body, sctx, chunk_size)
        url = self.endpoint + urllib.parse.quote(path)
        async with self._sess().put(
            url, data=wire, headers=h, skip_auto_headers=["Content-Type"]
        ) as resp:
            data = await resp.read()
            self._check(resp.status, data)
            return resp.headers.get("ETag", "").strip('"')

    # --- multipart ------------------------------------------------------------

    async def create_multipart_upload(
        self, bucket: str, key: str, metadata: dict[str, str] | None = None
    ) -> str:
        headers = {f"x-amz-meta-{k}": v for k, v in (metadata or {}).items()}
        st, _h, data = await self._req(
            "POST", f"/{bucket}/{key}", query=[("uploads", "")], headers=headers
        )
        self._check(st, data)
        root = ET.fromstring(data.decode())
        ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
        return root.findtext("s3:UploadId", namespaces=ns)

    async def upload_part(
        self, bucket: str, key: str, upload_id: str, part_number: int, body: bytes
    ) -> str:
        st, h, data = await self._req(
            "PUT",
            f"/{bucket}/{key}",
            query=[("partNumber", str(part_number)), ("uploadId", upload_id)],
            body=body,
        )
        self._check(st, data)
        return h.get("ETag", "").strip('"')

    async def complete_multipart_upload(
        self, bucket: str, key: str, upload_id: str, parts: list[tuple[int, str]]
    ) -> str:
        body = (
            '<CompleteMultipartUpload>'
            + "".join(
                f"<Part><PartNumber>{pn}</PartNumber><ETag>\"{etag}\"</ETag></Part>"
                for pn, etag in parts
            )
            + "</CompleteMultipartUpload>"
        ).encode()
        st, _h, data = await self._req(
            "POST", f"/{bucket}/{key}", query=[("uploadId", upload_id)], body=body
        )
        self._check(st, data)
        root = ET.fromstring(data.decode())
        ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
        return (root.findtext("s3:ETag", namespaces=ns) or "").strip('"')

    async def abort_multipart_upload(self, bucket: str, key: str, upload_id: str):
        st, _h, data = await self._req(
            "DELETE", f"/{bucket}/{key}", query=[("uploadId", upload_id)]
        )
        self._check(st, data)

    async def list_parts(self, bucket: str, key: str, upload_id: str) -> list[dict]:
        st, _h, data = await self._req(
            "GET", f"/{bucket}/{key}", query=[("uploadId", upload_id)]
        )
        self._check(st, data)
        ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
        root = ET.fromstring(data.decode())
        return [
            {
                "part": int(p.findtext("s3:PartNumber", namespaces=ns)),
                "etag": (p.findtext("s3:ETag", namespaces=ns) or "").strip('"'),
                "size": int(p.findtext("s3:Size", namespaces=ns) or 0),
            }
            for p in root.findall("s3:Part", ns)
        ]

    async def copy_object(
        self, src_bucket: str, src_key: str, dst_bucket: str, dst_key: str,
        headers: dict[str, str] | None = None,
    ):
        st, _h, data = await self._req(
            "PUT",
            f"/{dst_bucket}/{dst_key}",
            headers={
                "x-amz-copy-source": f"/{src_bucket}/{src_key}",
                **(headers or {}),
            },
        )
        self._check(st, data)

    async def delete_objects(self, bucket: str, keys: list[str]) -> None:
        body = (
            "<Delete>"
            + "".join(f"<Object><Key>{k}</Key></Object>" for k in keys)
            + "</Delete>"
        ).encode()
        st, _h, data = await self._req(
            "POST", f"/{bucket}", query=[("delete", "")], body=body
        )
        self._check(st, data)

    async def put_bucket_config(self, bucket: str, sub: str, xml_body: bytes):
        st, _h, data = await self._req(
            "PUT", f"/{bucket}", query=[(sub, "")], body=xml_body
        )
        self._check(st, data)

    async def get_bucket_config(self, bucket: str, sub: str) -> bytes:
        st, _h, data = await self._req("GET", f"/{bucket}", query=[(sub, "")])
        self._check(st, data)
        return data
