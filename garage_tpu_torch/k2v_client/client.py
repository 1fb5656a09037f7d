"""Async K2V client with SigV4 signing (reference src/k2v-client/)."""

from __future__ import annotations

import base64
import json
import urllib.parse

import aiohttp

from ..api.common.signature import sign_request_headers

TOKEN_HEADER = "X-Garage-Causality-Token"


class K2VError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class K2VClient:
    def __init__(self, endpoint: str, bucket: str, key_id: str, secret: str, region="garage"):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.key_id = key_id
        self.secret = secret
        self.region = region
        self.host = urllib.parse.urlparse(self.endpoint).netloc
        self._session: aiohttp.ClientSession | None = None

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    async def _req(self, method, path, query=None, body=b"", headers=None, timeout=300):
        query = query or []
        h = dict(headers or {})
        h["host"] = self.host
        signed = sign_request_headers(
            method, path, query, h, body, self.key_id, self.secret, self.region
        )
        qs = urllib.parse.urlencode(query)
        url = self.endpoint + path + ("?" + qs if qs else "")
        async with self._sess().request(
            method, url, data=body, headers=signed,
            timeout=aiohttp.ClientTimeout(total=timeout),
        ) as resp:
            data = await resp.read()
            return resp.status, resp.headers.copy(), data

    # --- item ops -------------------------------------------------------------

    async def read_item(self, pk: str, sk: str) -> tuple[list[bytes], str]:
        """-> (values, causality_token)"""
        st, h, data = await self._req(
            "GET", f"/{self.bucket}/{urllib.parse.quote(pk, safe='')}/{urllib.parse.quote(sk, safe='')}", headers={"accept": "application/json"}
        )
        if st == 404:
            raise K2VError(404, "not found")
        if st != 200:
            raise K2VError(st, data.decode(errors="replace"))
        vals = [base64.b64decode(v) for v in json.loads(data)]
        return vals, h.get(TOKEN_HEADER, "")

    async def insert_item(self, pk: str, sk: str, value: bytes, token: str | None = None):
        headers = {TOKEN_HEADER.lower(): token} if token else {}
        st, _h, data = await self._req(
            "PUT", f"/{self.bucket}/{urllib.parse.quote(pk, safe='')}/{urllib.parse.quote(sk, safe='')}", body=value, headers=headers
        )
        if st not in (200, 204):
            raise K2VError(st, data.decode(errors="replace"))

    async def delete_item(self, pk: str, sk: str, token: str):
        st, _h, data = await self._req(
            "DELETE", f"/{self.bucket}/{urllib.parse.quote(pk, safe='')}/{urllib.parse.quote(sk, safe='')}", headers={TOKEN_HEADER.lower(): token}
        )
        if st not in (200, 204):
            raise K2VError(st, data.decode(errors="replace"))

    async def poll_item(self, pk: str, sk: str, token: str, timeout: float = 60):
        st, h, data = await self._req(
            "GET",
            f"/{self.bucket}/{urllib.parse.quote(pk, safe='')}/{urllib.parse.quote(sk, safe='')}",
            query=[("poll", ""), ("causality_token", token), ("timeout", str(timeout))],
            timeout=timeout + 30,
        )
        if st == 304:
            return None
        if st != 200:
            raise K2VError(st, data.decode(errors="replace"))
        return [base64.b64decode(v) for v in json.loads(data)], h.get(TOKEN_HEADER, "")

    async def poll_range(
        self,
        pk: str,
        seen_marker: str | None = None,
        start: str | None = None,
        end: str | None = None,
        prefix: str | None = None,
        timeout: float = 60,
    ):
        """-> ({sk: {"ct":…, "v":[bytes|None]}}, seen_marker) or None (304)."""
        body = {"timeout": timeout}
        if seen_marker is not None:
            body["seenMarker"] = seen_marker
        for k, v in (("start", start), ("end", end), ("prefix", prefix)):
            if v is not None:
                body[k] = v
        st, _h, data = await self._req(
            "POST",
            f"/{self.bucket}/{urllib.parse.quote(pk, safe='')}",
            query=[("poll_range", "")],
            body=json.dumps(body).encode(),
            timeout=timeout + 30,
        )
        if st == 304:
            return None
        if st != 200:
            raise K2VError(st, data.decode(errors="replace"))
        res = json.loads(data)
        items = {
            it["sk"]: {
                "ct": it["ct"],
                "v": [
                    base64.b64decode(v) if v is not None else None
                    for v in it["v"]
                ],
            }
            for it in res["items"]
        }
        return items, res["seenMarker"]

    # --- index + batch --------------------------------------------------------

    async def read_index(self, prefix: str = "", limit: int = 1000) -> dict:
        q = [("limit", str(limit))]
        if prefix:
            q.append(("prefix", prefix))
        st, _h, data = await self._req("GET", f"/{self.bucket}", query=q)
        if st != 200:
            raise K2VError(st, data.decode(errors="replace"))
        return json.loads(data)

    async def insert_batch(self, items: list[tuple[str, str, bytes, str | None]]):
        """items: [(pk, sk, value, token|None)]"""
        body = json.dumps(
            [
                {
                    "pk": pk,
                    "sk": sk,
                    "ct": token,
                    "v": base64.b64encode(value).decode(),
                }
                for pk, sk, value, token in items
            ]
        ).encode()
        st, _h, data = await self._req("POST", f"/{self.bucket}", body=body)
        if st not in (200, 204):
            raise K2VError(st, data.decode(errors="replace"))

    async def read_batch(self, searches: list[dict]) -> list[dict]:
        body = json.dumps(searches).encode()
        st, _h, data = await self._req(
            "POST", f"/{self.bucket}", query=[("search", "")], body=body
        )
        if st != 200:
            raise K2VError(st, data.decode(errors="replace"))
        return json.loads(data)

    async def delete_batch(self, deletes: list[dict]) -> list[dict]:
        body = json.dumps(deletes).encode()
        st, _h, data = await self._req(
            "POST", f"/{self.bucket}", query=[("delete", "")], body=body
        )
        if st != 200:
            raise K2VError(st, data.decode(errors="replace"))
        return json.loads(data)