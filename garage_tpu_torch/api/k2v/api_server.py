"""K2V REST API (reference src/api/k2v/ router.rs:15-51, item.rs,
batch.rs, index.rs).

  GET    /bucket                         ReadIndex (partition keys + counts)
  POST   /bucket                         InsertBatch (JSON)
  POST   /bucket?search                  ReadBatch (JSON)
  POST   /bucket?delete                  DeleteBatch (JSON)
  GET    /bucket/pk/sk                   ReadItem (raw or JSON per Accept)
  GET    /bucket/pk/sk?poll&causality_token=..&timeout=..  PollItem
  PUT    /bucket/pk/sk                   InsertItem (X-Garage-Causality-Token)
  DELETE /bucket/pk/sk                   DeleteItem (token required)

Values travel base64 in JSON bodies, raw in single-value responses.
SigV4 auth + bucket permissions, same as S3.
"""

from __future__ import annotations

import base64
import json
import logging
import urllib.parse

from aiohttp import web

from ...model.k2v.item_table import CausalContext
from ...utils.error import Error
from ..common.error import ApiError, BadRequest, Forbidden, NoSuchKey, error_xml
from ..common.signature import verify_request

logger = logging.getLogger("garage.api.k2v")

TOKEN_HEADER = "X-Garage-Causality-Token"


class K2VApiServer:
    def __init__(self, garage):
        self.garage = garage
        self.region = garage.config.s3_api.s3_region
        self.app = web.Application(client_max_size=64 * 1024 * 1024)
        self.app.router.add_route("*", "/{tail:.*}", self._entry)
        self.runner: web.AppRunner | None = None

    async def start(self, host: str, port: int) -> None:
        self.runner = web.AppRunner(self.app, access_log=None)
        await self.runner.setup()
        site = web.TCPSite(self.runner, host, port)
        await site.start()
        logger.info("k2v api listening on %s:%d", host, port)

    async def stop(self) -> None:
        if self.runner:
            await self.runner.cleanup()

    async def _get_secret(self, key_id: str):
        k = await self.garage.key_table.get(key_id.encode(), b"")
        if k is None or k.is_deleted():
            return None
        return k.secret()

    async def _entry(self, request: web.Request) -> web.StreamResponse:
        from ...utils.metrics import request_metrics

        try:
            with request_metrics(
                "api_k2v", request.method, "api:k2v", path=request.path
            ):
                return await self._handle(request)
        except ApiError as e:
            return web.Response(
                status=e.status,
                text=error_xml(e, request.path),
                content_type="application/xml",
            )
        except Error as e:
            status = 404 if "not found" in str(e) else 500
            return web.Response(status=status, text=str(e))
        except (ValueError, KeyError, TypeError) as e:
            # malformed tokens / numbers / JSON bodies are caller errors
            return web.Response(status=400, text=f"bad request: {e!r}")
        except Exception as e:  # noqa: BLE001
            logger.exception("k2v api error")
            return web.Response(status=500, text=repr(e))

    async def _handle(self, request: web.Request) -> web.StreamResponse:
        ctx = await verify_request(request, self._get_secret, self.region)
        api_key = await self.garage.helper.get_key(ctx.key_id)
        # split the RAW path first so %2F inside keys survives, then
        # unquote each segment
        raw = request.raw_path.split("?")[0].lstrip("/")
        parts = [urllib.parse.unquote(p) for p in raw.split("/", 2)]
        bucket_name = parts[0]
        if not bucket_name:
            raise BadRequest("no bucket")
        bucket_id = await self.garage.helper.resolve_bucket(bucket_name, api_key)
        perm = api_key.bucket_permissions(bucket_id)
        pk = parts[1] if len(parts) > 1 else None
        sk = parts[2] if len(parts) > 2 else None
        q = request.query
        m = request.method

        if pk is None or pk == "":
            if m == "GET":
                _req(perm.allow_read)
                return await self._read_index(bucket_id, request)
            if m == "POST":
                _req(perm.allow_write)
                if "delete" in q:
                    return await self._delete_batch(bucket_id, request)
                if "search" in q:
                    _req(perm.allow_read)
                    return await self._read_batch(bucket_id, request)
                return await self._insert_batch(bucket_id, request)
            raise BadRequest(f"unsupported {m} on bucket")

        if sk is None:
            if m == "POST" and "poll_range" in q:
                _req(perm.allow_read)
                return await self._poll_range(bucket_id, pk, request)
            raise BadRequest("missing sort key")

        if m == "GET":
            _req(perm.allow_read)
            if "poll" in q:
                return await self._poll_item(bucket_id, pk, sk, request)
            return await self._read_item(bucket_id, pk, sk, request)
        if m == "PUT":
            _req(perm.allow_write)
            body = await request.read()
            causal = _token_of(request)
            await self.garage.k2v_rpc.insert(bucket_id, pk, sk, causal, body)
            return web.Response(status=204)
        if m == "DELETE":
            _req(perm.allow_write)
            causal = _token_of(request)
            if causal is None:
                raise BadRequest("DeleteItem requires X-Garage-Causality-Token")
            await self.garage.k2v_rpc.insert(bucket_id, pk, sk, causal, None)
            return web.Response(status=204)
        raise BadRequest(f"unsupported method {m}")

    # --- item ops -------------------------------------------------------------

    async def _read_item(self, bucket_id, pk, sk, request) -> web.Response:
        item = await self.garage.k2v_item_table.get(
            bucket_id + pk.encode(), sk.encode()
        )
        if item is None or item.is_tombstone():
            raise NoSuchKey("item not found")
        token = item.causal_context().serialize()
        values = item.live_values()
        accept = request.headers.get("Accept", "*/*")
        if len(values) == 1 and "application/json" not in accept:
            return web.Response(
                body=values[0],
                headers={TOKEN_HEADER: token},
                content_type="application/octet-stream",
            )
        return web.json_response(
            [base64.b64encode(v).decode() for v in values],
            headers={TOKEN_HEADER: token},
        )

    async def _poll_item(self, bucket_id, pk, sk, request) -> web.Response:
        token = request.query.get("causality_token", "")
        timeout = min(float(request.query.get("timeout", "300")), 600.0)
        causal = CausalContext.parse(token) if token else CausalContext()
        item = await self.garage.k2v_rpc.poll_item(bucket_id, pk, sk, causal, timeout)
        if item is None:
            return web.Response(status=304)
        values = item.live_values()
        return web.json_response(
            [base64.b64encode(v).decode() for v in values],
            headers={TOKEN_HEADER: item.causal_context().serialize()},
        )

    async def _poll_range(self, bucket_id, pk, request) -> web.Response:
        """PollRange (reference src/api/k2v/batch.rs:255): long-poll a
        whole sort-key range for changes the seenMarker hasn't covered."""
        body = json.loads(await request.read() or b"{}")
        timeout = min(max(float(body.get("timeout", 300)), 1.0), 600.0)
        res = await self.garage.k2v_rpc.poll_range(
            bucket_id,
            pk,
            body.get("start"),
            body.get("end"),
            body.get("prefix"),
            body.get("seenMarker"),
            timeout,
        )
        if res is None:
            return web.Response(status=304)
        items, seen_marker = res
        return web.json_response(
            {
                "items": [
                    {
                        "sk": sk,
                        "ct": item.causal_context().serialize(),
                        "v": [
                            base64.b64encode(v).decode() if v is not None else None
                            for v in item.values()
                        ],
                    }
                    for sk, item in items.items()
                ],
                "seenMarker": seen_marker,
            }
        )

    # --- index + batches ------------------------------------------------------

    async def _read_index(self, bucket_id, request) -> web.Response:
        q = request.query
        prefix = q.get("prefix", "")
        limit = min(int(q.get("limit", "1000")), 1000)
        start = q.get("start", "")
        # full ReadIndexQuery surface (reference index.rs): prefix, start,
        # end, limit, reverse.  Partition keys live in the counter table,
        # keyed (bucket, pk): an ordered distributed range read, streamed
        # so filtered-out rows never eat the page budget.
        end = q.get("end")
        reverse = q.get("reverse") == "true"
        begin = self._range_begin(prefix or None, start or None, reverse)
        nodes = self.garage.system.layout_manager.history.current().storage_nodes()
        seen = []
        async for ent in self._iter_range(
            self.garage.k2v_counter_table, bucket_id, begin, None, reverse,
            lambda e: e.sk.decode(errors="replace"),
        ):
            pk = ent.sk.decode(errors="replace")
            if prefix and not pk.startswith(prefix):
                if (not reverse and pk > prefix) or (reverse and pk < prefix):
                    break  # sorted: past the prefix range
                continue
            if end is not None and (
                (not reverse and pk >= end) or (reverse and pk <= end)
            ):
                break
            vals = ent.aggregate(nodes)
            if vals.get("items", 0) <= 0:
                continue
            if len(seen) > limit:
                break
            seen.append((pk, vals))
        truncated = len(seen) > limit
        seen = seen[:limit]
        return web.json_response(
            {
                "prefix": prefix or None,
                "partitionKeys": [
                    {
                        "pk": pk,
                        "entries": v.get("items", 0),
                        "conflicts": v.get("conflicts", 0),
                        "values": v.get("values", 0),
                        "bytes": v.get("bytes", 0),
                    }
                    for pk, v in seen
                ],
                "more": truncated,
            }
        )

    async def _insert_batch(self, bucket_id, request) -> web.Response:
        body = json.loads(await request.read())
        items = []
        for it in body:
            v = it.get("v")
            items.append(
                (
                    it["pk"],
                    it["sk"],
                    CausalContext.parse(it["ct"]) if it.get("ct") else None,
                    base64.b64decode(v) if v is not None else None,
                )
            )
        await self.garage.k2v_rpc.insert_batch(bucket_id, items)
        return web.Response(status=204)

    async def _read_batch(self, bucket_id, request) -> web.Response:
        """ReadBatch with the full reference query surface
        (src/api/k2v/batch.rs ReadBatchQuery): prefix, start, end, limit,
        reverse, singleItem, conflictsOnly, tombstones."""
        body = json.loads(await request.read())
        out = []
        for search in body:
            pk = search["partitionKey"]
            prefix = search.get("prefix")
            start = search.get("start")
            end = search.get("end")
            limit = min(int(search.get("limit") or 1000), 1000)
            reverse = bool(search.get("reverse"))
            single = bool(search.get("singleItem"))
            conflicts_only = bool(search.get("conflictsOnly"))
            tombstones = bool(search.get("tombstones"))
            filt = None if tombstones else "present"

            if single:
                if start is None:
                    raise ValueError("singleItem requires start")
                item = await self.garage.k2v_item_table.get(
                    bucket_id + pk.encode(), start.encode()
                )

                async def _single(_item=item):
                    if _item is not None:
                        yield _item

                items = _single()
            else:
                items = self._iter_partition(
                    bucket_id + pk.encode(),
                    self._range_begin(prefix, start, reverse),
                    filt,
                    reverse,
                )
            rows = []
            more = False
            next_start = None
            async for item in items:
                sk = item.sort_key
                if prefix is not None and not sk.startswith(prefix):
                    if (not reverse and sk > prefix) or (reverse and sk < prefix):
                        break
                    continue
                if end is not None and (
                    (not reverse and sk >= end) or (reverse and sk <= end)
                ):
                    break
                if not tombstones and item.is_tombstone():
                    continue
                if conflicts_only and len(item.live_values()) <= 1:
                    continue
                if len(rows) >= limit:
                    more = True
                    next_start = sk
                    break
                rows.append(
                    {
                        "sk": sk,
                        "ct": item.causal_context().serialize(),
                        "v": [
                            base64.b64encode(v).decode() if v is not None else None
                            for v in (
                                item.values() if tombstones else item.live_values()
                            )
                        ],
                    }
                )
            out.append(
                {
                    "partitionKey": pk,
                    "prefix": prefix,
                    "start": start,
                    "end": end,
                    "limit": limit,
                    "reverse": reverse,
                    "singleItem": single,
                    "conflictsOnly": conflicts_only,
                    "tombstones": tombstones,
                    "items": rows,
                    "more": more,
                    "nextStart": next_start,
                }
            )
        return web.json_response(out)

    @staticmethod
    def _range_begin(prefix: str | None, start: str | None, reverse: bool):
        """Start bound for a (possibly reverse) range enumeration, shared
        by ReadBatch and ReadIndex.  Reverse scans start AT the bound and
        walk DOWN, so `start` is an upper bound there; with only a prefix
        the reverse scan starts just past the prefix range."""
        if reverse:
            if start is not None:
                return start.encode()
            if prefix is not None:
                from ...db import _prefix_end

                return _prefix_end(prefix.encode())
            return None
        begin = start if start is not None else prefix
        return begin.encode() if begin else None

    async def _iter_range(self, table, part_pk: bytes, begin_bytes, filt,
                          reverse, sk_of):
        """Page through a partition range without a silent row cap —
        filters may discard arbitrarily many rows before filling a page,
        so enumeration must continue until the range is exhausted.
        `sk_of(entry) -> str` extracts the sort key."""
        cursor = begin_bytes
        skip_past: str | None = None  # reverse resume is inclusive: skip it
        while True:
            batch = await table.get_range(
                part_pk, cursor, filt, 1000, reverse=reverse
            )
            if not batch:
                return
            for item in batch:
                if skip_past is not None and sk_of(item) >= skip_past:
                    continue
                yield item
            last = sk_of(batch[-1])
            if len(batch) < 1000:
                return
            if reverse:
                cursor, skip_past = last.encode(), last
            else:
                cursor, skip_past = last.encode() + b"\x00", None

    def _iter_partition(self, part_pk: bytes, begin_bytes, filt, reverse):
        return self._iter_range(
            self.garage.k2v_item_table, part_pk, begin_bytes, filt, reverse,
            lambda item: item.sort_key,
        )

    async def _delete_batch(self, bucket_id, request) -> web.Response:
        """DeleteBatch with the reference query shape (batch.rs
        DeleteBatchQuery): prefix, start, end, singleItem — streamed over
        the full range via the shared enumeration."""
        body = json.loads(await request.read())
        # validate EVERY query item before mutating anything — a malformed
        # later entry must not leave earlier deletions half-applied
        for d in body:
            d["partitionKey"]  # KeyError -> 400 before any delete
            if d.get("singleItem") and d.get("start") is None:
                raise ValueError("singleItem requires start")
        deleted = []
        for d in body:
            pk = d["partitionKey"]
            prefix = d.get("prefix")
            start = d.get("start")
            end = d.get("end")
            single = d.get("singleItem", False)
            n = 0
            if single:
                item = await self.garage.k2v_item_table.get(
                    bucket_id + pk.encode(), start.encode()
                )
                if item is not None and not item.is_tombstone():
                    await self.garage.k2v_rpc.insert(
                        bucket_id, pk, start, item.causal_context(), None
                    )
                    n = 1
            else:
                # collect tombstones and flush in bounded-concurrency
                # batches — one sequential quorum RPC per item would make
                # big range deletes N x RTT
                pending: list = []
                async for item in self._iter_partition(
                    bucket_id + pk.encode(),
                    self._range_begin(prefix, start, False),
                    "present",
                    False,
                ):
                    sk = item.sort_key
                    if prefix is not None and not sk.startswith(prefix):
                        if sk > prefix:
                            break
                        continue
                    if end is not None and sk >= end:
                        break
                    pending.append((pk, sk, item.causal_context(), None))
                    n += 1
                    if len(pending) >= 256:
                        await self.garage.k2v_rpc.insert_batch(bucket_id, pending)
                        pending = []
                if pending:
                    await self.garage.k2v_rpc.insert_batch(bucket_id, pending)
            deleted.append({"partitionKey": pk, "deletedItems": n})
        return web.json_response(deleted)


def _token_of(request) -> CausalContext | None:
    tok = request.headers.get(TOKEN_HEADER)
    return CausalContext.parse(tok) if tok else None


def _req(cond: bool) -> None:
    if not cond:
        raise Forbidden("access denied")