"""Static-website server (reference src/web/web_server.rs:70).

Serves buckets whose website config is enabled, vhost-style: Host
`<bucket>.<root_domain>` (or an alias matching the Host exactly).  Reuses
the S3 GET path without authentication; index documents for directory
paths, error documents for 404s, CORS headers from the bucket config.
"""

from __future__ import annotations

import logging

from aiohttp import web

from ..api.common.error import ApiError
from ..api.s3.bucket_config import add_cors_headers, find_matching_cors_rule
from ..api.s3.objects import handle_get_object
from ..utils.error import Error

logger = logging.getLogger("garage.web")


class WebServer:
    def __init__(self, garage):
        self.garage = garage
        self.root_domain = garage.config.s3_web.root_domain
        self.app = web.Application()
        self.app.router.add_route("*", "/{tail:.*}", self._entry)
        self.runner: web.AppRunner | None = None

    async def start(self, host: str, port: int) -> None:
        self.runner = web.AppRunner(self.app, access_log=None)
        await self.runner.setup()
        site = web.TCPSite(self.runner, host, port)
        await site.start()
        logger.info("web server listening on %s:%d", host, port)

    async def stop(self) -> None:
        if self.runner:
            await self.runner.cleanup()

    def _bucket_name(self, request) -> str:
        host = request.headers.get("Host", "").split(":")[0]
        rd = (self.root_domain or "").lstrip(".")
        if rd and host != rd and host.endswith("." + rd):
            return host[: -(len(rd) + 1)]
        return host  # a global alias can be a bare domain name

    async def _entry(self, request: web.Request) -> web.StreamResponse:
        from ..utils.metrics import request_metrics

        try:
            with request_metrics(
                "web", request.method, "web", host=self._bucket_name(request)
            ):
                return await self._serve(request)
        except (ApiError, Error) as e:
            status = getattr(e, "status", 404)
            return web.Response(status=status if status != 403 else 404, text=str(e))

    async def _serve(self, request: web.Request) -> web.StreamResponse:
        bucket_name = self._bucket_name(request)
        bucket_id = await self.garage.helper.resolve_bucket(bucket_name)
        bucket = await self.garage.helper.get_bucket(bucket_id)
        params = bucket.params()
        website = params.website.get()
        if not website:
            raise ApiError("bucket is not a website", code="Forbidden", status=403)

        origin = request.headers.get("Origin", "")
        if request.method == "OPTIONS":
            rule = find_matching_cors_rule(
                params, origin, request.headers.get("Access-Control-Request-Method", "GET")
            )
            resp = web.Response(status=200 if rule else 403)
            if rule:
                add_cors_headers(resp, rule, origin)
            return resp
        if request.method not in ("GET", "HEAD"):
            raise ApiError("method not allowed", code="MethodNotAllowed", status=405)

        key = request.path.lstrip("/")
        if not key or key.endswith("/"):
            key = key + website["index_document"]
        try:
            resp = await handle_get_object(
                self.garage, bucket_id, key, request,
                head_only=(request.method == "HEAD"),
                allow_overrides=False,  # anonymous path: no response-* rewrites
            )
        except ApiError as e:
            if e.status == 404 and website.get("error_document"):
                try:
                    resp = await handle_get_object(
                        self.garage, bucket_id, website["error_document"],
                        request, allow_overrides=False,
                    )
                    if not resp.prepared:
                        resp.set_status(404)
                except ApiError:
                    raise e from None
            else:
                raise
        if origin and not resp.prepared:
            # streamed (multi-block) responses are already on the wire;
            # CORS headers can only be added to buffered ones
            rule = find_matching_cors_rule(params, origin, request.method)
            if rule:
                add_cors_headers(resp, rule, origin)
        return resp
