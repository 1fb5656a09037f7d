"""Admin REST API (reference src/api/admin/api_server.rs).

  GET /health            no auth: cluster health summary (for LBs)
  GET /metrics           Prometheus text (metrics_token bearer auth)
  GET /v1/status         cluster status
  GET /v1/layout  POST /v1/layout  POST /v1/layout/apply|revert
  GET/POST /v1/bucket[?id=..]  GET/POST /v1/key[?id=..]
  POST /v1/bucket/allow|deny

Bearer-token auth with admin_token (metrics_token for /metrics only).
"""

from __future__ import annotations

import json
import logging

from aiohttp import web

from ...rpc.layout.types import NodeRole
from ...utils.data import hex_of

logger = logging.getLogger("garage.api.admin")


class AdminApiServer:
    def __init__(self, garage):
        self.garage = garage
        self.admin_token = garage.config.admin.admin_token
        self.metrics_token = garage.config.admin.metrics_token
        self.app = web.Application()
        self.app.router.add_route("*", "/{tail:.*}", self._entry)
        self.runner: web.AppRunner | None = None

    async def start(self, host: str, port: int) -> None:
        self.runner = web.AppRunner(self.app, access_log=None)
        await self.runner.setup()
        site = web.TCPSite(self.runner, host, port)
        await site.start()
        logger.info("admin api listening on %s:%d", host, port)

    async def stop(self) -> None:
        if self.runner:
            await self.runner.cleanup()

    def _check_token(self, request, token: str | None) -> bool:
        if token is None:
            return False
        import hmac

        auth = request.headers.get("Authorization", "")
        return hmac.compare_digest(auth, f"Bearer {token}")

    async def _entry(self, request: web.Request) -> web.Response:
        path = request.path
        try:
            if path == "/health":
                return self._health()
            if path == "/check":
                # reverse-proxy hook (e.g. on-demand TLS): is this domain
                # served by the cluster?  (reference api_server.rs:79-137)
                domain = request.query.get("domain")
                if not domain:
                    return web.Response(status=400, text="no domain query")
                if await self._check_domain(domain):
                    return web.Response(
                        text=f"Domain '{domain}' is managed by garage-tpu"
                    )
                return web.Response(
                    status=400,
                    text=f"Domain '{domain}' is not managed by garage-tpu",
                )
            if path in ("/metrics", "/metrics/cluster"):
                if self.metrics_token and not (
                    self._check_token(request, self.metrics_token)
                    or self._check_token(request, self.admin_token)
                ):
                    return web.Response(status=403, text="forbidden")
                if path == "/metrics/cluster":
                    # federated exposition of the gossiped telemetry
                    # digests: one scrape of ANY node covers the cluster
                    # (rpc/telemetry_digest.py)
                    from ...rpc.telemetry_digest import render_cluster_metrics

                    return web.Response(
                        text=render_cluster_metrics(self.garage),
                        content_type="text/plain",
                    )
                return self._metrics()
            if not self._check_token(request, self.admin_token):
                return web.Response(status=403, text="forbidden")
            if path.startswith("/v0/"):
                # legacy v0 admin router: same operations, same handlers
                # (reference router_v0.rs delegates to the v1 handlers
                # the same way)
                path = "/v1/" + path[len("/v0/"):]
            return await self._v1(request, path)
        except Exception as e:  # noqa: BLE001
            logger.exception("admin api error")
            return web.json_response({"error": repr(e)}, status=500)

    # --- public endpoints -----------------------------------------------------

    async def _check_domain(self, domain: str) -> bool:
        """Domain -> bucket: under the S3 root_domain any existing bucket
        counts; under the web root_domain (or as a bare vhost) the bucket
        must have website access enabled (reference api_server.rs:116-137)."""
        from ...utils.error import Error

        g = self.garage

        def strip(rd: str | None) -> str | None:
            # label-boundary match, leading dot optional in the config —
            # same normalization as the S3/web vhost routing
            if not rd:
                return None
            rd = rd.lstrip(".")
            if domain.endswith("." + rd) and len(domain) > len(rd) + 1:
                return domain[: -(len(rd) + 1)]
            return None

        bname = strip(g.config.s3_api.root_domain)
        must_website = False
        if bname is None:
            bname = strip(g.config.s3_web.root_domain)
            must_website = True
            if bname is None:
                bname = domain  # vhost-style: the domain IS the bucket name
        try:
            bucket = await g.helper.get_bucket(
                await g.helper.resolve_bucket(bname)
            )
        except Error:
            return False
        if must_website:
            return bucket.params().website.get() is not None
        return True

    def _health(self) -> web.Response:
        h = self.garage.system.health()
        status = 200 if h.status in ("healthy", "degraded") else 503
        return web.json_response(h.__dict__, status=status)

    def _metrics(self) -> web.Response:
        """Prometheus exposition (metric families per layer, reference
        doc/book/reference-manual/monitoring.md).

        Only families the registry does NOT own are rendered inline; the
        resync/merkle/gc queue lengths and `cluster_connected_nodes` come
        exclusively from the registry gauges (model/garage.py), and
        per-worker health from the runner's `worker_*` families
        (utils/background.py) — emitting them here too was a strict
        exposition-format violation (duplicate families), caught by the
        metrics-lint test."""
        g = self.garage
        h = g.system.health()
        lines = []

        def m(name, value, help_=""):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {value}")

        m("cluster_healthy", 1 if h.status == "healthy" else 0, "cluster health")
        m("cluster_known_nodes", h.known_nodes)
        m("cluster_storage_nodes", h.storage_nodes)
        m("cluster_storage_nodes_up", h.storage_nodes_up)
        m("cluster_partitions_quorum", h.partitions_quorum)
        m("cluster_partitions_all_ok", h.partitions_all_ok)
        m(
            "cluster_outlier_nodes", len(h.outlier_nodes),
            "nodes MAD-flagged as outliers (see /metrics/cluster for which)",
        )
        m("cluster_layout_version", g.layout_manager.history.current().version)
        lines.append("# TYPE table_size gauge")
        for t in g.tables:
            n = t.schema.table_name
            lines.append(f'table_size{{table_name="{n}"}} {len(t.data.store)}')
        m("block_rc_entries", len(g.block_manager.rc.tree))
        from ...utils.metrics import registry

        lines.extend(registry.render())
        return web.Response(text="\n".join(lines) + "\n", content_type="text/plain")

    # --- v1 admin -------------------------------------------------------------

    async def _v1(self, request, path) -> web.Response:
        g = self.garage
        if path == "/v1/status" and request.method == "GET":
            h = g.system.health()
            cur = g.layout_manager.history.current()
            ph = getattr(g, "peer_health", None)
            rpc_health = ph.snapshot() if ph is not None else {}
            nodes = []
            for nid in set(
                list(cur.roles.keys()) + [g.node_id] + list(g.system.peering.peers.keys())
            ):
                role = cur.roles.get(nid)
                nodes.append(
                    {
                        "id": hex_of(nid),
                        "role": {
                            "zone": role.zone,
                            "capacity": role.capacity,
                            "tags": role.tags,
                        }
                        if role
                        else None,
                        "isUp": nid == g.node_id or g.netapp.is_connected(nid),
                        # circuit-breaker / EWMA view of this peer from the
                        # answering node (rpc/peer_health.py); None for
                        # self and never-contacted peers
                        "rpcHealth": rpc_health.get(hex_of(nid)),
                    }
                )
            return web.json_response(
                {
                    "node": hex_of(g.node_id),
                    "garageVersion": "garage-tpu/0.1.0",
                    "layoutVersion": cur.version,
                    "health": h.__dict__,
                    "nodes": nodes,
                }
            )

        if path == "/v1/health" and request.method == "GET":
            # GetClusterHealth: standalone health JSON resource (reference
            # router_v1.rs:102, cluster.rs ClusterHealth struct) — same
            # payload /health serves LBs, but authenticated + always 200
            # so operators can read the *reason* a cluster is unavailable.
            # Field casing follows the reference admin API (camelCase,
            # cluster.rs ClusterHealth serde rename_all) like the sibling
            # /v1/node endpoint.
            h = g.system.health()
            return web.json_response(
                {
                    "status": h.status,
                    "knownNodes": h.known_nodes,
                    "connectedNodes": h.connected_nodes,
                    "storageNodes": h.storage_nodes,
                    "storageNodesOk": h.storage_nodes_up,
                    "partitions": h.partitions,
                    "partitionsQuorum": h.partitions_quorum,
                    "partitionsAllOk": h.partitions_all_ok,
                    "outlierNodes": h.outlier_nodes,
                }
            )

        if path == "/v1/cluster/telemetry" and request.method == "GET":
            # cluster telemetry rollup (rpc/telemetry_digest.py): per-node
            # digest rows + cluster aggregates + MAD outliers + SLO state,
            # assembled entirely from gossiped state — answering this
            # needs NO fan-out to the other nodes
            from ...rpc.telemetry_digest import rollup

            return web.json_response(rollup(g))

        if path == "/v1/cluster/durability" and request.method == "GET":
            # durability observatory (block/durability.py): redundancy
            # ledger classes, zone-loss exposure, repair ETA and layout
            # progress — per-node rows from the gossiped dur.* digest
            # keys plus the local ledger detail.  Zone NAMES live here
            # (JSON), never as metric labels.
            from ...block.durability import durability_response

            return web.json_response(durability_response(g))

        if path == "/v1/cluster/transition" and request.method == "GET":
            # rebalance observatory (rpc/transition.py): local transition
            # flight deck (partition states, per-pair bytes, throughput,
            # ETA, last report) + every node's gossiped lt.* digest +
            # cluster aggregate (version spread, stale nodes, worst
            # skew) — assembled from gossip, no fan-out needed
            from ...rpc.transition import transition_response

            return web.json_response(transition_response(g))

        if path == "/v1/cluster/events" and request.method == "GET":
            # federated event timeline (rpc/transition.py): fan out to
            # every connected peer's flight-event bank and merge into
            # one skew-corrected, causally-ordered timeline.
            # ?since=<epoch secs> and ?min_severity=info|warn|critical
            from ...rpc.transition import cluster_events_response

            return web.json_response(
                await cluster_events_response(
                    g,
                    since=float(request.query.get("since", 0) or 0),
                    min_severity=request.query.get("min_severity", "info"),
                )
            )

        if path == "/v1/cluster/tenants" and request.method == "GET":
            # tenant observatory (rpc/tenant.py): cluster-summed
            # per-tenant consumption + fairness stats + per-node rows
            # from the gossiped tn.* digest keys — tenant KEY IDS live
            # here (JSON), never as metric labels (cardinality guard)
            from ...rpc.tenant import tenants_response

            return web.json_response(tenants_response(g))

        if path == "/v1/codec" and request.method == "GET":
            # codec X-ray (ops/telemetry.py + rpc/telemetry_digest.py):
            # local per-kernel pad accounting, compile events, overlap
            # efficiency, batcher lane linger, plus the cluster view from
            # the gossiped codec.* digest keys — kernel/cache/lane
            # breakdowns live HERE (JSON), the exposition only carries
            # bounded label sets
            from ...rpc.telemetry_digest import codec_response

            return web.json_response(codec_response(g))

        if path == "/v1/traffic" and request.method == "GET":
            # traffic observatory (rpc/traffic.py): local hot-object /
            # hot-bucket top-K, op mix, size histogram, zipf skew, the
            # slow-peer piece-fetch ranking, and the cluster rollup from
            # the gossiped trf.* digest keys.  Per-key data lives HERE,
            # never as Prometheus series (cardinality guard).
            from ...rpc.traffic import traffic_response

            return web.json_response(traffic_response(g))

        if path == "/v1/traffic/profile" and request.method == "GET":
            # replayable workload profile: op mix + size distribution +
            # popularity skew + inter-arrival stats — the contract the
            # workload generator (ROADMAP item 5) consumes
            from ...rpc.traffic import profile_response

            return web.json_response(profile_response(g))

        if path == "/v1/debug/profile" and request.method == "GET":
            # flight recorder: on-demand sampling profiler (utils/flight.py).
            # Folded-stack text by default; ?format=speedscope for JSON.
            from ...utils import flight

            prof = await flight.profile(
                request.query.get("seconds", "2"),
                hz=request.query.get("hz", "100"),
            )
            if request.query.get("format") == "speedscope":
                return web.json_response(prof.speedscope())
            return web.Response(
                text=prof.folded(),
                content_type="text/plain",
                headers={"x-garage-profile-samples": str(prof.samples)},
            )

        if path == "/v1/debug/latency" and request.method == "GET":
            # latency X-ray (utils/latency.py): rolling per-op phase
            # waterfall — p50/p95/p99 per phase, critical-path share,
            # coverage, overlap efficiency
            from ...utils.latency import latency_response

            return web.json_response(latency_response())

        if path == "/v1/debug/slow" and request.method == "GET":
            # flight recorder: span trees of the slowest recent requests
            from ...utils import flight

            return web.json_response(
                flight.slow_response(getattr(g, "flight_recorder", None))
            )

        if path == "/v1/connect" and request.method == "POST":
            # ConnectClusterNodes (reference router_v1.rs:103,
            # cluster.rs:139-161): body = JSON array of "id@host:port";
            # response = per-node [{success, error}] in request order.
            body = await request.json()
            if not isinstance(body, list):
                return web.Response(status=400, text="expected a JSON array")
            results = []
            for node in body:
                try:
                    nid_hex, _, addr = str(node).partition("@")
                    host, _, port = addr.rpartition(":")
                    if not (nid_hex and host and port):
                        raise ValueError(f"malformed node address {node!r}")
                    await g.netapp.connect(
                        (host, int(port)), bytes.fromhex(nid_hex)
                    )
                    results.append({"success": True, "error": None})
                except Exception as e:  # noqa: BLE001 — per-node report
                    results.append({"success": False, "error": str(e)})
            return web.json_response(results)

        if path == "/v1/overload" and request.method == "GET":
            # overload-control plane (api/overload.py + rpc/shedding.py):
            # admission counters per tier, tenant token levels, ladder
            # level + applied rungs + hysteresis signals
            return web.json_response(g.overload_status())

        if path == "/v1/repair/plan" and request.method == "GET":
            # repair plane (block/repair_plan.py): plan state, backlog by
            # urgency class, progress counters, admission-control knobs
            return web.json_response(g.repair_plan_status())
        if path == "/v1/repair/plan/launch" and request.method == "POST":
            body = await request.json() if request.can_read_body else {}
            try:
                g.launch_repair_plan(fresh=bool(body.get("fresh")))
            except ValueError as e:
                # already running / replica codec: a client error, not a
                # server fault (mirrors the cancel endpoint's 400)
                return web.json_response({"error": str(e)}, status=400)
            return web.json_response(g.repair_plan_status())
        if path == "/v1/repair/plan/cancel" and request.method == "POST":
            p = g.repair_planner
            if p is None or p.finished:
                return web.json_response(
                    {"cancelled": False, "error": "no repair plan running"},
                    status=400,
                )
            p.cmd_cancel()
            return web.json_response({"cancelled": True})

        if path == "/v1/node" and request.method == "GET":
            # GetNodeInfo: the node answering the request (not the
            # cluster): identity, version, engine, data/metadata dirs.
            import sys as _sys

            return web.json_response(
                {
                    "nodeId": hex_of(g.node_id),
                    "garageVersion": "garage-tpu/0.1.0",
                    "garageFeatures": ["k2v", "erasure-coding", "tpu"],
                    "pythonVersion": _sys.version.split()[0],
                    "dbEngine": g.config.db_engine,
                    "metadataDir": g.config.metadata_dir,
                    "dataDirs": [d.path for d in g.config.data_dir],
                }
            )

        if path == "/v1/layout":
            if request.method == "GET":
                lay = g.layout_manager.history
                cur = lay.current()
                return web.json_response(
                    {
                        "version": cur.version,
                        "roles": [
                            {
                                "id": hex_of(n),
                                "zone": r.zone,
                                "capacity": r.capacity,
                                "tags": r.tags,
                            }
                            for n, r in cur.roles.items()
                        ],
                        "stagedRoleChanges": [
                            {"id": hex_of(bytes(k)), "role": v}
                            for k, v in lay.staging.roles.items()
                        ],
                    }
                )
            if request.method == "POST":
                body = await request.json()
                for change in body:
                    nid = bytes.fromhex(change["id"])
                    if change.get("remove"):
                        g.layout_manager.stage_role(nid, None)
                    else:
                        g.layout_manager.stage_role(
                            nid,
                            NodeRole(
                                zone=change["zone"],
                                capacity=change.get("capacity"),
                                tags=change.get("tags", []),
                            ),
                        )
                return web.json_response({"staged": len(body)})

        if path == "/v1/layout/apply" and request.method == "POST":
            body = await request.json() if request.can_read_body else {}
            lv, report = g.layout_manager.apply_staged(body.get("version"))
            warn = g.ec_layout_warning(lv)
            if warn:
                report = list(report) + [warn]
            return web.json_response({"version": lv.version, "report": report})
        if path == "/v1/layout/revert" and request.method == "POST":
            g.layout_manager.revert_staged()
            return web.json_response({"ok": True})

        if path == "/v1/bucket":
            if request.method == "GET":
                if "id" in request.query or "globalAlias" in request.query:
                    if "id" in request.query:
                        bid = bytes.fromhex(request.query["id"])
                    else:
                        bid = await g.helper.resolve_bucket(
                            request.query["globalAlias"]
                        )
                    return web.json_response(await self._bucket_info(bid))
                out = []
                for b in await g.helper.list_buckets():
                    out.append(
                        {
                            "id": hex_of(b.id),
                            "globalAliases": [
                                n for n, v in b.params().aliases.items() if v
                            ],
                        }
                    )
                return web.json_response(out)
            if request.method == "POST":
                body = await request.json()
                bid = await g.helper.create_bucket(body["globalAlias"])
                if body.get("localAlias"):
                    la = body["localAlias"]
                    await g.helper.set_local_alias(
                        bid, la["accessKeyId"], la["alias"]
                    )
                    if la.get("allow"):
                        perms = la["allow"]
                        await g.helper.set_bucket_key_permissions(
                            bid, la["accessKeyId"],
                            perms.get("read", False),
                            perms.get("write", False),
                            perms.get("owner", False),
                        )
                return web.json_response(await self._bucket_info(bid))
            if request.method == "PUT":
                # UpdateBucket (reference api/admin/bucket.rs
                # handle_update_bucket): website access + quotas
                bid = bytes.fromhex(request.query["id"])
                body = await request.json()
                b = await g.helper.get_bucket(bid)
                p = b.params()
                if "websiteAccess" in body:
                    wa = body["websiteAccess"]
                    if wa.get("enabled"):
                        p.website.update(
                            {
                                "index_document": wa.get("indexDocument", "index.html"),
                                "error_document": wa.get("errorDocument"),
                            }
                        )
                    else:
                        p.website.update(None)
                if "quotas" in body:
                    q = body["quotas"]
                    p.quotas.update(
                        {
                            "max_size": q.get("maxSize"),
                            "max_objects": q.get("maxObjects"),
                        }
                    )
                await g.bucket_table.insert(b)
                return web.json_response(await self._bucket_info(bid))
            if request.method == "DELETE":
                await g.helper.delete_bucket(bytes.fromhex(request.query["id"]))
                return web.json_response({"ok": True})

        if path in (
            "/v1/bucket/alias/global", "/v1/bucket/alias/local"
        ) and request.method in ("PUT", "DELETE"):
            q = request.query
            bid = bytes.fromhex(q["id"])
            alias = q["alias"]
            if path.endswith("global"):
                if request.method == "PUT":
                    await g.helper.set_global_alias(bid, alias)
                else:
                    await g.helper.unset_global_alias(bid, alias)
            else:
                if request.method == "PUT":
                    await g.helper.set_local_alias(bid, q["accessKeyId"], alias)
                else:
                    await g.helper.unset_local_alias(bid, q["accessKeyId"], alias)
            return web.json_response(await self._bucket_info(bid))

        if path in ("/v1/bucket/allow", "/v1/bucket/deny") and request.method == "POST":
            body = await request.json()
            perms = body.get("permissions", {})
            allow = path.endswith("allow")
            await g.helper.set_bucket_key_permissions(
                bytes.fromhex(body["bucketId"]),
                body["accessKeyId"],
                allow and perms.get("read", False),
                allow and perms.get("write", False),
                allow and perms.get("owner", False),
            )
            return web.json_response({"ok": True})

        if path == "/v1/key":
            if request.method == "GET":
                if "id" in request.query or "search" in request.query:
                    if "id" in request.query:
                        k = await g.helper.get_key(request.query["id"])
                    else:
                        pat = request.query["search"]
                        matches = [
                            k
                            for k in await g.helper.list_keys()
                            if k.key_id.startswith(pat)
                            or pat.lower() in (k.params().name.get() or "").lower()
                        ]
                        if len(matches) != 1:
                            return web.json_response(
                                {"error": f"{len(matches)} keys match"}, status=400
                            )
                        k = matches[0]
                    return web.json_response(
                        self._key_info(
                            k, request.query.get("showSecretKey") == "true"
                        )
                    )
                return web.json_response(
                    [
                        {"id": k.key_id, "name": k.params().name.get()}
                        for k in await g.helper.list_keys()
                    ]
                )
            if request.method == "POST":
                body = await request.json() if request.can_read_body else {}
                if "id" in request.query:
                    # UpdateKey (reference api/admin/key.rs handle_update_key)
                    k = await g.helper.update_key(
                        request.query["id"],
                        name=body.get("name"),
                        allow_create_bucket=(body.get("allow") or {}).get(
                            "createBucket"
                        )
                        if "allow" in body
                        else (
                            False
                            if (body.get("deny") or {}).get("createBucket")
                            else None
                        ),
                    )
                else:
                    k = await g.helper.create_key(body.get("name", ""))
                return web.json_response(self._key_info(k, True))
            if request.method == "DELETE":
                await g.helper.delete_key(request.query["id"])
                return web.json_response({"ok": True})

        if path == "/v1/key/import" and request.method == "POST":
            body = await request.json()
            k = await g.helper.import_key(
                body["accessKeyId"], body["secretAccessKey"], body.get("name", "")
            )
            return web.json_response(self._key_info(k, False))

        return web.json_response({"error": "no such endpoint"}, status=404)

    async def _bucket_info(self, bid: bytes) -> dict:
        """Full GetBucketInfo shape (reference api/admin/bucket.rs):
        aliases, per-key permissions, website/quotas, usage counters."""
        g = self.garage
        b = await g.helper.get_bucket(bid)
        p = b.params()
        keys = []
        for k in await g.helper.list_keys():
            kp = k.params()
            perm = k.bucket_permissions(bid)
            local = [
                n
                for n, v in kp.local_aliases.items()
                if v is not None and bytes(v) == bid
            ]
            if perm.allow_read or perm.allow_write or perm.allow_owner or local:
                keys.append(
                    {
                        "accessKeyId": k.key_id,
                        "name": kp.name.get(),
                        "permissions": {
                            "read": perm.allow_read,
                            "write": perm.allow_write,
                            "owner": perm.allow_owner,
                        },
                        "bucketLocalAliases": local,
                    }
                )
        counts = await g.object_counter.get_values(bid)
        website = p.website.get()
        quotas = p.quotas.get() or {}
        return {
            "id": hex_of(bid),
            "globalAliases": [n for n, v in p.aliases.items() if v],
            "websiteAccess": website is not None,
            "websiteConfig": website,
            "keys": keys,
            "objects": counts.get("objects", 0),
            "bytes": counts.get("bytes", 0),
            "unfinishedUploads": counts.get("unfinished_uploads", 0),
            "quotas": {
                "maxSize": quotas.get("max_size"),
                "maxObjects": quotas.get("max_objects"),
            },
        }

    def _key_info(self, k, show_secret: bool) -> dict:
        kp = k.params()
        return {
            "accessKeyId": k.key_id,
            "name": kp.name.get(),
            "secretAccessKey": k.secret() if show_secret else None,
            "permissions": {"createBucket": bool(kp.allow_create_bucket.get())},
            "buckets": [
                {
                    "id": hex_of(bytes(b)),
                    "permissions": perm,
                }
                for b, perm in kp.authorized_buckets.items()
            ],
        }
