"""Admin RPC: the operator control plane over the netapp mesh.

Reference src/garage/admin/mod.rs:38-88 — the CLI connects to the daemon
as an ephemeral authenticated peer and issues AdminRpc commands; the
daemon executes them against its Garage instance.  Ops are msgpack
["name", {args}] pairs on endpoint `admin/rpc`.
"""

from __future__ import annotations

import logging
from typing import Any

from ..net.message import Req, Resp
from ..rpc.layout.types import NodeRole
from ..utils.data import hex_of

logger = logging.getLogger("garage.admin")


def _probe_summary():
    from ..ops.telemetry import probe_failure_summary

    return probe_failure_summary()


class AdminRpcHandler:
    def __init__(self, garage):
        self.garage = garage
        ep = garage.netapp.endpoint("admin/rpc")
        ep.set_handler(self._handle)

    async def _handle(self, from_id: bytes, req: Req) -> Resp:
        op, args = req.body[0], req.body[1] or {}
        fn = getattr(self, f"op_{op.replace('-', '_')}", None)
        if fn is None:
            raise ValueError(f"unknown admin op {op!r}")
        return Resp(await fn(args))

    # --- cluster --------------------------------------------------------------

    async def op_status(self, args) -> Any:
        sysd = self.garage.system
        h = sysd.health()
        peers = []
        for pid, state in sysd.peering.peer_states().items():
            st = sysd.node_status.get(pid)
            peers.append(
                {
                    "id": hex_of(pid),
                    "state": state,
                    "hostname": st[0].hostname if st else "?",
                }
            )
        layout = self.garage.layout_manager.history
        cur = layout.current()
        roles = {
            hex_of(n): {
                "zone": r.zone,
                "capacity": r.capacity,
                "tags": r.tags,
            }
            for n, r in cur.roles.items()
        }
        return {
            "node_id": hex_of(sysd.id),
            "health": h.__dict__,
            "peers": peers,
            "layout_version": cur.version,
            "roles": roles,
            "staged": [
                [hex_of(bytes(k)), v]
                for k, v in layout.staging.roles.items()
            ],
        }

    async def op_connect(self, args) -> Any:
        nid = bytes.fromhex(args["node"])
        addr = (args["host"], int(args["port"]))
        await self.garage.netapp.connect(addr, nid)
        return "connected"

    # --- layout ---------------------------------------------------------------

    async def op_layout_assign(self, args) -> Any:
        node = bytes.fromhex(args["node"])
        if args.get("gateway"):
            role = NodeRole(zone=args["zone"], capacity=None, tags=args.get("tags", []))
        else:
            role = NodeRole(
                zone=args["zone"],
                capacity=int(args["capacity"]),
                tags=args.get("tags", []),
            )
        self.garage.layout_manager.stage_role(node, role)
        return "staged"

    async def op_layout_remove(self, args) -> Any:
        self.garage.layout_manager.stage_role(bytes.fromhex(args["node"]), None)
        return "staged removal"

    async def op_layout_apply(self, args) -> Any:
        lv, report = self.garage.layout_manager.apply_staged(args.get("version"))
        warn = self.garage.ec_layout_warning(lv)
        if warn:
            report = list(report) + [warn]
        return {"version": lv.version, "report": report}

    async def op_layout_revert(self, args) -> Any:
        self.garage.layout_manager.revert_staged()
        return "reverted"

    async def op_layout_show(self, args) -> Any:
        layout = self.garage.layout_manager.history
        cur = layout.current()
        return {
            "version": cur.version,
            "roles": {
                hex_of(n): [r.zone, r.capacity, r.tags]
                for n, r in cur.roles.items()
            },
            "staged": [
                [hex_of(bytes(k)), v] for k, v in layout.staging.roles.items()
            ],
            "partition_size": cur.partition_size,
        }

    async def op_layout_config(self, args) -> Any:
        """Stage layout parameters (reference cli layout config -r):
        zone_redundancy = "maximum" or an integer."""
        zr = args.get("zone_redundancy")
        if zr is None:
            raise ValueError("zone_redundancy required")
        from ..rpc.layout.types import ZoneRedundancy

        val = ZoneRedundancy.MAXIMUM if zr == "maximum" else int(zr)
        self.garage.layout_manager.local_update(
            lambda h: h.staging.parameters.update({"zone_redundancy": val})
        )
        return f"staged zone_redundancy = {zr}"

    async def op_layout_history(self, args) -> Any:
        """Layout version history + per-node update trackers (reference
        cli layout history)."""
        h = self.garage.layout_manager.history
        nodes = h.all_nodes()
        return {
            "current_version": h.current().version,
            "min_stored": h.min_stored(),
            "versions": [
                {
                    "version": v.version,
                    "status": "current" if v is h.current() else "draining",
                    "storage_nodes": len(v.storage_nodes()),
                    "gateway_nodes": len(v.all_nodes()) - len(v.storage_nodes()),
                }
                for v in h.versions
            ],
            "trackers": {
                hex_of(n): {
                    "ack": h.ack.get(n),
                    "sync": h.sync.get(n),
                    "sync_ack": h.sync_ack.get(n),
                }
                for n in nodes
            },
        }

    async def op_layout_skip_dead_nodes(self, args) -> Any:
        """Force dead nodes' trackers forward so a stuck layout transition
        can complete without them (reference cli layout skip-dead-nodes
        --version N [--allow-missing-data])."""
        version = args.get("version")
        allow_missing = bool(args.get("allow_missing_data"))
        lm = self.garage.layout_manager
        h = lm.history
        if version is None:
            version = h.current().version
        if version > h.current().version:
            raise ValueError(f"version {version} does not exist yet")
        skipped = []

        def mutate(hist):
            for n in hist.all_nodes():
                if self.garage.netapp.is_connected(n) or n == self.garage.node_id:
                    continue
                changed = hist.ack.set_max(n, version)
                if allow_missing:
                    changed = hist.sync.set_max(n, version) or changed
                    changed = hist.sync_ack.set_max(n, version) or changed
                if changed:
                    skipped.append(hex_of(n))

        lm.local_update(mutate)  # persists + gossips to connected peers
        return {"version": version, "skipped_nodes": skipped}

    # --- block operations (reference src/garage/cli block subcommands) --------

    async def op_block_list_errors(self, args) -> Any:
        from ..block.resync import unpack_error
        from ..utils.time_util import now_msec

        resync = self.garage.block_manager.resync
        out = []
        for h, v in resync.errors.iter_range():
            count, next_try, first = unpack_error(v)
            out.append(
                {
                    "hash": h.hex(),
                    "failures": count,
                    "next_try_in_secs": max(0, (next_try - now_msec()) // 1000),
                    # error AGE: transient blip vs stuck block (None for
                    # entries written before age tracking)
                    "age_secs": (
                        max(0, (now_msec() - first) // 1000)
                        if first is not None
                        else None
                    ),
                }
            )
        return out

    def _resolve_block_hash(self, prefix_hex: str) -> bytes:
        """Accept a full hash or an unambiguous hex prefix."""
        bm = self.garage.block_manager
        prefix = bytes.fromhex(
            prefix_hex if len(prefix_hex) % 2 == 0 else prefix_hex[:-1]
        )
        matches = []
        for h, _v in bm.rc.tree.iter_range(start=prefix):
            if not h.startswith(prefix):
                break
            if not h.hex().startswith(prefix_hex):
                continue  # odd-length prefix: half-byte mismatch, keep scanning
            matches.append(h)
            if len(matches) > 2:
                break
        if not matches:
            raise ValueError(f"no block with hash prefix {prefix_hex}")
        if len(matches) > 1:
            raise ValueError(f"ambiguous hash prefix {prefix_hex}")
        return matches[0]

    async def op_block_info(self, args) -> Any:
        g = self.garage
        bm = g.block_manager
        h = self._resolve_block_hash(args["hash"])
        refs = []
        truncated = False
        async for ref in self._iter_block_refs(h):
            if ref.deleted.get():
                continue
            if len(refs) >= 1000:
                truncated = True
                break
            ver = await g.version_table.get_local(bytes(ref.version), b"")
            refs.append(
                {
                    "version": bytes(ref.version).hex(),
                    "bucket_id": hex_of(ver.bucket_id) if ver else None,
                    "key": ver.key if ver else None,
                    "deleted": ver.deleted.get() if ver else None,
                }
            )
        from ..utils.serde import unpack

        err = bm.resync.errors.get(h)
        return {
            "hash": h.hex(),
            "refcount": bm.rc.get(h),
            "needed": bm.rc.is_needed(h),
            "stored_locally": bm.find_block_file(h) is not None
            or bool(bm.local_pieces(h)),
            "error_count": unpack(err)[0] if err else 0,
            "refs": refs,
            "refs_truncated": truncated,
        }

    async def _iter_block_refs(self, h: bytes):
        """Page through ALL local refs of a block (no silent 1000 cap)."""
        cursor = None
        while True:
            batch = await self.garage.block_ref_table.get_range_local(
                h, cursor, None, 1000
            )
            for ref in batch:
                yield ref
            if len(batch) < 1000:
                return
            cursor = bytes(batch[-1].version) + b"\x00"

    async def op_block_retry_now(self, args) -> Any:
        resync = self.garage.block_manager.resync
        if args.get("all"):
            hashes = [h for h, _v in resync.errors.iter_range()]
        else:
            hashes = [self._resolve_block_hash(args["hash"])]
        for h in hashes:
            resync.errors.remove(h)
            resync.queue_block(h)
        return f"{len(hashes)} blocks requeued for immediate resync"

    async def op_block_purge(self, args) -> Any:
        """Delete every object version referencing a block — the way out
        when a block is irrecoverably lost (reference block purge)."""
        if not args.get("yes"):
            raise ValueError("refusing to purge without yes=true")
        g = self.garage
        h = self._resolve_block_hash(args["hash"])
        from ..model.s3.object_table import Object, ObjectVersion, next_timestamp
        from ..model.s3.version_table import Version
        from ..utils.data import gen_uuid

        versions = objects = 0
        async for ref in self._iter_block_refs(h):
            if ref.deleted.get():
                continue
            ver = await g.version_table.get(bytes(ref.version), b"")
            if ver is None:
                continue
            if not ver.deleted.get():
                await g.version_table.insert(
                    Version.deleted_marker(ver.uuid, ver.bucket_id, ver.key)
                )
                versions += 1
            obj = await g.object_table.get(ver.bucket_id, ver.key.encode())
            if obj is not None and any(
                v.uuid == ver.uuid or v.data.get("vid") == ver.uuid
                for v in obj.versions
            ):
                dm = ObjectVersion(
                    gen_uuid(), next_timestamp(obj), "complete",
                    {"t": "delete_marker"},
                )
                await g.object_table.insert(
                    Object(ver.bucket_id, ver.key, [dm])
                )
                objects += 1
        return {"hash": h.hex(), "versions_deleted": versions, "objects_deleted": objects}

    # --- buckets --------------------------------------------------------------

    async def op_bucket_list(self, args) -> Any:
        out = []
        for b in await self.garage.helper.list_buckets():
            names = [n for n, v in b.params().aliases.items() if v]
            out.append({"id": hex_of(b.id), "aliases": names})
        return out

    async def op_bucket_create(self, args) -> Any:
        bid = await self.garage.helper.create_bucket(args["name"])
        return {"id": hex_of(bid)}

    async def op_bucket_delete(self, args) -> Any:
        bid = await self.garage.helper.resolve_bucket(args["name"])
        await self.garage.helper.delete_bucket(bid)
        return "deleted"

    async def op_bucket_info(self, args) -> Any:
        bid = await self.garage.helper.resolve_bucket(args["name"])
        b = await self.garage.helper.get_bucket(bid)
        p = b.params()
        return {
            "id": hex_of(bid),
            "aliases": [n for n, v in p.aliases.items() if v],
            "website": p.website.get(),
            "quotas": p.quotas.get(),
        }

    async def op_bucket_allow(self, args) -> Any:
        bid = await self.garage.helper.resolve_bucket(args["bucket"])
        await self.garage.helper.set_bucket_key_permissions(
            bid,
            args["key"],
            bool(args.get("read")),
            bool(args.get("write")),
            bool(args.get("owner")),
        )
        return "granted"

    async def op_bucket_deny(self, args) -> Any:
        bid = await self.garage.helper.resolve_bucket(args["bucket"])
        await self.garage.helper.set_bucket_key_permissions(
            bid, args["key"], False, False, False
        )
        return "revoked"

    async def op_bucket_website(self, args) -> Any:
        bid = await self.garage.helper.resolve_bucket(args["bucket"])
        b = await self.garage.helper.get_bucket(bid)
        if args.get("allow"):
            b.params().website.update(
                {
                    "index_document": args.get("index_document") or "index.html",
                    "error_document": args.get("error_document"),
                }
            )
        else:
            b.params().website.update(None)
        await self.garage.bucket_table.insert(b)
        return "website " + ("enabled" if args.get("allow") else "disabled")

    async def op_bucket_quota(self, args) -> Any:
        """Only the quotas present in `args` change; absent keys keep their
        current value (None clears one explicitly)."""
        bid = await self.garage.helper.resolve_bucket(args["bucket"])
        b = await self.garage.helper.get_bucket(bid)
        q = dict(b.params().quotas.get() or {})
        for field in ("max_size", "max_objects"):
            if field in args:
                q[field] = args[field]
        b.params().quotas.update(q)
        await self.garage.bucket_table.insert(b)
        return "quotas updated"

    async def op_bucket_alias(self, args) -> Any:
        bid = await self.garage.helper.resolve_bucket(args["bucket"])
        if args.get("local_key"):
            await self.garage.helper.set_local_alias(
                bid, args["local_key"], args["alias"]
            )
        else:
            await self.garage.helper.set_global_alias(bid, args["alias"])
        return "alias added"

    async def op_bucket_unalias(self, args) -> Any:
        bid = await self.garage.helper.resolve_bucket(args["bucket"])
        if args.get("local_key"):
            await self.garage.helper.unset_local_alias(
                bid, args["local_key"], args["alias"]
            )
        else:
            await self.garage.helper.unset_global_alias(bid, args["alias"])
        return "alias removed"

    # --- keys -----------------------------------------------------------------

    async def op_key_new(self, args) -> Any:
        key = await self.garage.helper.create_key(args.get("name", ""))
        if args.get("allow_create_bucket"):
            key.params().allow_create_bucket.update(True)
            await self.garage.key_table.insert(key)
        return {"key_id": key.key_id, "secret_key": key.secret()}

    async def op_key_list(self, args) -> Any:
        return [
            {"key_id": k.key_id, "name": k.params().name.get()}
            for k in await self.garage.helper.list_keys()
        ]

    async def op_key_info(self, args) -> Any:
        k = await self.garage.helper.get_key(args["key"])
        p = k.params()
        return {
            "key_id": k.key_id,
            "name": p.name.get(),
            "secret_key": p.secret_key if args.get("show_secret") else "(hidden)",
            "buckets": [
                hex_of(bytes(b)) for b, _perm in p.authorized_buckets.items()
            ],
        }

    async def op_key_delete(self, args) -> Any:
        await self.garage.helper.delete_key(args["key"])
        return "deleted"

    async def op_key_import(self, args) -> Any:
        k = await self.garage.helper.import_key(
            args["key_id"], args["secret"], args.get("name", "")
        )
        return {"key_id": k.key_id}

    async def op_key_set(self, args) -> Any:
        k = await self.garage.helper.update_key(
            args["key"],
            name=args.get("name"),
            allow_create_bucket=args.get("allow_create_bucket"),
        )
        return {
            "key_id": k.key_id,
            "name": k.params().name.get(),
            "allow_create_bucket": bool(k.params().allow_create_bucket.get()),
        }

    # --- workers / repair -----------------------------------------------------

    async def op_worker_list(self, args) -> Any:
        return [
            {
                "id": wid,
                "name": info.name,
                "state": info.state,
                "errors": info.errors,
                "consecutive_errors": info.consecutive_errors,
                "last_error": info.last_error,
                "tranquility": info.tranquility,
                "iterations": info.iterations,
                "last_duration_secs": info.last_duration_secs,
                "duration_ewma_secs": info.duration_ewma_secs,
                "throughput": info.throughput,
                "last_completed": info.last_completed,
                "info": info.progress,
            }
            for wid, info in self.garage.bg.worker_info().items()
        ]

    async def op_worker_get(self, args) -> Any:
        if args.get("var"):
            return {args["var"]: self.garage.bg_vars.get(args["var"])}
        return self.garage.bg_vars.all()

    async def op_worker_set(self, args) -> Any:
        self.garage.bg_vars.set(args["var"], args["value"])
        return {args["var"]: self.garage.bg_vars.get(args["var"])}

    async def op_repair(self, args) -> Any:
        what = args.get("what", "blocks")
        from ..block.repair import RebalanceWorker, RepairWorker
        from ..model.repair import (
            BlockRefRepairWorker,
            MpuRepairWorker,
            VersionRepairWorker,
        )

        if what == "blocks":
            self.garage.bg.spawn(RepairWorker(self.garage.block_manager))
        elif what == "rebalance":
            self.garage.bg.spawn(RebalanceWorker(self.garage.block_manager))
        elif what == "tables":
            for t in self.garage.tables:
                await t.syncer.sync_all_partitions()
        elif what == "versions":
            self.garage.bg.spawn(VersionRepairWorker(self.garage))
        elif what == "mpu":
            self.garage.bg.spawn(MpuRepairWorker(self.garage))
        elif what == "block-refs":
            self.garage.bg.spawn(BlockRefRepairWorker(self.garage))
        elif what == "scrub":
            sw = getattr(self.garage.block_manager, "scrub_worker", None)
            if sw is None:
                raise ValueError("scrub worker not running")
            cmd = args.get("cmd", "start")
            if cmd == "start":
                sw.cmd_start()
            elif cmd == "pause":
                sw.cmd_pause()
            elif cmd == "resume":
                sw.cmd_resume()
            elif cmd == "cancel":
                sw.cmd_cancel()
            elif cmd == "set-tranquility":
                sw.cmd_set_tranquility(int(args["value"]))
            else:
                raise ValueError(f"unknown scrub command {cmd!r}")
            return {"scrub": sw.status()}
        elif what == "plan":
            # repair plane (block/repair_plan.py): status/launch/cancel
            cmd = args.get("cmd", "status")
            if cmd == "status":
                return self.garage.repair_plan_status()
            if cmd == "launch":
                self.garage.launch_repair_plan(fresh=bool(args.get("fresh")))
                return self.garage.repair_plan_status()
            if cmd == "cancel":
                p = self.garage.repair_planner
                if p is None or p.finished:
                    raise ValueError("no repair plan running")
                p.cmd_cancel()
                return "repair plan cancelled"
            raise ValueError(f"unknown plan command {cmd!r}")
        else:
            raise ValueError(f"unknown repair target {what!r}")
        return f"repair {what} launched"

    # --- flight recorder (debug profile/slow, utils/flight.py) ----------------

    async def op_debug_profile(self, args) -> Any:
        from ..utils import flight

        prof = await flight.profile(
            args.get("seconds") or 2.0, hz=args.get("hz") or 100
        )
        out: dict[str, Any] = {"samples": prof.samples}
        if args.get("format") == "speedscope":
            out["speedscope"] = prof.speedscope()
        else:
            out["folded"] = prof.folded()
        return out

    async def op_debug_slow(self, args) -> Any:
        from ..utils import flight

        return flight.slow_response(getattr(self.garage, "flight_recorder", None))

    async def op_debug_latency(self, args) -> Any:
        from ..utils.latency import latency_response

        return latency_response()

    async def op_meta_snapshot(self, args) -> Any:
        from ..model.snapshot import take_snapshot

        return {"snapshot": take_snapshot(self.garage)}

    async def op_stats(self, args) -> Any:
        g = self.garage
        return {
            "db_engine": g.db.engine,
            "tables": {
                t.schema.table_name: {
                    "entries": len(t.data.store),
                    "merkle_todo": len(t.data.merkle_todo),
                    "gc_todo": len(t.data.gc_todo),
                }
                for t in g.tables
            },
            "blocks": {
                "rc_entries": len(g.block_manager.rc.tree),
                "resync_queue": g.block_manager.resync.queue_len(),
                "resync_errors": g.block_manager.resync.errors_len(),
            },
            # local telemetry digest (rpc/telemetry_digest.py) — the same
            # row this node gossips to its peers
            "telemetry": g.telemetry.collect(),
            # banked device-probe failure: always null on the port,
            # which banks no probe profile
            "tpuProbe": _probe_summary(),
        }

    async def op_overload_status(self, args) -> Any:
        """Overload-control plane state (admission + shedding ladder) —
        `cli overload status`."""
        return self.garage.overload_status()

    async def op_cluster_telemetry(self, args) -> Any:
        """The cluster rollup (per-node digests + aggregates + outliers
        + SLO) over the admin mesh — `cluster top` / `cluster telemetry`."""
        from ..rpc.telemetry_digest import rollup

        return rollup(self.garage)

    async def op_durability(self, args) -> Any:
        """Durability observatory (block/durability.py): redundancy
        ledger + zone exposure + repair ETA — `cluster durability`."""
        from ..block.durability import durability_response

        return durability_response(self.garage)

    async def op_codec(self, args) -> Any:
        """Codec X-ray (ops/telemetry.py): per-kernel pad accounting,
        compile events, overlap efficiency, lane linger + the cluster
        view from the gossiped codec.* keys — `cluster codec` /
        `codec top`."""
        from ..rpc.telemetry_digest import codec_response

        return codec_response(self.garage)

    async def op_transition(self, args) -> Any:
        """Rebalance observatory (rpc/transition.py): layout-transition
        flight deck + cluster version spread — `cluster transition`."""
        from ..rpc.transition import transition_response

        return transition_response(self.garage)

    async def op_cluster_events(self, args) -> Any:
        """Federated event timeline (rpc/transition.py): skew-corrected
        merge of every node's flight events — `cluster events`."""
        from ..rpc.transition import cluster_events_response

        return await cluster_events_response(
            self.garage,
            since=float(args.get("since") or 0.0),
            min_severity=str(args.get("min_severity") or "info"),
        )

    async def op_tenants(self, args) -> Any:
        """Tenant observatory (rpc/tenant.py): cluster-summed per-tenant
        consumption, fairness stats, per-tenant SLO burn — `cluster
        tenants`."""
        from ..rpc.tenant import tenants_response

        return tenants_response(self.garage)

    async def op_traffic(self, args) -> Any:
        """Traffic observatory (rpc/traffic.py): hot objects/buckets,
        op mix, skew, slow-peer ranking, cluster rollup — `cluster hot`."""
        from ..rpc.traffic import traffic_response

        return traffic_response(self.garage)

    async def op_traffic_profile(self, args) -> Any:
        """Replayable workload profile — `cluster hot --profile`."""
        from ..rpc.traffic import profile_response

        return profile_response(self.garage)
