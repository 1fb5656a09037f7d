"""garage-tpu CLI + daemon (reference src/garage/main.rs + cli/).

    python -m garage_tpu_torch.cli server -c garage.toml
    python -m garage_tpu_torch.cli -c garage.toml status
    python -m garage_tpu_torch.cli -c garage.toml node id
    python -m garage_tpu_torch.cli -c garage.toml layout assign <node> -z dc1 -c 100G
    python -m garage_tpu_torch.cli -c garage.toml layout apply / show / revert
    python -m garage_tpu_torch.cli -c garage.toml bucket create/list/info/delete/allow/deny
    python -m garage_tpu_torch.cli -c garage.toml key new/list/info/delete
    python -m garage_tpu_torch.cli -c garage.toml worker list
    python -m garage_tpu_torch.cli -c garage.toml repair blocks|rebalance|tables
    python -m garage_tpu_torch.cli -c garage.toml stats

Non-server commands connect to the running daemon as an ephemeral
authenticated peer (reference main.rs:281-324) and issue AdminRpc ops.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import time

from ..format_table import format_table
from ..model.garage import Garage, _parse_addr, network_key_from_secret
from ..net.handshake import gen_node_key
from ..net.netapp import NetApp
from ..utils.config import read_config


def main(argv=None):
    ap = argparse.ArgumentParser(prog="garage-tpu")
    ap.add_argument(
        "-c", "--config",
        default=os.environ.get("GARAGE_CONFIG_FILE", "/etc/garage.toml"),
    )
    ap.add_argument("--json", action="store_true", help="raw JSON output")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("server", help="run the storage daemon")
    sub.add_parser("status")
    sub.add_parser("stats")
    node = sub.add_parser("node")
    node.add_argument("node_cmd", choices=["id", "connect"])
    node.add_argument("arg", nargs="?")

    lay = sub.add_parser("layout")
    lay_sub = lay.add_subparsers(dest="layout_cmd", required=True)
    asg = lay_sub.add_parser("assign")
    asg.add_argument("node")
    asg.add_argument("-z", "--zone", required=True)
    asg.add_argument("-s", "--capacity", help="e.g. 100G (omit for gateway)")
    asg.add_argument("-g", "--gateway", action="store_true")
    asg.add_argument("-t", "--tags", nargs="*", default=[])
    rmv = lay_sub.add_parser("remove")
    rmv.add_argument("node")
    app = lay_sub.add_parser("apply")
    app.add_argument("--version", type=int)
    lay_sub.add_parser("show")
    lay_sub.add_parser("revert")
    lcfg = lay_sub.add_parser("config")
    lcfg.add_argument(
        "-r", "--zone-redundancy", required=True,
        help='"maximum" or an integer number of distinct zones per partition',
    )
    lay_sub.add_parser("history")
    skd = lay_sub.add_parser("skip-dead-nodes")
    skd.add_argument("--version", type=int)
    skd.add_argument(
        "--allow-missing-data", action="store_true",
        help="also mark dead nodes as synced (data they held is abandoned)",
    )

    blk = sub.add_parser("block")
    blk_sub = blk.add_subparsers(dest="block_cmd", required=True)
    blk_sub.add_parser("list-errors")
    binf = blk_sub.add_parser("info")
    binf.add_argument("hash")
    brn = blk_sub.add_parser("retry-now")
    brn.add_argument("hash", nargs="?")
    brn.add_argument("--all", action="store_true")
    bpg = blk_sub.add_parser("purge")
    bpg.add_argument("hash")
    bpg.add_argument("--yes", action="store_true", required=True)

    bkt = sub.add_parser("bucket")
    bkt_sub = bkt.add_subparsers(dest="bucket_cmd", required=True)
    for c in ["create", "delete", "info"]:
        p = bkt_sub.add_parser(c)
        p.add_argument("name")
    bkt_sub.add_parser("list")
    alw = bkt_sub.add_parser("allow")
    alw.add_argument("bucket")
    alw.add_argument("--key", required=True)
    alw.add_argument("--read", action="store_true")
    alw.add_argument("--write", action="store_true")
    alw.add_argument("--owner", action="store_true")
    dny = bkt_sub.add_parser("deny")
    dny.add_argument("bucket")
    dny.add_argument("--key", required=True)
    web_p = bkt_sub.add_parser("website")
    web_p.add_argument("bucket")
    grp = web_p.add_mutually_exclusive_group(required=True)
    grp.add_argument("--allow", action="store_true")
    grp.add_argument("--deny", action="store_true")
    web_p.add_argument("--index-document", default="index.html")
    web_p.add_argument("--error-document")
    quo = bkt_sub.add_parser("quota")
    quo.add_argument("bucket")
    quo.add_argument("--max-size", help="bytes or 100G etc; 'none' clears")
    quo.add_argument("--max-objects", help="count; 'none' clears")
    ali = bkt_sub.add_parser("alias")
    ali.add_argument("bucket")
    ali.add_argument("alias")
    ali.add_argument("--local", help="key id: make a key-local alias")
    una = bkt_sub.add_parser("unalias")
    una.add_argument("bucket")
    una.add_argument("alias")
    una.add_argument("--local", help="key id: remove a key-local alias")

    key = sub.add_parser("key")
    key_sub = key.add_subparsers(dest="key_cmd", required=True)
    knew = key_sub.add_parser("new")
    knew.add_argument("--name", default="")
    knew.add_argument("--allow-create-bucket", action="store_true")
    key_sub.add_parser("list")
    kinf = key_sub.add_parser("info")
    kinf.add_argument("key")
    kinf.add_argument("--show-secret", action="store_true")
    kdel = key_sub.add_parser("delete")
    kdel.add_argument("key")
    kimp = key_sub.add_parser("import")
    kimp.add_argument("key_id")
    kimp.add_argument("secret")
    kimp.add_argument("--name", default="imported")
    kset = key_sub.add_parser("set")
    kset.add_argument("key")
    kset.add_argument("--name")
    acb = kset.add_mutually_exclusive_group()
    acb.add_argument("--allow-create-bucket", action="store_true", default=None)
    acb.add_argument("--deny-create-bucket", action="store_true", default=None)

    clu = sub.add_parser(
        "cluster", help="cluster-wide telemetry from the gossiped digests"
    )
    clu_sub = clu.add_subparsers(dest="cluster_cmd", required=True)
    ctop = clu_sub.add_parser(
        "top", help="live per-node table (any node answers for all)"
    )
    ctop.add_argument(
        "-n", "--interval", type=float, default=2.0,
        help="refresh interval in seconds",
    )
    ctop.add_argument(
        "--once", action="store_true", help="render one frame and exit"
    )
    clu_sub.add_parser("telemetry", help="raw cluster rollup JSON")
    chot = clu_sub.add_parser(
        "hot", help="traffic observatory: hot objects/buckets, op mix, "
        "slow peers (rpc/traffic.py)",
    )
    chot.add_argument(
        "--profile", action="store_true",
        help="print the replayable workload profile JSON instead",
    )
    chot.add_argument(
        "--top", type=int, default=10, help="hot-object rows to show"
    )
    clu_sub.add_parser(
        "durability",
        help="redundancy ledger: blocks by class, zone-loss exposure, "
        "repair ETA (block/durability.py)",
    )
    clu_sub.add_parser(
        "codec",
        help="codec X-ray: dispatch pad waste, compile events, overlap "
        "efficiency, batcher lane linger (ops/telemetry.py)",
    )
    clu_sub.add_parser(
        "transition",
        help="rebalance observatory: layout-transition flight deck, "
        "version spread, per-pair bytes moved (rpc/transition.py)",
    )
    cten = clu_sub.add_parser(
        "tenants",
        help="tenant observatory: cluster-summed per-tenant consumption, "
        "SLO burn, fairness (rpc/tenant.py)",
    )
    cten.add_argument(
        "--sort", choices=["ops", "rps", "bytes", "shed", "burn"],
        default="ops", help="cluster tenant table sort key",
    )
    cten.add_argument(
        "--top", type=int, default=10, help="tenant rows to show"
    )
    cev = clu_sub.add_parser(
        "events",
        help="federated cluster event timeline: every node's flight "
        "events merged skew-corrected (rpc/transition.py)",
    )
    cev.add_argument(
        "--since", type=float, default=0.0,
        help="only events after this epoch timestamp (seconds)",
    )
    cev.add_argument(
        "--min-severity", choices=["info", "warn", "critical"],
        default="info", help="severity floor for the timeline",
    )
    cev.add_argument(
        "--follow", action="store_true",
        help="poll and stream new events until interrupted",
    )
    cev.add_argument(
        "-n", "--interval", type=float, default=2.0,
        help="poll interval in seconds with --follow",
    )

    cdx = sub.add_parser(
        "codec", help="codec X-ray: local accelerator dispatch economics"
    )
    cdx_sub = cdx.add_subparsers(dest="codec_cmd", required=True)
    cdx_sub.add_parser(
        "top", help="per-kernel breakdown: pad waste, overlap, compile cost, "
        "batcher lane linger",
    )

    ovl = sub.add_parser(
        "overload", help="overload-control plane: admission + shedding ladder"
    )
    ovl.add_argument("overload_cmd", choices=["status"])

    wrk = sub.add_parser("worker")
    wrk.add_argument("worker_cmd", choices=["list", "get", "set"])
    wrk.add_argument("var", nargs="?")
    wrk.add_argument("value", nargs="?")

    dbg = sub.add_parser("debug", help="flight recorder: node self-diagnostics")
    dbg_sub = dbg.add_subparsers(dest="debug_cmd", required=True)
    dpr = dbg_sub.add_parser(
        "profile", help="sample the daemon's stacks (folded/speedscope)"
    )
    dpr.add_argument("--seconds", type=float, default=2.0)
    dpr.add_argument("--hz", type=int, default=100)
    dpr.add_argument(
        "--speedscope", action="store_true",
        help="emit speedscope JSON instead of folded stacks",
    )
    dpr.add_argument("-o", "--output", help="write to a file instead of stdout")
    dbg_sub.add_parser("slow", help="slowest recent requests (span trees)")
    dbg_sub.add_parser(
        "latency",
        help="latency X-ray: rolling per-phase waterfall per S3 op",
    )
    rep = sub.add_parser("repair")
    rep.add_argument(
        "what",
        choices=["blocks", "rebalance", "tables", "versions", "mpu",
                 "block-refs", "scrub", "plan"],
    )
    rep.add_argument(
        "sub_cmd", nargs="?",
        choices=["start", "pause", "resume", "cancel", "set-tranquility",
                 "status", "launch"],
        help="scrub: start|pause|resume|cancel|set-tranquility; "
             "plan: status|launch|cancel",
    )
    rep.add_argument("sub_value", nargs="?")
    rep.add_argument(
        "--fresh", action="store_true",
        help="plan launch: discard a checkpointed plan and rescan",
    )
    meta = sub.add_parser("meta")
    meta.add_argument("meta_cmd", choices=["snapshot"])
    cdb = sub.add_parser("convert-db", help="copy the metadata db between engines")
    cdb.add_argument("--input", required=True, help="src db path")
    cdb.add_argument("--input-engine", default="sqlite")
    cdb.add_argument("--output", required=True, help="dst db path")
    cdb.add_argument("--output-engine", default="sqlite")
    orep = sub.add_parser(
        "offline-repair", help="run repairs without a running daemon"
    )
    orep.add_argument("what", choices=["tables", "blocks", "rebalance"])

    args = ap.parse_args(argv)

    from ..utils.log_fmt import setup_logging

    # trace-correlated logging (utils/log_fmt.py): every record under an
    # active span carries its trace/span ids; GARAGE_LOG_FORMAT=json for
    # JSON lines.  run_server re-applies this once the config is read.
    setup_logging(
        fmt=os.environ.get("GARAGE_LOG_FORMAT", "text"),
        level=os.environ.get("GARAGE_LOG", "INFO"),
    )

    if args.cmd == "server":
        return asyncio.run(run_server(args.config))
    if args.cmd == "convert-db":
        return convert_db(args)
    if args.cmd == "offline-repair":
        return asyncio.run(offline_repair(args))
    return asyncio.run(run_cli(args))


def convert_db(args) -> None:
    """Copy every tree between db engines (reference cli/convert_db.rs)."""
    from ..db import open_db

    src = open_db(args.input, engine=args.input_engine)
    dst = open_db(args.output, engine=args.output_engine, fsync=False)
    total = 0
    for name in src.list_trees():
        st, dt = src.open_tree(name), dst.open_tree(name)
        n = 0
        batch: list[tuple[bytes, bytes]] = []

        def flush(items=None):
            items = batch if items is None else items
            if items:
                dst.transaction(
                    lambda tx: [tx.insert(dt, k, v) for k, v in items] and None
                )
                items.clear()

        for k, v in st.iter_range():
            batch.append((k, v))
            n += 1
            if len(batch) >= 1000:
                flush()
        flush()
        total += n
        print(f"  {name}: {n} entries")
    src.close()
    dst.close()
    print(f"converted {total} entries")


async def offline_repair(args) -> None:
    """Boot Garage WITHOUT network servers and run a repair pass
    (reference src/garage/repair/offline.rs:11-40)."""
    from ..block.repair import RebalanceWorker, RepairWorker
    from ..utils.background import WorkerState

    config = read_config(args.config)
    garage = Garage(config)
    # no garage.start(): no listener, no peering — local-only repairs
    try:
        if args.what == "tables":
            for t in garage.tables:
                # rebuild merkle trees from scratch locally, chunked into
                # batched transactions (2 commits per 100 items, not 2
                # commits per item — a large backlog would otherwise pay
                # millions of journal round-trips)
                todo = list(t.data.merkle_todo.iter_range())
                for i in range(0, len(todo), 100):
                    chunk = todo[i : i + 100]
                    t.merkle.update_batch(chunk)
                    t.data.db.transaction(
                        lambda tx, c=chunk: [
                            tx.remove(t.data.merkle_todo, key)
                            for key, _vh in c
                        ]
                        and None
                    )
                print(f"{t.schema.table_name}: {len(todo)} merkle items")
        else:
            w = (
                RepairWorker(garage.block_manager)
                if args.what == "blocks"
                else RebalanceWorker(garage.block_manager)
            )
            while await w.work() != WorkerState.DONE:
                pass
            # replica-mode repair enqueues into the resync queue: drain it
            # here (no background workers run offline); peers are
            # unreachable, so only local work (deletes, verifies) succeeds
            # and the rest stays queued for the next daemon start
            drained = 0
            while await garage.block_manager.resync.resync_iter():
                drained += 1
            print(
                f"offline {args.what} repair done: {w.status()}, "
                f"{drained} resync items processed "
                f"({garage.block_manager.resync.queue_len()} left for the "
                "running daemon)"
            )
    finally:
        # graft-lint: allow-cancel(one-shot CLI: process exits right after; a ctrl-C mid-teardown is an acceptable partial stop)
        await garage.stop()


async def run_server(config_path: str) -> None:
    """Daemon boot (reference src/garage/server.rs:30)."""
    from ..api.s3.api_server import S3ApiServer
    from .admin_rpc import AdminRpcHandler

    config = read_config(config_path)
    if "GARAGE_LOG_FORMAT" not in os.environ:
        from ..utils.log_fmt import setup_logging

        setup_logging(
            fmt=config.log_format, level=os.environ.get("GARAGE_LOG", "INFO")
        )
    garage = Garage(config)
    await garage.start()
    AdminRpcHandler(garage)
    garage.spawn_workers()

    servers = []
    if config.s3_api.api_bind_addr:
        s3 = S3ApiServer(garage)
        host, port = _parse_addr(config.s3_api.api_bind_addr)
        await s3.start(host, port)
        servers.append(s3)
        if config.admin.canary_enabled:
            # canary prober (api/s3/canary.py): probe through this
            # node's own S3 frontend; a wildcard bind probes loopback
            probe_host = host if host not in ("0.0.0.0", "::") else "127.0.0.1"
            bound_port = s3.runner.addresses[0][1]
            garage.spawn_canary(f"http://{probe_host}:{bound_port}")
    if config.k2v_api.api_bind_addr:
        from ..api.k2v.api_server import K2VApiServer

        k2v = K2VApiServer(garage)
        host, port = _parse_addr(config.k2v_api.api_bind_addr)
        await k2v.start(host, port)
        servers.append(k2v)
    if config.s3_web.bind_addr:
        from ..web.web_server import WebServer

        webs = WebServer(garage)
        host, port = _parse_addr(config.s3_web.bind_addr)
        await webs.start(host, port)
        servers.append(webs)
    if config.admin.api_bind_addr:
        from ..api.admin.api_server import AdminApiServer

        adm = AdminApiServer(garage)
        host, port = _parse_addr(config.admin.api_bind_addr)
        await adm.start(host, port)
        servers.append(adm)

    print(f"garage-tpu node {garage.node_id.hex()} up", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    print("shutting down...", flush=True)
    for s in servers:
        await s.stop()
    await garage.stop()


async def run_cli(args) -> None:
    config = read_config(args.config)
    if args.cmd == "node" and args.node_cmd == "id":
        # local: read the node key from metadata_dir
        from ..net.handshake import node_id_of

        # graft-lint: allow-blocking(one-shot CLI command, loop not shared)
        with open(os.path.join(config.metadata_dir, "node_key"), "rb") as f:
            nid = node_id_of(f.read())
        addr = config.rpc_public_addr or config.rpc_bind_addr
        print(f"{nid.hex()}@{addr}")
        return

    # connect to the daemon as an ephemeral peer
    network_key = network_key_from_secret(config.rpc_secret)
    app = NetApp(network_key, gen_node_key())
    addr = _parse_addr(config.rpc_public_addr or config.rpc_bind_addr)
    if addr[0] == "0.0.0.0":
        addr = ("127.0.0.1", addr[1])
    daemon_id = await app.connect(addr)
    ep = app.endpoint("admin/rpc")

    async def call(op, op_args=None):
        resp = await ep.call(daemon_id, [op, op_args or {}], timeout=120.0)
        return resp.body

    try:
        out = await dispatch(args, call, config)
        if out is not None:
            print(out)
    finally:
        # graft-lint: allow-cancel(one-shot CLI: process exits right after; a ctrl-C mid-teardown is an acceptable partial stop)
        await app.shutdown()


def _ms(secs) -> str:
    return "-" if secs is None else f"{float(secs) * 1000:.1f}ms"


def _render_cluster_top(r: dict) -> str:
    """One frame of `cluster top`: cluster header + SLO line + one row
    per node from the gossiped digests (rpc/telemetry_digest.py)."""
    h = r.get("clusterHealth") or {}
    agg = r.get("aggregate") or {}
    outliers = r.get("outliers") or {}
    head = [
        f"cluster health\t{h.get('status', '?')}",
        f"nodes\t{h.get('connected_nodes', '?')}/{h.get('known_nodes', '?')}"
        f" connected, {r.get('nodesReporting', 0)} reporting digests",
        f"s3\t{agg.get('s3RequestsPerSec', 0):.2f} req/s, "
        f"{agg.get('s3ErrorsPerSec', 0):.2f} 5xx/s",
        f"backlogs\tresync {agg.get('resyncQueue', 0):g}, "
        f"repair {agg.get('repairBacklog', 0):g}",
        f"outliers\t{', '.join(o[:16] for o in sorted(outliers)) or '(none)'}",
    ]
    slo = r.get("slo")
    if slo:
        head.append(
            "slo budget\t"
            f"avail {slo['availability']['budgetRemaining'] * 100:.1f}% "
            f"(burn {slo['availability']['burnRate']:.2f}), "
            f"p99 {slo['latencyP99']['budgetRemaining'] * 100:.1f}% "
            f"(burn {slo['latencyP99']['burnRate']:.2f})"
        )
    # metadata plane: the answering node's effective meta
    # quorums; per-node disagreement is flagged META-RF! in the rows
    self_meta = next(
        (
            (n.get("digest") or {}).get("meta")
            for n in r.get("nodes", [])
            if n.get("isSelf") and (n.get("digest") or {}).get("meta")
        ),
        None,
    )
    if self_meta:
        head.append(
            f"meta quorums\trf {self_meta.get('rf')} "
            f"(read {self_meta.get('rq')} / write {self_meta.get('wq')})"
        )
    # codec X-ray: cluster dispatch economics at a glance —
    # worst-node pad waste and the cluster compile burden
    if agg.get("codecDispatches"):
        cpw = agg.get("codecPadWasteWorst")
        head.append(
            f"codec\t{agg.get('codecDispatches', 0):g} dispatches, "
            f"pad waste {'-' if cpw is None else f'{cpw * 100:.1f}%'} worst, "
            f"{agg.get('codecCompileEvents', 0):g} compiles "
            f"({agg.get('codecCompileSeconds', 0):g}s)"
        )
    # rebalance observatory (rpc/transition.py): version spread + how
    # many nodes see an open transition, from the gossiped lt.* keys
    if agg.get("layoutVersionSpread") or agg.get("layoutNodesInTransition"):
        skw = agg.get("clockSkewWorstMs")
        head.append(
            f"layout\tversion spread {agg.get('layoutVersionSpread', 0):g}, "
            f"{agg.get('layoutNodesInTransition', 0):g} node(s) in "
            "transition, worst skew "
            f"{'-' if skw is None else f'{skw:.0f}ms'}"
        )
    # tenant observatory (rpc/tenant.py): cluster-wide worst tenant
    # share vs the fair-share-multiple knob — the `cluster tenants`
    # one-liner (the per-tenant table lives behind `cluster tenants`)
    hog_share = agg.get("tenantHogShare")
    hog_warn = agg.get("tenantHogShareWarn") or 3.0
    if hog_share is not None:
        n_ten = agg.get("tenantsSeen") or 0
        fair = 1.0 / n_ten if n_ten else 0.0
        line = (
            f"tenants\t{n_ten:g} seen, worst cluster share "
            f"{hog_share * 100:.1f}%"
        )
        if n_ten >= 2 and fair and hog_share > hog_warn * fair:
            line += (
                f" HOG! (> {hog_warn:g}x fair share {fair * 100:.1f}%)"
            )
        head.append(line)
    # device-probe verdict: the answering node's banked probe failure,
    # if any.  The port banks none (ops/telemetry.probe_failure_summary
    # returns None), so this line never prints on a port node
    probe = r.get("tpuProbe")
    if probe:
        head.append(
            f"tpu probe\t{probe.get('result')} at "
            f"{probe.get('wedgedAt') or '-'} (rc {probe.get('rc')}"
            + (", timeout" if probe.get("timedOut") else "")
            + f", banked {probe.get('utc')})"
        )
    out = format_table(head) + "\n\n"
    skew_warn = agg.get("clockSkewWarnMs") or 250.0
    rows = [
        "id\thost\tup\tage\treq/s\t5xx/s\tp99\tlag99\tresyncq\tbrk\tcnry"
        "\thot\thog\tlayv\tflags"
    ]
    for n in r.get("nodes", []):
        d = n.get("digest") or {}
        s3 = d.get("s3") or {}
        cn = d.get("canary") or {}
        flags = []
        if n.get("isSelf"):
            flags.append("self")
        if n["id"] in outliers:
            flags.append("OUTLIER")
        if not d:
            flags.append("no-digest")
        # overload-control plane: a node above ladder level 0 is
        # degrading background planes / shedding admission tiers
        lvl = (d.get("ovl") or {}).get("lvl") or 0
        if lvl:
            flags.append(f"SHED-L{lvl}")
        # recency, not history: flag the LAST cycle's verdict — a single
        # transient failed leg must not mark a recovered node forever
        if cn.get("ok") == 0:
            flags.append("CANARY-FAIL")
        # a node whose effective meta RF disagrees with this node's is
        # misconfigured (or mid-rollout): its table quorums won't match
        nm = d.get("meta")
        if self_meta and nm and nm.get("rf") != self_meta.get("rf"):
            flags.append(f"META-RF={nm.get('rf')}!")
        # rebalance observatory: the node's acked layout version ("*"
        # while it still sees 2+ active versions); SKEW! when its clock
        # offset exceeds the threshold — past that, the merged event
        # timeline's ordering is not trustworthy
        lt = d.get("lt") or {}
        sk = lt.get("sk")
        if sk is not None and abs(sk) > skew_warn:
            flags.append("SKEW!")
        layv = (
            f"v{lt.get('ack')}" + ("*" if (lt.get("act") or 0) >= 2 else "")
            if lt.get("ack") is not None
            else "-"
        )
        # canary column: probe p99 + cumulative failures, "-" when the
        # node runs no prober (or hasn't probed yet)
        cnry = (
            f"{_ms(cn.get('p99'))}/{cn.get('err', 0):g}"
            if cn.get("ops")
            else "-"
        )
        # traffic observatory: the node's hottest bucket by (decayed)
        # ops from the gossiped trf digest — skew is visible without
        # touching the admin API
        trf = d.get("trf") or {}
        hot = str(trf.get("hb") or "-")[:14]
        # tenant observatory: the node's busiest-tenant ops share, with
        # a HOG! flag when it exceeds the fair-share multiple of the
        # node's own tracked-tenant count (the cluster-wide verdict is
        # the head line / `cluster tenants`)
        tn = d.get("tn") or {}
        top1 = tn.get("top1") or 0.0
        trk = tn.get("trk") or 0
        hog_col = f"{float(top1) * 100:.0f}%" if top1 else "-"
        if trk >= 2 and top1 and float(top1) > hog_warn * (1.0 / trk):
            flags.append("HOG!")
        rows.append(
            f"{n['id'][:16]}\t{n.get('hostname', '?')}\t"
            f"{'y' if n.get('isUp') else 'n'}\t{n.get('ageSecs', 0):.0f}s\t"
            f"{s3.get('rps', 0):.1f}\t{s3.get('eps', 0):.1f}\t"
            f"{_ms(s3.get('p99'))}\t{_ms((d.get('loop') or {}).get('p99'))}\t"
            f"{(d.get('resync') or {}).get('q', 0)}\t"
            f"{(d.get('rpc') or {}).get('open', 0)}\t"
            f"{cnry}\t{hot}\t{hog_col}\t{layv}\t"
            f"{','.join(flags) or '-'}"
        )
    out += format_table(rows)
    for nid, reasons in sorted(outliers.items()):
        out += f"\n  outlier {nid[:16]}: " + "; ".join(reasons)
    return out


def _render_cluster_hot(r: dict, top: int = 10) -> str:
    """`cluster hot`: the traffic observatory as an operator table —
    hot objects, hot buckets, op mix, slow-peer piece-fetch ranking,
    and the cluster-wide hottest bucket from the gossiped digests."""
    local = r.get("local") or {}
    head = [
        f"observatory\t{'enabled' if r.get('enabled') else 'DISABLED'}",
        f"ops seen\t{local.get('totalOps', 0)} "
        f"(read fraction {local.get('readFraction')})",
        f"keyspace skew\tzipf s = {local.get('zipfS')}",
    ]
    cluster = r.get("cluster") or {}
    hb = cluster.get("hotBucket")
    if hb:
        head.append(
            f"cluster hot bucket\t{hb['bucket']} "
            f"(~{hb.get('ops', 0):g} decayed ops on {hb['node'][:16]})"
        )
    out = format_table(head) + "\n"
    objs = (local.get("hotObjects") or [])[:top]
    if objs:
        rows = ["bucket/key\test ops\t±err\tshare"]
        for o in objs:
            rows.append(
                f"{o['bucket']}/{o['key']}\t{o['count']:g}\t"
                f"{o['errorBound']:g}\t{o['share'] * 100:.1f}%"
            )
        out += "\n== hot objects ==\n" + format_table(rows)
    bkts = (local.get("hotBuckets") or [])[:top]
    if bkts:
        rows = ["bucket\test ops\tops/s\tshare"]
        for b in bkts:
            rows.append(
                f"{b['bucket']}\t{b['count']:g}\t{b['opsPerSec']:g}\t"
                f"{b['share'] * 100:.1f}%"
            )
        out += "\n\n== hot buckets ==\n" + format_table(rows)
    mix = local.get("opMix") or {}
    if any(mix.values()):
        out += "\n\n== op mix ==\n" + format_table(
            [
                f"{op}\t{n}"
                for op, n in sorted(mix.items(), key=lambda kv: -kv[1])
                if n
            ]
        )
    peers = r.get("slowPeers") or []
    if peers:
        rows = ["peer\tstate\tpiece lat\tfetches\tbytes ewma"]
        for p in peers[:top]:
            rows.append(
                f"{p['peer'][:16]}\t"
                f"{p['state']}{' SICK' if p.get('sick') else ''}\t"
                f"{p['latMsecEwma'] if p['latMsecEwma'] is not None else '-'}"
                f"ms\t{p['pieceFetches']}\t{p.get('bytesEwma') or '-'}"
            )
        out += "\n\n== slow peers (piece fetch) ==\n" + format_table(rows)
    return out


def _render_cluster_durability(r: dict) -> str:
    """`cluster durability`: the redundancy ledger as an operator table
    — cluster health fraction, per-node classes, zone-loss exposure,
    repair ETA, layout-transition progress (model: `cluster hot`)."""
    agg = (r.get("cluster") or {}).get("aggregate") or {}
    local = r.get("local") or {}
    hf = agg.get("healthyFraction")
    eta = agg.get("repairEtaSeconds")
    head = [
        f"observatory\t{'enabled' if r.get('enabled') else 'DISABLED'}",
        f"blocks\t{agg.get('blocksTotal', 0):g} classified "
        f"({'-' if hf is None else f'{hf * 100:.1f}%'} healthy)",
        f"classes\thealthy {agg.get('healthy', 0):g}, "
        f"degraded {agg.get('degraded', 0):g}, "
        f"at_risk {agg.get('atRisk', 0):g}, "
        f"unreadable {agg.get('unreadable', 0):g}",
        f"min redundancy\t{agg.get('minRedundancy')} "
        "(live pieces minus k, worst block cluster-wide)",
        f"repair eta\t{'-' if eta is None else f'{eta:.0f}s'} "
        f"(backlog ~{agg.get('backlogBytes', 0):g} B, "
        f"{agg.get('missingPieces', 0):g} pieces"
        + (
            f", {agg.get('repairEtaUnknownNodes'):g} node(s) STALLED"
            if agg.get("repairEtaUnknownNodes")
            else ""
        )
        + ")",
    ]
    snap = local.get("snapshot") or {}
    lay = snap.get("layout") or {}
    if lay:
        head.append(
            f"layout\tv{lay.get('version')} "
            f"{lay.get('partitionsSynced', 0)}/{lay.get('partitions', 0)} "
            f"partitions synced ({(lay.get('progress') or 0) * 100:.0f}%)"
        )
    re_ = snap.get("resyncErrors") or {}
    if re_.get("transient") or re_.get("stuck"):
        oldest = re_.get("oldestAgeSecs")
        head.append(
            f"resync errors\t{re_.get('transient', 0)} transient, "
            f"{re_.get('stuck', 0)} stuck "
            + (
                f"(oldest {oldest}s)"
                if oldest is not None
                else "(ages unknown: pre-upgrade entries)"
            )
        )
    out = format_table(head) + "\n"
    zones = agg.get("zoneExposure") or {}
    if zones:
        rows = ["zone\tblocks below k if lost"]
        for z, n in sorted(zones.items(), key=lambda kv: -kv[1]):
            rows.append(f"{z}\t{n:g}")
        out += "\n== zone-loss exposure ==\n" + format_table(rows) + "\n"
    nodes = (r.get("cluster") or {}).get("nodes") or []
    rows = ["id\tup\towned\thealthy\tdegr\tat-risk\tunread\tminr\teta\tage"]
    for n in nodes:
        d = n.get("durability")
        if not isinstance(d, dict) or d.get("tot") is None:
            rows.append(
                f"{n['id'][:16]}\t{'y' if n.get('isUp') else 'n'}\t"
                "-\t-\t-\t-\t-\t-\t-\tno-ledger"
            )
            continue
        eta_n = d.get("eta")
        rows.append(
            f"{n['id'][:16]}\t{'y' if n.get('isUp') else 'n'}\t"
            f"{d.get('tot', 0)}\t{d.get('h', 0)}\t{d.get('dg', 0)}\t"
            f"{d.get('ar', 0)}\t{d.get('ur', 0)}\t{d.get('minr')}\t"
            f"{'-' if eta_n is None else f'{eta_n:g}s'}\t"
            f"{d.get('age')}s"
        )
    out += "\n== nodes ==\n" + format_table(rows)
    return out


def _render_cluster_codec(r: dict) -> str:
    """`cluster codec`: the codec X-ray as an operator table — cluster
    aggregate, then one row per node from the gossiped codec.* digest
    keys (model: `cluster durability`)."""
    agg = (r.get("cluster") or {}).get("aggregate") or {}
    local = r.get("local") or {}
    pw = agg.get("padWasteWorst")
    ovl = agg.get("overlapEfficiencyWorst")
    ll = agg.get("laneLingerP99SecondsWorst")
    head = [
        f"dispatches\t{agg.get('dispatches', 0):g} cluster-wide",
        f"pad waste\t{'-' if pw is None else f'{pw * 100:.1f}%'} (worst node)",
        f"compiles\t{agg.get('compileEvents', 0):g} events, "
        f"{agg.get('compileSeconds', 0):g}s total",
        f"overlap\t{'-' if ovl is None else f'{ovl:.2f}'} "
        "(wall / transfer+compute; 1.0 = fully sequential)",
        f"lane linger p99\t{'-' if ll is None else _ms(ll)} (worst node)",
        f"platforms\t{', '.join(local.get('platforms') or []) or '-'}",
    ]
    out = format_table(head) + "\n"
    nodes = (r.get("cluster") or {}).get("nodes") or []
    rows = ["id\tup\tdisp\tpad-waste\tcompiles\tcompile-s\tovl\tlinger99"]
    for n in nodes:
        c = n.get("codec")
        if not isinstance(c, dict):
            rows.append(
                f"{n['id'][:16]}\t{'y' if n.get('isUp') else 'n'}\t"
                "-\t-\t-\t-\t-\tno-digest"
            )
            continue
        rows.append(
            f"{n['id'][:16]}\t{'y' if n.get('isUp') else 'n'}\t"
            f"{c.get('dsp', 0):g}\t{(c.get('pw') or 0) * 100:.1f}%\t"
            f"{c.get('ce', 0):g}\t{c.get('cs', 0):g}\t"
            f"{c.get('ovl', 0):.2f}\t{_ms(c.get('ll99'))}"
        )
    out += "\n== nodes ==\n" + format_table(rows)
    return out


def _render_cluster_tenants(r: dict, sort: str = "ops", top: int = 10) -> str:
    """`cluster tenants`: the tenant observatory as an operator table —
    fairness header, cluster-summed per-tenant consumption, then one
    row per node from the gossiped tn.* digest keys (model: `cluster
    durability` / `cluster codec`)."""
    cluster = r.get("cluster") or {}
    agg = cluster.get("aggregate") or {}
    fair = cluster.get("fairness") or {}
    hog = cluster.get("hog")
    head = [
        f"observatory\t{'enabled' if r.get('enabled') else 'DISABLED'}",
        f"nodes\t{cluster.get('nodesReporting', 0)}/"
        f"{len(cluster.get('nodes') or [])} reporting tenant digests",
        f"ops\t{agg.get('ops', 0):g} cluster-wide "
        f"({agg.get('opsPerSec', 0):g}/s), {agg.get('sheds', 0):g} shed",
        f"identity\t{agg.get('claimedMismatches', 0):g} claimed/"
        "authenticated key-id mismatches",
        f"fairness\t{fair.get('tenants', 0)} tenants, top-1 share "
        f"{(fair.get('top1Share') or 0) * 100:.1f}% "
        f"(fair {(fair.get('fairShare') or 0) * 100:.1f}%), "
        f"max/median {fair.get('maxMedianRatio') or '-'}, "
        f"worst burn {fair.get('worstBurn', 0):g}",
    ]
    if hog:
        head.append(
            f"HOG!\ttenant {hog.get('id')} holds "
            f"{(hog.get('share') or 0) * 100:.1f}% of cluster ops — "
            f"{hog.get('multiple')}x its fair share "
            f"(warn multiple {hog.get('warnMultiple'):g})"
        )
    out = format_table(head) + "\n"
    sort_key = {
        "ops": lambda t: t.get("ops") or 0,
        "rps": lambda t: t.get("opsPerSec") or 0,
        "bytes": lambda t: t.get("bytes") or 0,
        "shed": lambda t: t.get("shed") or 0,
        "burn": lambda t: (t.get("burn") or {}).get("worst") or 0,
    }.get(sort) or (lambda t: t.get("ops") or 0)
    tenants = sorted(
        cluster.get("tenants") or [], key=sort_key, reverse=True
    )[: max(1, top)]
    rows = ["tenant\tclass\tops\tshare\treq/s\tbytes\tshed\tburn\tnodes"]
    for t in tenants:
        b = t.get("burn") or {}
        rows.append(
            f"{str(t.get('id'))[:20]}\t{t.get('class') or '-'}\t"
            f"{t.get('ops', 0):g}\t{(t.get('share') or 0) * 100:.1f}%\t"
            f"{t.get('opsPerSec', 0):g}\t{t.get('bytes', 0):g}\t"
            f"{t.get('shed', 0):g}\t{b.get('worst', 0):g}\t"
            f"{t.get('nodesReporting', 0)}"
        )
    out += "\n== tenants (cluster-summed) ==\n" + format_table(rows)
    nrows = ["id\tup\ttracked\tops\treq/s\tshed\ttop1\twburn\tmm"]
    for n in cluster.get("nodes") or []:
        d = n.get("tenant")
        if not isinstance(d, dict):
            nrows.append(
                f"{n['id'][:16]}\t{'y' if n.get('isUp') else 'n'}\t"
                "-\t-\t-\t-\t-\t-\tno-digest"
            )
            continue
        nrows.append(
            f"{n['id'][:16]}\t{'y' if n.get('isUp') else 'n'}\t"
            f"{d.get('trk', 0):g}\t{d.get('ops', 0):g}\t"
            f"{d.get('rps', 0):g}\t{d.get('shed', 0):g}\t"
            f"{(d.get('top1') or 0) * 100:.0f}%\t{d.get('wburn', 0):g}\t"
            f"{d.get('mm', 0):g}"
        )
    out += "\n\n== nodes ==\n" + format_table(nrows)
    return out


def _render_cluster_transition(r: dict) -> str:
    """`cluster transition`: the rebalance observatory as an operator
    table — local flight deck (partition states, per-pair bytes,
    throughput, ETA), then one row per node from the gossiped lt.*
    digest keys (model: `cluster durability`)."""
    agg = (r.get("cluster") or {}).get("aggregate") or {}
    local = r.get("local") or {}
    parts = local.get("partitions") or {}
    skw = agg.get("clockSkewWorstMs")
    thr = local.get("throughputBytesPerSec")
    eta = local.get("etaSecs")
    head = [
        f"observatory\t{'enabled' if r.get('enabled') else 'DISABLED'}",
        f"transition\t"
        + (
            f"OPEN (v{local.get('fromVersion')} -> v{local.get('version')}, "
            f"{local.get('elapsedSecs', 0):g}s elapsed)"
            if local.get("inTransition")
            else f"idle at v{local.get('version')}"
        ),
        f"sync\t{(local.get('syncFraction') or 0) * 100:.1f}% "
        f"({parts.get('synced', 0)}/{parts.get('total', 0)} synced, "
        f"{parts.get('moving', 0)} moving, {parts.get('pending', 0)} pending)",
        f"moved\t{local.get('bytesMoved', 0):g} B"
        + (f" @ {thr:g} B/s" if thr else "")
        + (f", eta {eta:g}s" if eta is not None else ""),
        f"version spread\t{agg.get('versionSpread', 0):g} "
        f"(newest v{agg.get('newestVersion')}, "
        f"{agg.get('nodesReporting', 0)} reporting)",
        f"stale nodes\t"
        f"{', '.join(s[:16] for s in agg.get('staleNodes') or []) or '(none)'}",
        f"clock skew\tworst {'-' if skw is None else f'{skw:g}ms'} "
        f"(warn above {agg.get('clockSkewWarnMs'):g}ms)",
    ]
    rep = local.get("lastReport")
    if rep:
        head.append(
            f"last report\tv{rep.get('version')} in "
            f"{rep.get('durationSecs'):g}s, {rep.get('bytesMoved', 0):g} B "
            f"over {len(rep.get('pairs') or [])} pair(s), "
            f"slo burn max {rep.get('sloBurnMax')}, "
            f"canary {'ok' if rep.get('canaryOk') else 'FAILED'}"
        )
    out = format_table(head) + "\n"
    pairs = local.get("pairs") or []
    if pairs:
        rows = ["src\tdst\tbytes"]
        for p in pairs[:16]:
            rows.append(f"{p['src']}\t{p['dst']}\t{p['bytes']:g}")
        out += "\n== bytes moved by pair ==\n" + format_table(rows) + "\n"
    nodes = (r.get("cluster") or {}).get("nodes") or []
    rows = ["id\tup\tver\tack\tsync\tactive\tfrac\tmoved\tskew"]
    for n in nodes:
        lt = n.get("lt")
        if not isinstance(lt, dict):
            rows.append(
                f"{n['id'][:16]}\t{'y' if n.get('isUp') else 'n'}\t"
                "-\t-\t-\t-\t-\t-\tno-digest"
            )
            continue
        sk = lt.get("sk")
        frac = lt.get("frac")
        rows.append(
            f"{n['id'][:16]}\t{'y' if n.get('isUp') else 'n'}\t"
            f"{lt.get('v')}\t{lt.get('ack')}\t{lt.get('sync')}\t"
            f"{lt.get('act')}\t"
            f"{'-' if frac is None else f'{frac * 100:.0f}%'}\t"
            f"{lt.get('mvb', 0):g}\t"
            f"{'-' if sk is None else f'{sk:g}ms'}"
        )
    out += "\n== nodes ==\n" + format_table(rows)
    return out


def _render_event_lines(events: list) -> list[str]:
    """One line per timeline event: corrected time, node, severity,
    name, then the attrs (truncated — the JSON surface has them all)."""
    lines = []
    for e in events:
        attrs = " ".join(
            f"{k}={v}" for k, v in sorted((e.get("attrs") or {}).items())
        )
        if len(attrs) > 120:
            attrs = attrs[:117] + "..."
        t = time.strftime(
            "%H:%M:%S", time.localtime(e.get("time") or 0)
        ) + f".{int(((e.get('time') or 0) % 1) * 1000):03d}"
        lines.append(
            f"{t}  {e.get('node', '?')[:16]}  "
            f"{(e.get('severity') or 'info').upper():8s} "
            f"{e.get('name')}  {attrs}"
        )
    return lines


def _render_cluster_events(r: dict) -> str:
    """`cluster events`: the federated timeline as text — header with
    fan-out coverage, then the skew-corrected, causally-ordered lines."""
    head = [
        f"nodes\t{len(r.get('nodesResponding') or [])} responding"
        + (
            f", {len(r.get('nodesFailed') or [])} FAILED "
            f"({', '.join(r.get('nodesFailed') or [])})"
            if r.get("nodesFailed")
            else ""
        ),
        f"filter\tsince {r.get('since', 0):g}, "
        f"min severity {r.get('minSeverity', 'info')}",
        f"events\t{len(r.get('events') or [])}",
    ]
    out = format_table(head)
    lines = _render_event_lines(r.get("events") or [])
    if lines:
        out += "\n\n" + "\n".join(lines)
    return out


def _render_codec_top(r: dict) -> str:
    """`codec top`: this node's per-kernel dispatch economics — where
    the accelerator's batches pad, compile and linger (the `local` leg
    of the shared codec_response serialization)."""
    local = r.get("local") or {}
    head = [
        f"dispatches\t{local.get('dispatches', 0):g} (this node)",
        f"pad waste\t{(local.get('padWaste') or 0) * 100:.1f}% "
        "of dispatched rows",
        f"compiles\t{local.get('compileEvents', 0):g} events, "
        f"{local.get('compileSecs', 0):g}s",
        f"platforms\t{', '.join(local.get('platforms') or []) or '-'}",
    ]
    out = format_table(head) + "\n"
    kernels = local.get("kernels") or {}
    if kernels:
        rows = ["kernel\trows\tpadded-to\tpad-waste\toverlap"]
        for name, k in sorted(
            kernels.items(), key=lambda kv: -kv[1].get("padded", 0)
        ):
            kovl = k.get("overlapEfficiency")
            rows.append(
                f"{name}\t{k.get('requested', 0):g}\t{k.get('padded', 0):g}\t"
                f"{(k.get('padWaste') or 0) * 100:.1f}%\t"
                f"{'-' if kovl is None else f'{kovl:.2f}'}"
            )
        out += "\n== kernels ==\n" + format_table(rows) + "\n"
    comp = local.get("compile") or {}
    if comp:
        rows = ["cache\tcompile events\tsecs"]
        for name, c in sorted(
            comp.items(), key=lambda kv: -kv[1].get("secs", 0)
        ):
            rows.append(f"{name}\t{c.get('events', 0)}\t{c.get('secs', 0):g}")
        out += "\n== compile ==\n" + format_table(rows) + "\n"
    lanes = local.get("lanes") or {}
    if lanes:
        rows = ["lane\tflush\tblocks\tlinger-total\tlinger-p99"]
        for lname, lane in sorted(lanes.items()):
            for fname, fl in sorted((lane.get("flush") or {}).items()):
                p99 = fl.get("lingerP99")
                rows.append(
                    f"{lname}\t{fname}\t{fl.get('blocks', 0)}\t"
                    f"{fl.get('lingerSecsTotal', 0):g}s\t"
                    f"{'-' if p99 is None else _ms(p99)}"
                )
        out += "\n== batcher lanes ==\n" + format_table(rows)
    return out


async def dispatch(args, call, config) -> str | None:
    from ..utils.config import _parse_capacity

    jd = (lambda x: json.dumps(x, indent=2, default=repr)) if args.json else None

    if args.cmd == "status":
        st = await call("status")
        if jd:
            return jd(st)
        rows = ["==== NODE ====", f"node id\t{st['node_id']}"]
        h = st["health"]
        rows += [
            f"cluster health\t{h['status']}",
            f"nodes\t{h['connected_nodes']}/{h['known_nodes']} connected",
            f"partitions ok\t{h['partitions_quorum']}/{h['partitions']}",
            f"layout version\t{st['layout_version']}",
        ]
        out = format_table(rows) + "\n\n==== PEERS ====\n"
        prow = ["id\tstate\thostname"]
        for p in st["peers"]:
            prow.append(f"{p['id'][:16]}\t{p['state']}\t{p['hostname']}")
        out += format_table(prow)
        if st["roles"]:
            out += "\n\n==== ROLES ====\n"
            rrow = ["id\tzone\tcapacity"]
            for nid, r in st["roles"].items():
                cap = "gateway" if r["capacity"] is None else str(r["capacity"])
                rrow.append(f"{nid[:16]}\t{r['zone']}\t{cap}")
            out += format_table(rrow)
        return out

    if args.cmd == "stats":
        st = await call("stats")
        if jd:
            return jd(st)
        rows = ["==== NODE ====", f"db engine\t{st['db_engine']}"]
        tm = st.get("telemetry") or {}
        if tm:
            rows.append(f"uptime\t{tm.get('up', 0):.0f}s")
        out = format_table(rows) + "\n\n==== TABLES ====\n"
        trow = ["table\tentries\tmerkle todo\tgc todo"]
        for name, t in st["tables"].items():
            trow.append(
                f"{name}\t{t['entries']}\t{t['merkle_todo']}\t{t['gc_todo']}"
            )
        out += format_table(trow) + "\n\n==== BLOCKS ====\n"
        b = st["blocks"]
        out += format_table(
            [
                f"rc entries\t{b['rc_entries']}",
                f"resync queue\t{b['resync_queue']}",
                f"resync errors\t{b['resync_errors']}",
            ]
        )
        if tm:
            out += "\n\n==== TELEMETRY (local digest) ====\n"
            s3, loop_, rpc = (
                tm.get("s3") or {}, tm.get("loop") or {}, tm.get("rpc") or {}
            )
            drow = [
                f"s3 req/s\t{s3.get('rps', 0):.2f}",
                f"s3 5xx/s\t{s3.get('eps', 0):.2f}",
                f"s3 p50/p99\t{_ms(s3.get('p50'))} / {_ms(s3.get('p99'))}",
                f"loop lag p99\t{_ms(loop_.get('p99'))}",
                f"worker errors\t{(tm.get('work') or {}).get('errs', 0):g}",
                f"breakers open\t{rpc.get('open', 0)}",
                f"repair backlog\t{(tm.get('repair') or {}).get('backlog', 0)}",
                f"tpu dispatch/s\t{(tm.get('tpu') or {}).get('dps', 0):.2f}",
                "codec pad waste / compiles\t"
                f"{(tm.get('codec') or {}).get('pw', 0):.1%} / "
                f"{(tm.get('codec') or {}).get('ce', 0):g}",
            ]
            slo = tm.get("slo")
            if slo:
                drow.append(
                    "slo budget (avail/lat)\t"
                    f"{slo['avail']['rem'] * 100:.1f}% / "
                    f"{slo['lat']['rem'] * 100:.1f}%"
                )
            out += format_table(drow)
        probe = st.get("tpuProbe")
        if probe:
            # the banked device-probe failure; never set on a port node
            # (ops/telemetry.probe_failure_summary returns None)
            out += "\n\n==== TPU PROBE (last banked failure) ====\n"
            out += format_table(
                [
                    f"result\t{probe.get('result')}",
                    f"wedged at\t{probe.get('wedgedAt') or '-'}",
                    f"phase rc\t{probe.get('rc')}"
                    + (" (timeout)" if probe.get("timedOut") else ""),
                    f"phase secs\t{probe.get('dt')}",
                    f"banked\t{probe.get('utc')} ({probe.get('profile')})",
                ]
            )
        return out

    if args.cmd == "cluster":
        if args.cluster_cmd == "hot":
            if args.profile:
                return json.dumps(
                    await call("traffic-profile"), indent=2, default=repr
                )
            r = await call("traffic")
            if args.json:
                return json.dumps(r, indent=2, default=repr)
            return _render_cluster_hot(r, top=args.top)
        if args.cluster_cmd == "durability":
            r = await call("durability")
            if args.json:
                return json.dumps(r, indent=2, default=repr)
            return _render_cluster_durability(r)
        if args.cluster_cmd == "codec":
            r = await call("codec")
            if args.json:
                return json.dumps(r, indent=2, default=repr)
            return _render_cluster_codec(r)
        if args.cluster_cmd == "telemetry":
            return json.dumps(
                await call("cluster-telemetry"), indent=2, default=repr
            )
        if args.cluster_cmd == "transition":
            r = await call("transition")
            if args.json:
                return json.dumps(r, indent=2, default=repr)
            return _render_cluster_transition(r)
        if args.cluster_cmd == "tenants":
            r = await call("tenants")
            if args.json:
                return json.dumps(r, indent=2, default=repr)
            return _render_cluster_tenants(r, sort=args.sort, top=args.top)
        if args.cluster_cmd == "events":
            a = {"since": args.since, "min_severity": args.min_severity}
            if not args.follow:
                r = await call("cluster-events", a)
                if args.json:
                    return json.dumps(r, indent=2, default=repr)
                return _render_cluster_events(r)
            # --follow: poll and stream only unseen events.  The server
            # filters on each node's OWN clock, so the watermark lags
            # one second behind the newest corrected time and a seen-set
            # dedups the overlap (skew must not drop or repeat events).
            seen: set = set()
            try:
                while True:
                    r = await call("cluster-events", a)
                    fresh = []
                    for e in r.get("events") or []:
                        k = (e.get("node"), e.get("rawTime"), e.get("name"))
                        if k in seen:
                            continue
                        seen.add(k)
                        fresh.append(e)
                    for line in _render_event_lines(fresh):
                        print(line, flush=True)
                    if fresh:
                        a["since"] = max(
                            e.get("rawTime") or 0.0 for e in fresh
                        ) - 1.0
                        seen = {
                            k for k in seen if k[1] >= a["since"]
                        }
                    await asyncio.sleep(max(0.2, args.interval))
            # graft-lint: allow-cancel(interactive follow loop: ctrl-C is the exit gesture, the CLI returns to the shell)
            except (KeyboardInterrupt, asyncio.CancelledError):
                return None
        # cluster top: live table; --once (or --json) renders one frame
        if args.json:
            return json.dumps(
                await call("cluster-telemetry"), indent=2, default=repr
            )
        if args.once:
            return _render_cluster_top(await call("cluster-telemetry"))
        try:
            while True:
                frame = _render_cluster_top(await call("cluster-telemetry"))
                # clear screen + home, like top(1)
                print("\x1b[2J\x1b[H" + frame, flush=True)
                await asyncio.sleep(max(0.2, args.interval))
        # graft-lint: allow-cancel(interactive top loop: ctrl-C is the exit gesture, the CLI returns to the shell)
        except (KeyboardInterrupt, asyncio.CancelledError):
            return None

    if args.cmd == "node" and args.node_cmd == "connect":
        nid, _, hostport = args.arg.partition("@")
        host, _, port = hostport.rpartition(":")
        return await call("connect", {"node": nid, "host": host, "port": int(port)})

    if args.cmd == "layout":
        lc = args.layout_cmd
        if lc == "assign":
            a = {
                "node": args.node,
                "zone": args.zone,
                "tags": args.tags,
                "gateway": args.gateway,
            }
            if not args.gateway:
                if not args.capacity:
                    return "error: -s/--capacity required (or -g for gateway)"
                a["capacity"] = _parse_capacity(args.capacity)
            return str(await call("layout-assign", a))
        if lc == "remove":
            return str(await call("layout-remove", {"node": args.node}))
        if lc == "apply":
            r = await call("layout-apply", {"version": args.version})
            return f"layout version {r['version']} applied:\n" + "\n".join(r["report"])
        if lc == "revert":
            return str(await call("layout-revert"))
        if lc == "config":
            return str(
                await call("layout-config", {"zone_redundancy": args.zone_redundancy})
            )
        if lc == "history":
            r = await call("layout-history")
            if jd:
                return jd(r)
            rows = [
                f"current version\t{r['current_version']}",
                f"oldest active\t{r['min_stored']}",
            ]
            for v in r["versions"]:
                rows.append(
                    f"v{v['version']}\t{v['status']}\t"
                    f"{v['storage_nodes']} storage / {v['gateway_nodes']} gateway"
                )
            rows.append("-- update trackers --")
            rows.append("node\tack\tsync\tsync_ack")
            for nid, t in r["trackers"].items():
                rows.append(f"{nid[:16]}\t{t['ack']}\t{t['sync']}\t{t['sync_ack']}")
            return format_table(rows)
        if lc == "skip-dead-nodes":
            r = await call(
                "layout-skip-dead-nodes",
                {
                    "version": args.version,
                    "allow_missing_data": args.allow_missing_data,
                },
            )
            return (
                f"trackers forced to v{r['version']} for: "
                + (", ".join(n[:16] for n in r["skipped_nodes"]) or "(none)")
            )
        if lc == "show":
            r = await call("layout-show")
            if jd:
                return jd(r)
            rows = [f"version\t{r['version']}", f"partition size\t{r['partition_size']}"]
            for nid, (zone, cap, tags) in r["roles"].items():
                rows.append(
                    f"{nid[:16]}\t{zone}\t{'gateway' if cap is None else cap}\t{','.join(tags)}"
                )
            if r["staged"]:
                rows.append("-- staged changes --")
                for nid, role in r["staged"]:
                    rows.append(f"{nid[:16]}\t{role}")
            return format_table(rows)

    if args.cmd == "bucket":
        bc = args.bucket_cmd
        if bc == "list":
            bs = await call("bucket-list")
            return format_table(
                ["id\taliases"]
                + [f"{b['id'][:16]}\t{','.join(b['aliases'])}" for b in bs]
            )
        if bc == "create":
            return str(await call("bucket-create", {"name": args.name}))
        if bc == "delete":
            return str(await call("bucket-delete", {"name": args.name}))
        if bc == "info":
            return json.dumps(
                await call("bucket-info", {"name": args.name}), indent=2, default=repr
            )
        if bc == "allow":
            return str(
                await call(
                    "bucket-allow",
                    {
                        "bucket": args.bucket,
                        "key": args.key,
                        "read": args.read,
                        "write": args.write,
                        "owner": args.owner,
                    },
                )
            )
        if bc == "deny":
            return str(await call("bucket-deny", {"bucket": args.bucket, "key": args.key}))
        if bc == "website":
            return str(
                await call(
                    "bucket-website",
                    {
                        "bucket": args.bucket,
                        "allow": args.allow,
                        "index_document": args.index_document,
                        "error_document": args.error_document,
                    },
                )
            )
        if bc == "quota":
            # only send the quotas the operator named; absent = unchanged
            a = {"bucket": args.bucket}
            if args.max_size is not None:
                a["max_size"] = (
                    None if args.max_size == "none" else _parse_capacity(args.max_size)
                )
            if args.max_objects is not None:
                a["max_objects"] = (
                    None if args.max_objects == "none" else int(args.max_objects)
                )
            return str(await call("bucket-quota", a))
        if bc in ("alias", "unalias"):
            return str(
                await call(
                    f"bucket-{bc}",
                    {
                        "bucket": args.bucket,
                        "alias": args.alias,
                        "local_key": args.local,
                    },
                )
            )

    if args.cmd == "key":
        kc = args.key_cmd
        if kc == "new":
            r = await call(
                "key-new",
                {"name": args.name, "allow_create_bucket": args.allow_create_bucket},
            )
            return f"Key ID: {r['key_id']}\nSecret key: {r['secret_key']}"
        if kc == "list":
            ks = await call("key-list")
            return format_table(
                ["key id\tname"] + [f"{k['key_id']}\t{k['name']}" for k in ks]
            )
        if kc == "info":
            return json.dumps(
                await call("key-info", {"key": args.key, "show_secret": args.show_secret}),
                indent=2,
                default=repr,
            )
        if kc == "delete":
            return str(await call("key-delete", {"key": args.key}))
        if kc == "import":
            r = await call(
                "key-import",
                {"key_id": args.key_id, "secret": args.secret, "name": args.name},
            )
            return f"imported {r['key_id']}"
        if kc == "set":
            acb = None
            if args.allow_create_bucket:
                acb = True
            elif args.deny_create_bucket:
                acb = False
            return json.dumps(
                await call(
                    "key-set",
                    {"key": args.key, "name": args.name,
                     "allow_create_bucket": acb},
                )
            )

    if args.cmd == "codec" and args.codec_cmd == "top":
        r = await call("codec")
        if jd:
            return jd(r)
        return _render_codec_top(r)

    if args.cmd == "overload" and args.overload_cmd == "status":
        r = await call("overload-status")
        if jd:
            return jd(r)
        adm = r.get("admission") or {}
        rows = [
            f"in flight\t{adm.get('inFlight')}/{adm.get('maxInFlight')}"
            f" (queued {adm.get('queued')})",
            f"shedding tiers\t{adm.get('shedFromTier') or '(none)'}",
        ]
        rows.append("tier\tadmitted\tqueued\tshed")
        for tname, t in (adm.get("tiers") or {}).items():
            rows.append(
                f"{tname}\t{t['admitted']}\t{t['queued']}\t{t['shed']}"
            )
        lad = r.get("ladder")
        if lad:
            rows.append(
                f"ladder level\t{lad['level']}/{lad['maxLevel']} "
                f"(burn {lad['burnRate']:.2f}, "
                f"lag p99 {lad['loopLagP99Ms']:.0f}ms)"
            )
            applied = [s["name"] for s in lad["ladder"] if s["applied"]]
            rows.append(f"applied steps\t{', '.join(applied) or '(none)'}")
            rows.append(
                f"steps up/down\t{lad['stepsUp']}/{lad['stepsDown']}"
            )
            if lad.get("lastReason"):
                rows.append(f"last change\t{lad['lastReason']}")
        if adm.get("keyTokens"):
            rows.append("key\ttokens left")
            for k, v in adm["keyTokens"].items():
                rows.append(f"{k}\t{v:g}")
        return format_table(rows)

    if args.cmd == "worker" and args.worker_cmd == "get":
        return json.dumps(await call("worker-get", {"var": args.var}))
    if args.cmd == "worker" and args.worker_cmd == "set":
        return json.dumps(
            await call("worker-set", {"var": args.var, "value": args.value})
        )
    if args.cmd == "worker":
        import time as _time

        ws = await call("worker-list")
        if jd:
            return jd(ws)
        rows = ["id\tname\tstate\terrors\ttranq\trate\tlast\tinfo"]
        now = _time.time()
        for w in ws:
            tq = w.get("tranquility")
            rate = w.get("throughput")
            done = w.get("last_completed")
            rows.append(
                f"{w['id']}\t{w['name']}\t{w['state']}\t{w['errors']}\t"
                f"{'-' if tq is None else tq}\t"
                f"{'-' if rate is None else f'{rate:.2f}/s'}\t"
                f"{'-' if done is None else f'{max(0, now - done):.0f}s ago'}\t"
                f"{w['info']}"
            )
        return format_table(rows)

    if args.cmd == "debug":
        if args.debug_cmd == "profile":
            a = {"seconds": args.seconds, "hz": args.hz}
            if args.speedscope:
                a["format"] = "speedscope"
            r = await call("debug-profile", a)
            body = (
                json.dumps(r["speedscope"]) if args.speedscope else r["folded"]
            )
            if args.output:
                # graft-lint: allow-blocking(one-shot CLI command, loop not shared)
                with open(args.output, "w") as f:
                    f.write(body)
                return (
                    f"wrote {len(body)} bytes "
                    f"({r['samples']} sampling rounds) to {args.output}"
                )
            return body
        if args.debug_cmd == "latency":
            r = await call("debug-latency")
            if jd:
                return jd(r)
            if not r["enabled"]:
                return (
                    "latency X-ray disabled ([admin] latency_xray = false)"
                )
            if not r["ops"]:
                return "no attributed requests recorded yet"
            out_parts = []
            for op, st in sorted(r["ops"].items()):
                w = st["wallMs"]
                rows = [
                    f"== {op} ==\t({st['count']} reqs)",
                    f"wall ms p50/p95/p99\t"
                    f"{w['p50']:.1f} / {w['p95']:.1f} / {w['p99']:.1f}",
                    f"coverage\t{st['coverage'] * 100:.0f}%",
                    f"overlap efficiency\t{st['overlapEfficiency']:.2f} "
                    "(1.0 = fully sequential)",
                    "phase\tp50ms\tp95ms\tp99ms\tshare",
                ]
                for ph, ps in st["phases"].items():
                    rows.append(
                        f"{ph}\t{ps['p50']:.1f}\t{ps['p95']:.1f}\t"
                        f"{ps['p99']:.1f}\t"
                        f"{ps['criticalPathShare'] * 100:.0f}%"
                    )
                out_parts.append(format_table(rows))
            return "\n\n".join(out_parts)
        if args.debug_cmd == "slow":
            r = await call("debug-slow")
            if jd:
                return jd(r)
            if not r["enabled"]:
                return (
                    "flight recorder disabled "
                    "([admin] flight_recorder = false)"
                )
            if not r["requests"]:
                return (
                    f"no requests above {r['thresholdMs']:g} ms recorded"
                )
            rows = ["trace\tname\tms\tspans\tok\ttop phases\tattrs"]
            for q in r["requests"]:
                attrs = ",".join(f"{k}={v}" for k, v in q["attrs"].items())
                wf = q.get("phases") or {}
                top = ", ".join(
                    f"{ph} {st['ms']:.0f}ms"
                    for ph, st in list((wf.get("phases") or {}).items())[:3]
                )
                rows.append(
                    f"{q['traceId'][:16]}\t{q['name']}\t"
                    f"{q['durationMs']:.1f}\t{len(q['spans'])}\t"
                    f"{'y' if q['ok'] else 'n'}\t{top or '-'}\t{attrs}"
                )
            return format_table(rows)

    if args.cmd == "block":
        bc = args.block_cmd
        if bc == "list-errors":
            errs = await call("block-list-errors")
            if jd:
                return jd(errs)
            rows = ["hash\tfailures\tage\tnext try in"]
            for e in errs:
                age = e.get("age_secs")
                rows.append(
                    f"{e['hash'][:16]}\t{e['failures']}\t"
                    f"{'-' if age is None else f'{age}s'}\t"
                    f"{e['next_try_in_secs']}s"
                )
            return format_table(rows)
        if bc == "info":
            return json.dumps(
                await call("block-info", {"hash": args.hash}), indent=2, default=repr
            )
        if bc == "retry-now":
            if not args.all and not args.hash:
                return "error: give a hash or --all"
            return str(
                await call(
                    "block-retry-now", {"hash": args.hash, "all": args.all}
                )
            )
        if bc == "purge":
            return json.dumps(
                await call("block-purge", {"hash": args.hash, "yes": args.yes}),
                indent=2,
            )

    if args.cmd == "repair":
        a = {"what": args.what}
        if args.what == "scrub":
            a["cmd"] = args.sub_cmd or "start"
            if args.sub_value is not None:
                a["value"] = args.sub_value
        if args.what == "plan":
            a["cmd"] = args.sub_cmd or "status"
            if args.fresh:
                a["fresh"] = True
            r = await call("repair", a)
            if isinstance(r, dict):
                if jd:
                    return jd(r)
                rows = [
                    f"running\t{r.get('running')}",
                    f"state\t{r.get('state', '-')}",
                    f"backlog\t{r.get('backlog', 0)}",
                    f"repaired\t{r.get('repaired', 0)}",
                    f"rounds\t{r.get('rounds', 0)}",
                    f"nudged\t{r.get('nudged', 0)}",
                    f"lost\t{r.get('lost', 0)}",
                ]
                for u, n in (r.get("backlogByUrgency") or {}).items():
                    rows.append(f"backlog[{u}]\t{n}")
                return format_table(rows)
            return str(r)
        return str(await call("repair", a))

    if args.cmd == "meta" and args.meta_cmd == "snapshot":
        return json.dumps(await call("meta-snapshot"))

    return None


if __name__ == "__main__":
    sys.exit(main())
