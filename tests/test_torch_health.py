"""Public cluster-plane methods that needed the port's observatory modules
(utils/flight.py, block/durability.py, rpc/telemetry_digest.py), held to
the reference:

  - `System.health()` with no argument (it computes the outlier set from
    the digests) returns a `ClusterHealth` on a port cluster, with the
    same status and counts as the reference's on a reference cluster of
    the same node keys, hence the same layout — whole, then with a node
    stopped;
  - the layout-transition tracker opens, accounts, samples
    `sync_fraction` and closes (`_close` banks a report and a flight
    event) exactly as the reference's does on the same layout edits;
  - `transition_response` federates the same rows and aggregate on both
    clusters.

Every cluster test body runs under `asyncio.wait_for(..., 60)`."""

import asyncio
import os
import types

import torch

from garage_tpu.block.codec.ec import EcCodec as JEcCodec
from garage_tpu.block.manager import BlockManager as JBlockManager
from garage_tpu.db import open_db as j_open_db
from garage_tpu.net import NetApp as JNetApp
from garage_tpu.rpc import system as j_system
from garage_tpu.rpc import transition as j_transition
from garage_tpu.rpc.layout import manager as j_manager
from garage_tpu.rpc.layout import types as j_types
from garage_tpu.rpc.replication_mode import ReplicationMode as JReplicationMode
from garage_tpu.rpc.rpc_helper import RpcHelper as JRpcHelper
from garage_tpu.utils import flight as j_flight
from garage_tpu.utils.config import DataDir as JDataDir
from garage_tpu.utils.persister import Persister as JPersister
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.net.handshake import gen_node_key
from garage_tpu_torch.rpc import system as t_system
from garage_tpu_torch.rpc import transition as t_transition
from garage_tpu_torch.rpc.layout import manager as t_manager
from garage_tpu_torch.rpc.layout import types as t_types
from garage_tpu_torch.tools import block_cluster as bc
from garage_tpu_torch.utils import flight as t_flight
from time_limits import time_limit

_limit = time_limit(120)  # a stalled test fails instead of holding the run

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


async def ref_cluster(root, keys):
    """Three reference nodes wired as tools/block_cluster.py wires the
    port's, one zone each, on the given node keys."""
    apps = []
    for key in keys:
        app = JNetApp(bc.NETKEY, key)
        await app.listen("127.0.0.1", 0)
        apps.append(app)
    nodes = []
    for i, app in enumerate(apps):
        meta, data = str(root / f"meta{i}"), str(root / f"data{i}")
        os.makedirs(meta, exist_ok=True)
        lm = j_manager.LayoutManager(app.id, 3, persister=JPersister(
            meta, "cluster_layout", j_manager.PersistedLayout))
        system = j_system.System(app, lm, JReplicationMode(3), bootstrap=[
            (a.id, a.bind_addr) for a in apps if a is not app])
        await system.start()
        db = j_open_db(meta, engine="memory")
        mgr = JBlockManager(system, JRpcHelper(app.id, system.peering), db, [JDataDir(data)],
                            meta, codec=JEcCodec(2, 1, tpu_enable=False))
        nodes.append(bc.Node(i, keys[i], app, system, db, mgr, data))
    await bc.wait_until(lambda: all(len(x.system.peering.connected_peers()) == 2
                                    for x in nodes), 30, "full mesh")
    lm0 = nodes[0].system.layout_manager
    for i, x in enumerate(nodes):
        lm0.stage_role(x.app.id, j_types.NodeRole(zone=f"z{i}", capacity=bc.CAPACITY))
    lm0.apply_staged()
    await bc.wait_until(lambda: all(x.system.layout_manager.digest() == lm0.digest()
                                    for x in nodes), 30, "layout agreement")
    return nodes


async def both_clusters(tmp_path):
    keys = [gen_node_key() for _ in range(3)]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = await ref_cluster(tmp_path / "ref", keys)
    port = await bc.make_cluster(tmp_path / "port", 3, lambda _i: EcCodec(2, 1, device="cpu"),
                                 keys=keys)
    return ref, port


def health_fields(h) -> tuple:
    return (h.status, h.known_nodes, h.connected_nodes, h.storage_nodes, h.storage_nodes_up,
            h.partitions_quorum, h.partitions_all_ok, h.outlier_nodes)


def test_health_without_outliers_argument_matches_reference(tmp_path):
    async def main():
        ref, port = await both_clusters(tmp_path)
        live = ref + port
        try:
            assert ref[0].system.layout_manager.history.current().ring_assignment == \
                port[0].system.layout_manager.history.current().ring_assignment
            for r, p in zip(ref, port):
                hp = p.system.health()
                assert isinstance(hp, t_system.ClusterHealth)
                assert health_fields(hp) == health_fields(r.system.health())
                assert hp.status == "healthy" and hp.storage_nodes_up == 3
            for nodes in (ref, port):
                await bc.stop_node(nodes[2])
                live.remove(nodes[2])
            await bc.wait_until(
                lambda: all(not x.system.netapp.is_connected(nodes[2].app.id)
                            for nodes in (ref, port) for x in nodes[:2]),
                10, "the stopped node is seen gone")
            for r, p in zip(ref[:2], port[:2]):
                hr, hp = r.system.health(), p.system.health()
                assert health_fields(hp) == health_fields(hr)
                assert hp.status == "degraded" and hp.storage_nodes_up == 2
        finally:
            await bc.stop_all(live)

    run(main())


class Calls:
    """A registry that records the tracker's counter increments."""

    def __init__(self):
        self.calls = []

    def incr(self, name, labels=(), by=1):
        self.calls.append((name, tuple(labels), by))


def tracker_run(manager, types_, transition, flight):
    """The reference test's open/account/close sequence on one package:
    returns what the tracker and the flight recorder saw."""
    node, peer = b"\x01" * 32, b"\x02" * 32
    lm = manager.LayoutManager(node, 1)
    g = types.SimpleNamespace(layout_manager=lm,
                              system=types.SimpleNamespace(id=node, clock_offsets={}))
    reg = Calls()
    rec = flight.SlowRequestRecorder(threshold_ms=1e9)
    flight.span_fanout.attach(rec)
    try:
        tt = transition.TransitionTracker(g, registry=reg)
        tt.clock = lambda: 100.0  # a fixed clock: the sync curve's times agree
        seen = [tt.active]
        for cap in (10 ** 12, 2 * 10 ** 12):
            lm.stage_role(node, types_.NodeRole(zone="z1", capacity=cap))
            lm.apply_staged()
            seen.append(tt.active)
        tt.note_transfer(peer, node, 1000, partition=3)
        tt.note_transfer(peer, node, 500, partition=3)
        tt.note_transfer(node, peer, 250, partition=7)
        opened = (tt.from_version, tt.target_version, tt.bytes_total,
                  sorted(tt.partitions_touched), tt.sync_fraction())
        lm.mark_synced(2)  # trim retires v1: the transition closes
        rep = {k: v for k, v in tt.last_report.items()
               if k not in ("durationSecs", "openedAt", "closedAt", "curve")}
        evs = [(e["name"], e["severity"], e["attrs"].get("bytesMoved")) for e in rec.events]
        return (seen, opened, tt.active, tt.reports, rep, evs, reg.calls,
                tt.sync_fraction(), tt.digest_fields()["act"])
    finally:
        flight.span_fanout.detach(rec)


def test_transition_tracker_close_and_sync_fraction_match_reference():
    ref = tracker_run(j_manager, j_types, j_transition, j_flight)
    port = tracker_run(t_manager, t_types, t_transition, t_flight)
    assert port == ref
    seen, opened, active, reports, rep, evs, calls, frac, act = port
    assert seen == [False, False, True] and not active and reports == 1
    assert opened[:4] == (1, 2, 1750, [3, 7]) and 0.0 <= opened[4] < 1.0
    assert rep["bytesMoved"] == 1750 == sum(p["bytes"] for p in rep["pairs"])
    assert evs == [("transition-report", "info", "1750")]
    assert sum(c[2] for c in calls) == 1750 and frac == 1.0 and act == 1


def test_transition_response_matches_reference(tmp_path):
    async def main():
        ref, port = await both_clusters(tmp_path)
        try:
            out = []
            for nodes, transition in ((ref, j_transition), (port, t_transition)):
                g = types.SimpleNamespace(
                    system=nodes[0].system, layout_manager=nodes[0].system.layout_manager,
                    config=types.SimpleNamespace(
                        admin=types.SimpleNamespace(clock_skew_warn_msec=250.0)))
                g.transition_tracker = transition.TransitionTracker(g, registry=Calls())
                for x in nodes:
                    x.system.telemetry_collector = (
                        lambda t=transition.TransitionTracker(types.SimpleNamespace(
                            layout_manager=x.system.layout_manager, system=x.system),
                            registry=Calls()): {"v": 1, "lt": t.digest_fields()})
                for _ in range(2):
                    for x in nodes:
                        await x.system.status_exchange_once()
                    await asyncio.sleep(0.05)
                resp = transition.transition_response(g)
                out.append((resp["enabled"], resp["local"]["inTransition"],
                            resp["local"]["syncFraction"],
                            sorted(n["id"] for n in resp["cluster"]["nodes"]),
                            {k: v for k, v in resp["cluster"]["aggregate"].items()
                             if k != "clockSkewWorstMs"}))
            assert out[1] == out[0]
            enabled, in_transition, frac, ids, aggregate = out[1]
            assert enabled and not in_transition and frac == 1.0 and len(ids) == 3
            assert aggregate["nodesReporting"] == 3 and aggregate["versionSpread"] == 0
            assert aggregate["staleNodes"] == []
        finally:
            await bc.stop_all(ref + port)

    run(main())


def test_cluster_health_fields_match_reference():
    assert [f for f in t_system.ClusterHealth.__dataclass_fields__] == \
        [f for f in j_system.ClusterHealth.__dataclass_fields__]
