"""The port's durability observatory (garage_tpu_torch/block/durability.py)
held to the reference module (garage_tpu/block/durability.py):

  - classification, zone-loss exposure (unit cases and synthetic
    layouts), `[durability]` config validation and the rollup's number
    coercion give identical answers in both packages on the same inputs;
  - the EC(2,1) convergence run of tests/test_durability.py on the port's
    own 3-node cluster (tools/block_cluster.py): steady state, a rank
    lost (every block at_risk, one alert), a second rank lost
    (unreadable), both back (one with a wiped disk, drained by resync),
    then the owner's disk wiped and healed with a finite repair ETA —
    read through the gossiped `dur.*` digest keys and
    `durability_response`, as the admin endpoint reads them.

The cluster is of block-store nodes, without the `model/` layer, so each
node's digest carries the `dur` block of its own `DurabilityScanner`
through `System.telemetry_collector`, and `durability_response` gets the
few attributes of a garage it reads.  The cluster run is bounded by
`asyncio.wait_for(..., 60)`.  The reference's whole file, on whole port
nodes (the resync error ages, the digest keys, the rollup's tolerance
and the 11-node EC(8,3) acceptance included), runs on the port in
tests/test_torch_observatory_mirror.py."""

import asyncio
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from garage_tpu.block import durability as j_dur
from garage_tpu.rpc.layout import types as j_types
from garage_tpu.rpc.layout import version as j_version
from garage_tpu.utils import config as j_config
from garage_tpu_torch.block import durability as t_dur
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.block.manager import wrap_piece
from garage_tpu_torch.rpc.layout import types as t_types
from garage_tpu_torch.rpc.layout import version as t_version
from garage_tpu_torch.rpc.telemetry_digest import DIGEST_VERSION
from garage_tpu_torch.tools import block_cluster as bc
from garage_tpu_torch.utils import config as t_config
from garage_tpu_torch.utils import flight
from garage_tpu_torch.utils.data import blake2sum
from time_limits import time_limit

_limit = time_limit(120)  # a stalled test fails instead of holding the run

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)


@pytest.mark.parametrize("live,k,width,want", [
    (11, 8, 11, "DUR_HEALTHY"), (10, 8, 11, "DUR_DEGRADED"), (9, 8, 11, "DUR_DEGRADED"),
    (8, 8, 11, "DUR_AT_RISK"), (7, 8, 11, "DUR_UNREADABLE"), (0, 8, 11, "DUR_UNREADABLE"),
    (3, 1, 3, "DUR_HEALTHY"), (2, 1, 3, "DUR_DEGRADED"), (1, 1, 3, "DUR_AT_RISK"),
    (0, 1, 3, "DUR_UNREADABLE"),
])
def test_classify_block(live, k, width, want):
    got = t_dur.classify_block(live, k, width)
    assert got == j_dur.classify_block(live, k, width) == getattr(t_dur, want)


def test_zone_exposed():
    rng = np.random.default_rng(12)
    cases = [({"a": 1, "b": 1, "c": 1}, 3, 2), ({"a": 1, "b": 1, "c": 1}, 3, 3),
             ({"a": 2, "b": 1}, 3, 2), ({"a": 4, "b": 4, "c": 3}, 11, 7), ({"a": 2, "b": 0}, 2, 1)]
    for _ in range(40):
        by_zone = {z: int(rng.integers(0, 4)) for z in "abcd"}
        live = sum(by_zone.values())
        cases.append((by_zone, live, int(rng.integers(1, max(2, live + 1)))))
    got = [t_dur.zone_exposed(*c) for c in cases]
    assert got == [j_dur.zone_exposed(*c) for c in cases]
    assert got[:5] == [[], ["a", "b", "c"], ["a"], [], ["a"]]


def test_zone_exposure_on_synthetic_layouts():
    def exposed(types, version, dur, zones, zr, k):
        roles = {bytes([i]) * 32: types.NodeRole(zone=z, capacity=1000)
                 for i, z in enumerate(zones)}
        lv = version.LayoutVersion(1, 3, zr(types), roles=roles)
        lv.compute_assignment()
        out = 0
        for p in range(len(lv.ring_assignment)):
            nodes = lv.nodes_of_partition(p)
            by_zone = {}
            for n in nodes:
                by_zone[lv.roles[n].zone] = by_zone.get(lv.roles[n].zone, 0) + 1
            out += bool(dur.zone_exposed(by_zone, len(nodes), k))
        return out

    pkgs = [(j_types, j_version, j_dur), (t_types, t_version, t_dur)]
    for zones, zr in ((["a", "b", "c"], lambda t: t.ZoneRedundancy.MAXIMUM),
                      (["a", "a", "b", "c"], lambda _t: 2)):
        ref, port = (exposed(*p, zones, zr, k=2) for p in pkgs)
        assert port == ref
        assert (port == 0) == (len(zones) == 3)


@pytest.mark.parametrize("section,ok", [
    ({"tranquility": 5}, True), ({"scan_batch": 0}, False), ({"interval_secs": 0}, False),
    ({"tranquility": -1}, False), ({"stuck_error_secs": 0}, False),
])
def test_durability_config_validation(section, ok):
    base = {"metadata_dir": "/tmp/x", "rpc_secret": "aa" * 32, "durability": section}
    for config in (j_config, t_config):
        if ok:
            cfg = config.config_from_dict(base)
            assert cfg.durability.tranquility == 5 and cfg.durability.enabled
        else:
            with pytest.raises(ValueError):
                config.config_from_dict(base)


@pytest.mark.parametrize("v", ["nope", "3.5", None, 2, {"a": 1}])
def test_rollup_number_coercion(v):
    assert t_dur._num(v) == j_dur._num(v)
    assert t_dur._num(v, 0.0) == j_dur._num(v, 0.0)


# --- the EC(2,1) convergence run on the port's cluster ------------------------

N = 24


def observe(node) -> SimpleNamespace:
    """The durability scanner of `node`, its digest in the gossip, and
    the attributes of a garage `durability_response` reads."""
    sc = t_dur.DurabilityScanner(node.manager)
    collect = lambda: {"v": DIGEST_VERSION, "dur": sc.digest_fields()}  # noqa: E731
    node.system.telemetry_collector = collect
    return SimpleNamespace(
        node=node, system=node.system, node_id=node.app.id, durability_scanner=sc,
        telemetry=SimpleNamespace(collect=collect),
        config=SimpleNamespace(durability=SimpleNamespace(enabled=True)))


async def populate(nodes, rng) -> list[bytes]:
    """N blocks written straight into each rank's store and referenced on
    every node (the reference test's population shape)."""
    codec = nodes[0].manager.codec
    layout = nodes[0].system.layout_manager.history.current()
    by_id = {x.app.id: x for x in nodes}
    hashes = []
    for _ in range(N):
        data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        h = blake2sum(data)
        for rank, nid in enumerate(layout.nodes_of(h)[: codec.n_pieces]):
            await by_id[nid].manager.write_block_local(
                h, wrap_piece(len(data), codec.encode(data)[rank]), False, piece=rank)
        hashes.append(h)
    for x in nodes:
        reference(x, hashes)
    return hashes


def reference(node, hashes) -> None:
    mgr = node.manager
    node.db.transaction(lambda tx: [mgr.rc.incr(tx, h) for h in hashes] and None)


async def scan_and_gossip(gs) -> None:
    for g in gs:
        await g.durability_scanner.scan_pass()
    for _ in range(2):
        for g in gs:
            await g.system.status_exchange_once()
        await asyncio.sleep(0.05)


def agg(g) -> dict:
    return t_dur.durability_response(g)["cluster"]["aggregate"]


def test_durability_convergence_ec21(tmp_path):
    """The reference's acceptance shape on ec:2:1 over 3 nodes and 3
    zones.  With rf == n one node owns every block while connected;
    victims are chosen relative to it."""

    async def main():
        rng = np.random.default_rng(14)
        nodes = await bc.make_cluster(tmp_path, 3, lambda _i: EcCodec(2, 1, device="cpu"))
        gs = [observe(x) for x in nodes]
        live_nodes = list(nodes)
        rec = flight.SlowRequestRecorder(threshold_ms=10 ** 9)
        flight.attach_recorder(rec)
        try:
            hashes = await populate(nodes, rng)
            owner = nodes[0].system.layout_manager.history.current().nodes_of(hashes[0])[0]
            g0 = next(g for g in gs if g.node_id == owner)
            others = [g for g in gs if g is not g0]
            await scan_and_gossip(gs)

            # steady state: 100% healthy, exact totals
            a = agg(g0)
            assert a["blocksTotal"] == N and a["healthy"] == N and a["healthyFraction"] == 1.0
            assert a["minRedundancy"] == 1 and a["atRisk"] == 0 and a["unreadable"] == 0
            assert a["missingPieces"] == 0 and a["zoneExposure"] == {}
            assert g0.durability_scanner.repair_eta_secs() == 0.0
            d = g0.telemetry.collect()
            assert d["dur"]["h"] == d["dur"]["tot"] and d["dur"]["lt"] == 1.0
            rows = t_dur.durability_response(g0)["cluster"]["nodes"]
            assert sum(r["durability"]["tot"] for r in rows) == N

            # one non-owner rank lost: every block at_risk, one alert
            v2, v1 = others[1], others[0]
            await bc.stop_node(v2.node)
            live_nodes.remove(v2.node)
            await bc.wait_until(lambda: not g0.system.netapp.is_connected(v2.node_id)
                                and not v1.system.netapp.is_connected(v2.node_id),
                                10, "survivors see the victim gone")
            n0 = len(rec.records)
            await scan_and_gossip([g0, v1])
            a = agg(g0)
            assert a["atRisk"] == N and a["healthy"] == 0 and a["blocksTotal"] == N
            assert a["minRedundancy"] == 0 and a["repairEtaUnknownNodes"] == 1
            assert g0.durability_scanner.repair_eta_secs() is None
            alerts = [r for r in rec.records if r.get("event")
                      and r["name"].startswith("durability-alert")]
            assert len(rec.records) > n0 and any("at_risk" in r["name"] for r in alerts)
            n1 = len(rec.records)
            for g in (g0, v1):
                await g.durability_scanner.scan_pass()
            assert len(rec.records) == n1  # a transition alerts once

            # the second non-owner rank lost: below k, unreadable
            await bc.stop_node(v1.node)
            live_nodes.remove(v1.node)
            await bc.wait_until(lambda: not g0.system.netapp.is_connected(v1.node_id),
                                10, "the owner sees the victim gone")
            await scan_and_gossip([g0])
            a = agg(g0)
            assert a["unreadable"] == N and a["atRisk"] == 0 and a["minRedundancy"] == -1
            assert any("unreadable" in r["name"] for r in rec.records if r.get("event"))

            # both back, v2 with a wiped data dir; resync drains it
            shutil.rmtree(v2.node.data_dir)
            back = []
            for v in (v1, v2):
                node = await bc.restart_node(tmp_path, v.node, [g0.node] + back,
                                             EcCodec(2, 1, device="cpu"))
                reference(node, hashes)  # memory db: the rc entries were lost
                back.append(node)
                live_nodes.append(node)
            gs2 = [g0] + [observe(x) for x in back]
            await bc.wait_until(lambda: all(len(g.system.peering.connected_peers()) == 2
                                            for g in gs2), 30, "full mesh again")
            sc2 = gs2[2].durability_scanner
            assert (await sc2.scan_pass())["localMissingPieces"] == N
            resync = back[1].manager.resync
            resync.queue_blocks(hashes)
            while await resync.resync_iter():
                pass
            assert (await sc2.scan_pass())["localMissingPieces"] == 0
            await scan_and_gossip(gs2)
            a = agg(g0)
            assert a["blocksTotal"] == N and a["healthy"] == N and a["minRedundancy"] == 1

            # the owner's disk wiped in place: a finite ETA mid-drain
            shutil.rmtree(g0.node.data_dir)
            sc0 = g0.durability_scanner
            wiped = await sc0.scan_pass()
            assert wiped["atRisk"] == N and wiped["missingPieces"] == N
            assert sc0.repair_eta_secs() is not None
            r0 = g0.node.manager.resync
            r0.queue_blocks([hashes[0]])
            assert await r0.resync_iter()
            assert (await sc0.scan_pass())["missingPieces"] == N - 1
            eta = sc0.repair_eta_secs()
            assert eta is not None and 0 < eta < 10 ** 6
            r0.queue_blocks(hashes)
            while await r0.resync_iter():
                pass
            final = await sc0.scan_pass()
            assert final["missingPieces"] == 0 and final["healthy"] == N
            assert sc0.repair_eta_secs() == 0.0
            await scan_and_gossip(gs2)
            assert agg(g0)["healthyFraction"] == 1.0
        finally:
            flight.detach_recorder(rec)
            await bc.stop_all(live_nodes)

    asyncio.run(asyncio.wait_for(main(), 60))
