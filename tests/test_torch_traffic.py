"""The port's traffic observatory (garage_tpu_torch/rpc/traffic.py) held to
the reference module (garage_tpu/rpc/traffic.py) on the same inputs,
made with numpy from a seed: op classification, the observatory's
snapshot, digest block and replayable profile, and the per-peer
piece-fetch ranking it reads from rpc/peer_health.py.  Each scenario of
tests/test_traffic.py that needs no live node runs through both
packages; the outputs must be identical and the port's must keep the
reference tests' guarantees.  The reference's whole file, live nodes
and the 11-node acceptance included, runs on the port in
tests/test_torch_observatory_mirror.py."""

import json
from collections import Counter

import numpy as np
import pytest

from garage_tpu.rpc import peer_health as j_peer_health
from garage_tpu.rpc import traffic as j_traffic
from garage_tpu_torch.rpc import peer_health as t_peer_health
from garage_tpu_torch.rpc import traffic as t_traffic


def both(fn, mods):
    ref, port = (fn(m) for m in mods)
    assert ref == port
    return port


@pytest.mark.parametrize("method,key,query,want", [
    ("GET", "k", {}, "get"), ("GET", "", {}, "list"), ("HEAD", "k", {}, "head"),
    ("PUT", "k", {}, "put"), ("DELETE", "k", {}, "delete"),
    ("POST", "", {"delete": ""}, "delete"), ("POST", "k", {"uploads": ""}, "other"),
    ("POST", "k", {"uploadId": "u1"}, "other"), ("POST", "k", {}, "put"),
    ("OPTIONS", "k", {}, "other"),
])
def test_classify_op(method, key, query, want):
    assert both(lambda m: m.classify_op(method, key, query), (j_traffic, t_traffic)) == want


def fill(obs, n_keys=50, n=4000, s=1.2, seed=11):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** s
    seq = rng.choice(n_keys, size=n, p=w / w.sum())
    for i in seq:
        obs.record_http("GET", "bench", f"k{i:03d}", {}, 4096, 0.005)
    return Counter(f"k{i:03d}" for i in seq)


def test_observatory_snapshot_and_digest():
    def run(m):
        obs = m.TrafficObservatory(topk=64, halflife=None, clock=lambda: 100.0)
        obs.enabled = True
        true = fill(obs)
        obs.record_http("PUT", "bench", "w", {}, 65536, 0.01)
        obs.record_http("GET", "", "", {}, 0, 0.001)  # list
        snap, digest = obs.snapshot(), obs.digest_fields(rps=3.5)
        obs.enabled = False
        obs.record_http("GET", "bench", "k000", {}, 1, 0.001)
        return true, snap, digest, obs.snapshot()["totalOps"]

    true, snap, d, after = both(run, (j_traffic, t_traffic))
    assert snap["totalOps"] == 4002 == after
    assert snap["opMix"]["get"] == 4000 and snap["opMix"]["list"] == 1
    assert 0.99 <= snap["readFraction"] <= 1.0
    got = [o["key"] for o in snap["hotObjects"][:10]]
    assert len(set(got) & {k for k, _ in true.most_common(10)}) >= 8
    o0 = snap["hotObjects"][0]
    assert o0["count"] - o0["errorBound"] <= true[o0["key"]] <= o0["count"] + 1e-9
    assert snap["hotBuckets"][0]["bucket"] == "bench"
    assert snap["zipfS"] and snap["zipfS"] > 0.6
    assert sum(b["count"] for b in snap["sizeHistogram"]) == 4001
    assert d["ops"] == 4002 and d["rps"] == 3.5
    assert d["rd"] == 4000 and d["wr"] == 1 and d["ls"] == 1
    assert d["hb"] == "bench" and d["hbo"] > 0 and d["zipf"] == snap["zipfS"]
    json.dumps(snap)


def test_observatory_profile_is_replayable_contract():
    def run(m):
        t = [0.0]
        obs = m.TrafficObservatory(topk=64, halflife=None, clock=lambda: t[0])
        obs.enabled = True
        for i in range(100):
            t[0] += 0.05  # steady 20 ops/s arrival process
            op = "put" if i % 10 == 0 else "get"
            obs.record_http(op.upper(), "b", f"k{i % 7}", {}, 1 << (10 + i % 3), 0.002)
        return obs.profile()

    p = both(run, (j_traffic, t_traffic))
    assert p["profileVersion"] == 1
    assert p["opMix"]["get"] == 0.9 and p["opMix"]["put"] == 0.1
    assert abs(p["interArrival"]["meanSecs"] - 0.05) < 1e-6
    assert abs(p["interArrival"]["opsPerSec"] - 20.0) < 0.01
    assert p["interArrival"]["cv"] == 0.0
    fr = [b["fraction"] for b in p["sizeDistribution"]["logTwoBuckets"]]
    assert abs(sum(fr) - 1.0) < 0.01
    assert p["popularity"]["topShares"][0] >= p["popularity"]["topShares"][-1]


def test_slow_peer_ranking():
    rng = np.random.default_rng(5)
    lat = rng.uniform(0.001, 0.004, 10), rng.uniform(0.2, 0.4, 10)

    def run(m):
        ph = m.PeerHealth(b"\x00" * 32)
        fast, slow, sick = b"\x01" * 32, b"\x02" * 32, b"\x03" * 32
        for lf, ls in zip(*lat):
            ph.record_piece_fetch(fast, float(lf), 4096)
            ph.record_piece_fetch(slow, float(ls), 4096)
        for _ in range(ph.open_after):
            ph.record_failure(sick)
        ph.record_piece_fetch(b"\x00" * 32, 9.0, 1)  # our own id never ranks
        return ph.piece_fetch_ranking()

    rows = both(run, (j_peer_health, t_peer_health))
    assert [r["peer"] for r in rows] == [(b"\x03" * 32).hex(), (b"\x02" * 32).hex(),
                                         (b"\x01" * 32).hex()]
    assert rows[0]["sick"] and rows[0]["state"] == "open"
    assert rows[1]["latMsecEwma"] > rows[2]["latMsecEwma"] and rows[1]["pieceFetches"] == 10
