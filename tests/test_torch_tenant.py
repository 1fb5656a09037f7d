"""The port's tenant observatory (garage_tpu_torch/rpc/tenant.py) held to
the reference module (garage_tpu/rpc/tenant.py) on the same inputs, made
with numpy from a seed: class resolution, bounded cardinality under
tenant churn, per-class burn math, shed class resolution, the mismatch
gate, the digest block, `[tenants]` config validation and the fairness
rollup of `tenants_response`.  Each scenario of tests/test_tenant.py that
needs no live node runs through both packages; the outputs must be
identical and the port's must keep the reference tests' guarantees.
The reference's whole file, live nodes and the 11-node acceptance
included, runs on the port in tests/test_torch_observatory_mirror.py."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from garage_tpu.rpc import telemetry_digest as j_digest
from garage_tpu.rpc import tenant as j_tenant
from garage_tpu.utils import config as j_config
from garage_tpu.utils import metrics as j_metrics
from garage_tpu_torch.rpc import telemetry_digest as t_digest
from garage_tpu_torch.rpc import tenant as t_tenant
from garage_tpu_torch.utils import config as t_config
from garage_tpu_torch.utils import metrics as t_metrics

# (tenant, config, metrics, telemetry_digest) of the reference, then the port
PKGS = [(j_tenant, j_config, j_metrics, j_digest), (t_tenant, t_config, t_metrics, t_digest)]


def both(fn):
    ref, port = (fn(*p) for p in PKGS)
    assert ref == port
    return port


def obs(tenant, metrics, topk=16):
    """A fresh, enabled observatory with its own metrics registry."""
    o = tenant.TenantObservatory(topk=topk, halflife=None, clock=lambda: 0.0)
    o.enabled = True
    o.registry = metrics.Metrics()
    return o


def test_class_for():
    def run(tenant, config, _m, _d):
        cfg = SimpleNamespace(tenants={
            "premium": config.TenantClassConfig(
                availability_target=99.99, latency_target_msec=250.0, keys=["GKPREM"]),
            "batch": config.TenantClassConfig(
                availability_target=99.0, latency_target_msec=5000.0, keys=["GKBATCH"]),
        })
        got = [tenant.class_for(cfg, k) for k in ("GKPREM", "GKBATCH", "GKWHO")]
        cfg.tenants["default"] = config.TenantClassConfig(
            availability_target=95.0, latency_target_msec=2000.0)
        return got + [tenant.class_for(cfg, "GKWHO"), tenant.class_for(SimpleNamespace(), "GKX")]

    prem, batch, who, who2, bare = both(run)
    for got, want in ((prem, ("premium", 0.9999, 0.25)), (batch, ("batch", 0.99, 5.0)),
                      (who, (t_tenant.DEFAULT_CLASS, 0.999, 1.0)),
                      (who2, (t_tenant.DEFAULT_CLASS, 0.95, 2.0))):
        assert got[0] == want[0] and got[1:] == pytest.approx(want[1:])
    assert bare[0] == t_tenant.DEFAULT_CLASS


def test_bounded_cardinality_under_tenant_churn():
    rng = np.random.default_rng(8)
    sizes = rng.integers(1, 1 << 16, 500).tolist()

    def run(tenant, _c, metrics, _d):
        o = obs(tenant, metrics)
        for _ in range(50):
            o.record_request("GKHOT", "get", 0, 100, 0.001, is_err=False)
        for i, size in enumerate(sizes):
            o.record_request(f"GKCHURN{i:04d}", "put", size, 0, 0.002, is_err=False)
            assert len(o.tenants) <= 16, "row dict outgrew the sketch cap"
        for _ in range(40):
            o.record_shed("GKSHEDONLY")
        return (o.tenants["GKHOT"]["ops"]["get"], o.tenants["GKSHEDONLY"]["shed"],
                len(o.tenants), o.snapshot(top_n=16))

    hot, shed, n, snap = both(run)
    assert hot == 50 and shed == 40 and n <= 16 and snap["trackedTenants"] <= 16
    assert {"GKHOT", "GKSHEDONLY"} <= {t["id"] for t in snap["tenants"]}


def test_burn_math_per_slo_class():
    def run(tenant, _c, metrics, _d):
        o = obs(tenant, metrics)
        batch, premium = ("batch", 0.99, 5.0), ("premium", 0.999, 0.1)
        for i in range(100):
            o.record_request("GKB", "get", 0, 10, 0.001, is_err=i < 2, tenant_class=batch)
            o.record_request("GKP", "get", 0, 10, 0.001, is_err=i < 2, tenant_class=premium)
            o.record_request("GKL", "get", 0, 10, 0.2 if i % 2 else 0.001, is_err=False,
                             tenant_class=premium)
        rows = {t["id"]: t["burn"] for t in o.snapshot(top_n=10)["tenants"]}
        c = o.registry.counters
        return rows, [c[(name, (("class", cls),))] for name, cls in (
            ("api_tenant_class_requests_total", "batch"),
            ("api_tenant_class_errors_total", "premium"),
            ("api_tenant_class_over_latency_total", "premium"))]

    burn, counts = both(run)
    assert burn["GKB"]["availability"] == pytest.approx(2.0)
    assert burn["GKP"]["availability"] == pytest.approx(20.0)
    assert burn["GKL"]["latency"] == pytest.approx(500.0) == burn["GKL"]["worst"]
    assert burn["GKB"]["latency"] == 0.0
    assert counts == [100, 2, 50]


def test_shed_class_resolution_and_mismatch_gate():
    def run(tenant, _c, metrics, _d):
        o = obs(tenant, metrics)
        o.class_resolver = lambda kid: "batch" if kid == "GKB" else None
        o.record_shed("GKB")
        o.record_shed("GKUNKNOWN")
        o.class_resolver = lambda kid: 1 / 0  # a broken resolver must not crash a shed
        o.record_shed("GKB")
        o.record_mismatch()
        o.record_mismatch()
        c = o.registry.counters
        out = [o.total_sheds, c[("api_tenant_class_sheds_total", (("class", "batch"),))],
               c[("api_tenant_class_sheds_total", (("class", tenant.DEFAULT_CLASS),))],
               o.mismatches, o.snapshot()["claimedMismatches"]]
        o.enabled = False
        o.record_mismatch()
        o.record_request("GKX", "get", 0, 0, 0.001, is_err=False)
        o.record_shed("GKX")
        return out + [o.mismatches, "GKX" in o.tenants, o.total_sheds]

    assert both(run) == [3, 1, 2, 2, 2, 2, False, 3]


def test_digest_fields_bounded_and_serializable():
    def run(tenant, _c, metrics, _d):
        o = obs(tenant, metrics, topk=32)
        for i in range(20):
            for _ in range(20 - i):
                o.record_request(f"GKT{i:02d}", "get", 10, 10, 0.001, is_err=(i == 0))
        o.record_shed("GKT00")
        o.record_mismatch()
        return o.digest_fields(rps=4.5, top_n=5)

    d = both(run)
    assert d["trk"] == 20 and d["ops"] == sum(range(1, 21))
    assert d["rps"] == 4.5 and d["shed"] == 1 and d["mm"] == 1
    assert len(d["rows"]) == 5 and d["rows"][0]["id"] == "GKT00"
    assert d["top1"] == pytest.approx(20 / d["ops"], abs=1e-4) and d["wburn"] > 0
    for r in d["rows"]:
        assert {"id", "cls", "ops", "rps", "by", "shed", "burn",
                "an", "abad", "ln", "lbad"} <= set(r)
    json.dumps(d)


BAD_TENANT_CONFIGS = [
    {"tenants": {"bad name!": {}}}, {"tenants": {"": {}}},
    {"tenants": {"a": {"availability_target": 100.0}}},
    {"tenants": {"a": {"availability_target": 0.0}}},
    {"tenants": {"a": {"latency_target_msec": 0}}},
    {"tenants": {"a": {"keys": ["GK1"]}, "b": {"keys": ["GK1"]}}},
    {"admin": {"tenant_topk": 4}}, {"admin": {"tenant_hog_share": 0.5}},
]


@pytest.mark.parametrize("bad", [None] + BAD_TENANT_CONFIGS)
def test_tenant_config_validation(bad):
    base = {"metadata_dir": "/tmp/x", "rpc_secret": "aa" * 32}
    if bad is None:
        def run(_t, config, _m, _d):
            ok = config.config_from_dict({**base, "tenants": {"premium": {
                "availability_target": 99.99, "latency_target_msec": 250.0, "keys": ["GK1"]}}})
            return (ok.tenants["premium"].keys, ok.admin.tenant_observatory,
                    ok.admin.tenant_topk, ok.admin.tenant_hog_share)

        assert both(run) == (["GK1"], True, 64, 3.0)
        return
    for _t, config, _m, _d in PKGS:
        with pytest.raises(ValueError):
            config.config_from_dict({**base, **bad})


def fake_garage(digest, config, tn_blocks, hog_share, digestless_peers):
    self_id = b"\x01" * 32
    peers = {bytes([i]) * 32: (SimpleNamespace(
        telemetry={"v": digest.DIGEST_VERSION, "tn": tn}), 0.0)
        for i, tn in enumerate(tn_blocks[1:], start=2)}
    for i in range(digestless_peers):
        peers[bytes([0x40 + i]) * 32] = (SimpleNamespace(telemetry=None), 0.0)
    return SimpleNamespace(
        node_id=self_id,
        config=SimpleNamespace(
            tenants={"batch": config.TenantClassConfig(availability_target=99.0),
                     "premium": config.TenantClassConfig(availability_target=99.99),
                     "standard": config.TenantClassConfig()},
            admin=SimpleNamespace(tenant_hog_share=hog_share)),
        system=SimpleNamespace(id=self_id, node_status=peers, expire_node_status=lambda: None,
                               netapp=SimpleNamespace(is_connected=lambda pid: True)),
        telemetry=SimpleNamespace(collect=lambda: {"v": digest.DIGEST_VERSION, "tn": tn_blocks[0]}),
    )


def test_fairness_rollup_on_synthetic_rows():
    def row(tid, cls, ops, an=0, abad=0):
        return {"id": tid, "cls": cls, "ops": ops, "rps": ops / 100.0, "by": ops * 100,
                "shed": 0, "burn": 0.0, "an": an, "abad": abad, "ln": 0, "lbad": 0}

    node = [row("GKA", "batch", 400, an=400, abad=8), row("GKB", "premium", 100, an=100),
            row("GKC", "standard", 100, an=100)]
    block = {"trk": 3, "ops": 600, "rps": 1.0, "shed": 0, "mm": 1, "top1": 0.5,
             "wburn": 0.0, "rows": node}

    def run(tenant, config, _m, digest):
        out = []
        for hog_share in (1.5, 3.0):
            g = fake_garage(digest, config, [block, block], hog_share, 1)
            out.append(tenant.tenants_response(g)["cluster"])
        return out

    c, c_high = both(run)
    assert len(c["nodes"]) == 3 and c["nodesReporting"] == 2
    assert [n for n in c["nodes"] if n["tenant"] is None]
    assert c["aggregate"]["ops"] == 1200 and c["aggregate"]["claimedMismatches"] == 2
    a = c["tenants"][0]
    assert [t["id"] for t in c["tenants"]] == ["GKA", "GKB", "GKC"]
    assert a["ops"] == 800 and a["nodesReporting"] == 2
    assert a["share"] == pytest.approx(800 / 1200, abs=1e-4)
    assert a["burn"]["availability"] == pytest.approx(2.0)
    f = c["fairness"]
    assert f["tenants"] == 3 and f["fairShare"] == pytest.approx(1 / 3, abs=1e-4)
    assert f["maxMedianRatio"] == pytest.approx(4.0) and f["worstBurn"] >= 2.0
    assert c["hog"]["id"] == "GKA" and c["hog"]["multiple"] == pytest.approx(2.0)
    assert c_high["hog"] is None
    json.dumps(c)
