"""The port's cluster layout (garage_tpu_torch/rpc/layout) computes the
reference's placement: the same staged roles give the same
`ring_assignment`, node order, partition size and digest, and so the
same nodes — in rank order — for every block hash.  Checked for the
11-node, 3-zone EC(8,3) cluster and the 3-node EC(2,1) cluster, then
after a second layout version that moves partitions."""

import random

import pytest

from garage_tpu.rpc.layout.history import LayoutHistory as JHistory
from garage_tpu.rpc.layout.types import NodeRole as JNodeRole
from garage_tpu_torch.rpc.layout.history import LayoutHistory as THistory
from garage_tpu_torch.rpc.layout.types import NodeRole as TNodeRole
from garage_tpu_torch.utils.serde import pack

CASES = {  # name: (nodes, zones, replication factor = k + m)
    "ec83_11_nodes_3_zones": (11, 3, 11),
    "ec21_3_nodes": (3, 1, 3),
}


def build(history_cls, role_cls, case, seed, grow=False):
    n, zones, rf = CASES[case]
    rng = random.Random(seed)
    ids = [rng.randbytes(32) for _ in range(n + 1)]
    caps = [(1 + rng.randrange(8)) * 10**11 for _ in ids]
    h = history_cls.initial(rf)

    def stage(i, ts):
        role = role_cls(zone=f"dc{i % zones}", capacity=caps[i])
        h.staging.roles.merge(type(h.staging.roles)([(ids[i], ts, role.to_obj())]))

    for i in range(n):
        stage(i, 10 + i)
    h.apply_staged_changes()
    if grow:  # a second version: one more node, in the first zone
        stage(n, 100)
        h.apply_staged_changes()
    return h, ids


@pytest.mark.parametrize("grow", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_assignment_matches_the_reference(case, seed, grow):
    jh, ids = build(JHistory, JNodeRole, case, seed, grow)
    th, _ = build(THistory, TNodeRole, case, seed, grow)
    jv, tv = jh.current(), th.current()
    assert tv.ring_assignment == jv.ring_assignment
    assert tv.node_id_vec == jv.node_id_vec
    assert tv.partition_size == jv.partition_size
    assert th.digest() == jh.digest()
    assert pack(th.to_obj()) == pack(jh.to_obj())
    rng = random.Random(seed + 50)
    for _ in range(64):
        h = rng.randbytes(32)
        assert th.read_nodes_of(h) == jh.read_nodes_of(h)
        assert th.write_sets_of(h) == jh.write_sets_of(h)
    # every partition holds rf distinct nodes
    rf = CASES[case][2]
    assert all(len(set(tv.nodes_of_partition(p))) == rf for p in range(256))
