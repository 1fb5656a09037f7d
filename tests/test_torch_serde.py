"""The port's serialization and CRDTs against the reference's.

`utils/serde.py` is the one msgpack codec of RPC frames, CRDTs and
persisted state: the port's `pack` must give the bytes of
`msgpack.packb(obj, use_bin_type=True)` and `unpack` must read what the
reference's reads, so port and reference nodes share one wire format.
The CRDTs (`Lww`, `LwwMap`) and the layout history merge must converge
to the same state in both packages on the same seeded operations, in
any merge order.
"""

import random

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from garage_tpu.rpc.layout import history as j_history
from garage_tpu.rpc.layout.types import NodeRole as JNodeRole
from garage_tpu.utils import crdt as j_crdt
from garage_tpu.utils import serde as j_serde
from garage_tpu_torch.rpc.layout import history as t_history
from garage_tpu_torch.rpc.layout.types import NodeRole as TNodeRole
from garage_tpu_torch.utils import crdt as t_crdt
from garage_tpu_torch.utils import serde as t_serde

scalars = (
    st.none() | st.booleans()
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=80)
)
keys = st.text(max_size=12) | st.integers(min_value=-1000, max_value=2**40) | st.binary(max_size=12)
values = st.recursive(
    scalars,
    lambda inner: st.lists(inner, max_size=6) | st.dictionaries(keys, inner, max_size=6),
    max_leaves=40,
)


@settings(max_examples=300, deadline=None)
@given(values)
def test_pack_bytes_equal_msgpack(obj):
    raw = t_serde.pack(obj)
    assert raw == msgpack.packb(obj, use_bin_type=True)
    assert raw == j_serde.pack(obj)


@settings(max_examples=300, deadline=None)
@given(values)
def test_unpack_round_trips(obj):
    raw = msgpack.packb(obj, use_bin_type=True)
    got = t_serde.unpack(raw)
    assert got == obj
    assert got == j_serde.unpack(raw)
    assert t_serde.pack(got) == raw


def test_unpack_reads_tuples_as_lists_and_int_keys():
    raw = msgpack.packb({1: (b"x", "y"), b"k": [None, True]}, use_bin_type=True)
    assert t_serde.unpack(raw) == {1: [b"x", "y"], b"k": [None, True]}


# --- CRDTs -----------------------------------------------------------------------


def _ops(seed, n=60):
    """Seeded register and map writes with explicit timestamps (ties
    included), split over three replicas."""
    rng = random.Random(seed)
    return [(rng.randrange(3), rng.choice(["a", "b", "c", b"d", 7]),
             rng.randrange(20), rng.choice([1, 2, "v", b"w", None, [3, 4]]))
            for _ in range(n)]


def _converge(mod, ops, order):
    regs = [mod.Lww.raw(0, 0) for _ in range(3)]
    maps = [mod.LwwMap() for _ in range(3)]
    for rep, k, ts, v in ops:
        regs[rep].merge(mod.Lww.raw(ts, v if not isinstance(v, list) else tuple(v)))
        maps[rep].merge(mod.LwwMap([(k, ts, v)]))
    reg, m = regs[order[0]], maps[order[0]]
    for i in order[1:]:
        reg.merge(regs[i])
        m.merge(maps[i])
    return t_serde.pack(reg.to_obj()), t_serde.pack(m.to_obj())


@pytest.mark.parametrize("seed", range(6))
def test_lww_and_lwwmap_merge_like_the_reference(seed):
    ops = _ops(seed)
    want = _converge(j_crdt, ops, [0, 1, 2])
    for order in ([0, 1, 2], [2, 1, 0], [1, 2, 0]):
        assert _converge(t_crdt, ops, order) == want


def _stage(h, node, ts, role):
    h.staging.roles.merge(type(h.staging.roles)([(node, ts, role and role.to_obj())]))


@pytest.mark.parametrize("seed", range(3))
def test_layout_history_merge_like_the_reference(seed):
    """Replica a applies version 1; replica b starts from a, applies
    version 2 with more nodes, and both stage further changes with
    seeded timestamps.  Merging either way converges, to the same bytes
    and digest in both packages."""
    rng = random.Random(100 + seed)
    nodes = [rng.randbytes(32) for _ in range(6)]
    caps = [(1 + rng.randrange(4)) * 10**11 for _ in nodes]
    ts = [1 + rng.randrange(50) for _ in range(8)]
    out = {}
    for name, mod, role in (("ref", j_history, JNodeRole), ("port", t_history, TNodeRole)):
        a = mod.LayoutHistory.initial(3)
        for i in range(3):
            _stage(a, nodes[i], ts[i], role(zone=f"dc{i}", capacity=caps[i]))
        a.apply_staged_changes()
        b = mod.LayoutHistory.from_obj(a.to_obj())
        for i in range(3, 5):
            _stage(b, nodes[i], ts[i], role(zone=f"dc{i % 3}", capacity=caps[i]))
        b.apply_staged_changes()
        _stage(b, nodes[0], ts[5], None)  # a staged removal
        _stage(a, nodes[5], ts[6], role(zone="dc1", capacity=caps[5]))
        _stage(a, nodes[0], ts[7], role(zone="dc2", capacity=caps[0]))
        ab = mod.LayoutHistory.from_obj(a.to_obj())
        assert ab.merge(b)
        ba = mod.LayoutHistory.from_obj(b.to_obj())
        assert ba.merge(a)
        assert t_serde.pack(ab.to_obj()) == t_serde.pack(ba.to_obj())
        assert ab.current().version == 2
        out[name] = (t_serde.pack(ab.to_obj()), ab.digest())
    assert out["port"] == out["ref"]
