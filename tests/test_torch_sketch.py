"""The port's streaming sketches (garage_tpu_torch/utils/sketch.py) held
to the reference module (garage_tpu/utils/sketch.py) on the same inputs,
made with numpy from a seed: every scenario of tests/test_sketch.py runs
through both, their outputs must be identical, and the port's must keep
the reference tests' guarantees (Space-Saving error bounds, the hard
memory bound, decay, merges, Count-Min bounds, the zipf fit)."""

from collections import Counter

import numpy as np
import pytest

from garage_tpu.utils import sketch as j_sketch
from garage_tpu_torch.utils import sketch as t_sketch

BOTH = [j_sketch, t_sketch]


def zipf_stream(n_keys=1000, n=50_000, s=1.2, seed=7):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** s
    idx = rng.choice(n_keys, size=n, p=w / w.sum())
    stream = [f"k{i}" for i in idx]
    return stream, Counter(stream)


def both(fn):
    """fn(module) for the reference and the port; the results must be
    equal, and the port's is returned."""
    ref, port = (fn(m) for m in BOTH)
    assert ref == port
    return port


def test_space_saving_error_bounds_on_zipfian_stream():
    stream, true = zipf_stream()

    def run(m):
        ss = m.SpaceSaving(64)
        for k in stream:
            ss.incr(k)
        return ss.top(), ss.total, ss.capacity, ss.estimate("never-seen"), ss.min_count()

    top, total, cap, unseen, min_count = both(run)
    for k, count, err in top:
        assert count - err <= true[k] <= count + 1e-9, (k, count, err)
        assert err <= total / cap + 1e-9
    got = {k for k, _c, _e in top[:10]}
    assert len(got & {k for k, _ in true.most_common(10)}) >= 8
    assert unseen == min_count


def test_space_saving_hard_memory_bound():
    def run(m):
        ss = m.SpaceSaving(32)
        for i in range(10_000):
            ss.incr(f"distinct-{i}")
            assert len(ss) <= 32
            assert len(ss._heap) <= 4 * 32 + 64 + 1  # lazy-heap bound
        return ss.total, ss.top()

    total, _top = both(run)
    assert total == 10_000


def test_space_saving_decay_window():
    def run(m):
        t = [0.0]
        ss = m.SpaceSaving(16, halflife=10.0, clock=lambda: t[0])
        for _ in range(1000):
            ss.incr("old-hot")
        t[0] = 20.0
        for _ in range(400):
            ss.incr("new-hot")
        top2, total = ss.top(2), ss.total
        t[0] = 120.0
        return top2, total, ss.estimate("new-hot"), dict((k, c) for k, c, _e in ss.top())

    top2, total, est, late = both(run)
    assert top2[0][0] == "new-hot", top2
    assert 200 <= dict((k, c) for k, c, _e in top2)["old-hot"] <= 300
    assert total < 1000 + 400
    assert est < 1.0 and abs(est - late["new-hot"]) < 1e-9


def test_space_saving_merges():
    rng = np.random.default_rng(3)
    pairs = [[(f"{p}{i}", int(rng.integers(1, 20))) for i in range(n)]
             for p, n in (("x", 10), ("y", 5), ("z", 8))]
    s1, t1 = zipf_stream(seed=1)
    s2, t2 = zipf_stream(seed=2)

    def run(m):
        def mk(ps):
            s = m.SpaceSaving(32)
            for k, n in ps:
                s.incr(k, n)
            return s

        a, b, c = (mk(p) for p in pairs)
        m1, m2 = a.merge(b).merge(c), a.merge(b.merge(c))
        assert m1.counts == m2.counts and m1.errors == m2.errors and m1.total == m2.total
        big = [m.SpaceSaving(64), m.SpaceSaving(64)]
        for ss, stream in zip(big, (s1, s2)):
            for k in stream:
                ss.incr(k)
        with pytest.raises(ValueError):
            big[0].merge(m.SpaceSaving(8))
        return dict(m1.counts), m1.total, big[0].merge(big[1]).top()

    counts, total, merged = both(run)
    assert total == sum(n for ps in pairs for _k, n in ps)
    assert counts["x0"] == pairs[0][0][1]
    true = t1 + t2
    assert len(merged) <= 64
    for k, count, err in merged:
        assert count + 1e-9 >= true[k] and count - err <= true[k] + 1e-9
    assert len({k for k, _c, _e in merged[:5]} & {k for k, _ in true.most_common(5)}) >= 4


def test_count_min_estimates_merge_and_decay():
    stream, true = zipf_stream(n=20_000)
    hot = [k for k, _ in true.most_common(20)]

    def run(m):
        cm = m.CountMin(width=1024, depth=4)
        for k in stream:
            cm.incr(k)
        other = m.CountMin(width=1024, depth=4)
        for _ in range(50):
            other.incr("k0")
        merged = cm.merge(other)
        with pytest.raises(ValueError):
            cm.merge(m.CountMin(width=512, depth=4))
        t = [0.0]
        dk = m.CountMin(width=256, depth=3, halflife=10.0, clock=lambda: t[0])
        for _ in range(800):
            dk.incr("hot")
        t[0] = 10.0
        dk.incr("hot")
        mid = dk.estimate("hot")
        t[0] = 30.0
        return ([cm.estimate(k) for k in hot], cm.total, cm.width, merged.estimate("k0"),
                cm.estimate("k0"), merged.total, other.total, mid, dk.estimate("hot"))

    ests, total, width, m_k0, k0, m_total, o_total, mid, late = both(run)
    for k, est in zip(hot, ests):
        assert est + 1e-9 >= true[k] and est - true[k] <= 4 * total / width
    assert abs(m_k0 - (k0 + 50)) < 1e-9 and m_total == total + o_total
    assert 380 <= mid <= 480 and late < 150


@pytest.mark.parametrize("counts", [
    [1000.0 / (r + 1) for r in range(20)], [50.0] * 20, [5.0, 3.0], [],
    list(np.random.default_rng(4).integers(1, 1000, 30).astype(float)),
])
def test_zipf_exponent_fit(counts):
    s = both(lambda m: m.zipf_exponent(counts))
    if len(counts) == 20 and counts[0] == 1000.0:
        assert 0.9 <= s <= 1.1
    elif counts == [50.0] * 20:
        assert s == 0.0
    elif len(counts) < 3:
        assert s is None
