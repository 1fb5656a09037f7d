"""Bounded-memory streaming sketches for traffic analytics.

The traffic observatory (rpc/traffic.py) must answer "which objects are
hot, how skewed is the keyspace" over millions of distinct keys without
storing millions of counters.  Two classic mergeable summaries:

  - `SpaceSaving` — top-K heavy hitters (Metwally, Agrawal & El Abbadi,
    "Efficient Computation of Frequent and Top-k Elements in Data
    Streams", ICDT 2005).  At most `capacity` tracked keys; for every
    key the stored count is an UPPER bound on its true (decayed) weight
    and `count - error` a lower bound; any key whose true weight exceeds
    total/capacity is guaranteed tracked.

  - `CountMin` — per-key frequency estimates over the whole keyspace
    (Cormode & Muthukrishnan, "An Improved Data Stream Summary: The
    Count-Min Sketch and its Applications", J. Algorithms 2005).
    `depth x width` counters; estimates are upper bounds with error
    <= e * total / width at probability 1 - e^-depth.

Both support:

  - exponential time-decay (`halflife` seconds): old traffic fades so
    "hot" means hot NOW, not hot since process start.  Decay is applied
    in lazy O(state) sweeps (at most ~16 per halflife), never per
    update — the S3 request path pays dict arithmetic only.
  - `merge()` for federation: combining two sketches keeps the
    upper/lower-bound guarantees (mergeable-summaries style); merging
    is exact (pointwise) whenever the union fits the capacity, so the
    associativity property tests can pin it without error slack.

Hashing is keyed BLAKE2b, deterministic across processes (Python's
builtin `hash` is salted per process and would break cross-node
merges).  Stdlib only — this rides the analyzer-grade import budget.
"""

from __future__ import annotations

import heapq
import math
import time
from hashlib import blake2b

__all__ = ["SpaceSaving", "CountMin", "zipf_exponent"]

# lazy-decay sweep granularity: state is rescaled at most this many
# times per halflife (each sweep is O(capacity) / O(width*depth))
_SWEEPS_PER_HALFLIFE = 16


class _Decayed:
    """Shared lazy exponential-decay bookkeeping."""

    def __init__(self, halflife: float | None, clock):
        if halflife is not None and halflife <= 0:
            raise ValueError("halflife must be positive (or None)")
        self.halflife = halflife
        self.clock = clock
        self._last_decay = clock()

    def _decay_factor(self) -> float | None:
        """Factor to rescale all state by, or None when it's not time
        yet.  Advances the decay anchor when a factor is returned."""
        if self.halflife is None:
            return None
        now = self.clock()
        dt = now - self._last_decay
        if dt < self.halflife / _SWEEPS_PER_HALFLIFE:
            return None
        self._last_decay = now
        return 0.5 ** (dt / self.halflife)


class SpaceSaving(_Decayed):
    """Space-Saving top-K summary with optional exponential decay.

    `counts[k]` is an upper bound on k's decayed weight; `errors[k]`
    bounds the overestimate (so `counts[k] - errors[k]` is a lower
    bound).  `len(counts) <= capacity` ALWAYS — the memory bound is
    structural, not amortized.
    """

    def __init__(
        self,
        capacity: int,
        halflife: float | None = None,
        clock=time.monotonic,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        super().__init__(halflife, clock)
        self.capacity = int(capacity)
        self.counts: dict[str, float] = {}
        self.errors: dict[str, float] = {}
        self.total = 0.0  # decayed total stream weight
        # lazy min-heap of (count, key): entries go stale when a key's
        # count grows; eviction pops/corrects until the top is accurate
        self._heap: list[tuple[float, str]] = []

    # --- decay ---------------------------------------------------------------

    def _maybe_decay(self) -> None:
        f = self._decay_factor()
        if f is None:
            return
        for k in self.counts:
            self.counts[k] *= f
            self.errors[k] *= f
        self.total *= f
        self._rebuild_heap()

    def _rebuild_heap(self) -> None:
        self._heap = [(c, k) for k, c in self.counts.items()]
        heapq.heapify(self._heap)

    # --- updates -------------------------------------------------------------

    def incr(self, key: str, by: float = 1.0) -> None:
        self._maybe_decay()
        self.total += by
        cur = self.counts.get(key)
        if cur is not None:
            self.counts[key] = cur + by
            heapq.heappush(self._heap, (cur + by, key))
        elif len(self.counts) < self.capacity:
            self.counts[key] = by
            self.errors[key] = 0.0
            heapq.heappush(self._heap, (by, key))
        else:
            # evict the true minimum; the newcomer inherits its count as
            # the classic Space-Saving overestimate
            min_count, min_key = self._accurate_min()
            del self.counts[min_key]
            del self.errors[min_key]
            heapq.heappop(self._heap)
            self.counts[key] = min_count + by
            self.errors[key] = min_count
            heapq.heappush(self._heap, (min_count + by, key))
        # stale-entry bound: hot keys push a heap entry per increment
        if len(self._heap) > 4 * self.capacity + 64:
            self._rebuild_heap()

    def _accurate_min(self) -> tuple[float, str]:
        """Top of the lazy heap with stale entries corrected in place."""
        while True:
            c, k = self._heap[0]
            cur = self.counts.get(k)
            if cur is None:
                heapq.heappop(self._heap)  # evicted earlier
                continue
            if cur != c:
                heapq.heapreplace(self._heap, (cur, k))
                continue
            return c, k

    # --- queries -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.counts)

    def min_count(self) -> float:
        """Upper bound on any UNTRACKED key's weight (0 below capacity)."""
        self._maybe_decay()
        if len(self.counts) < self.capacity or not self.counts:
            return 0.0
        return self._accurate_min()[0]

    def estimate(self, key: str) -> float:
        """Upper-bound weight estimate for `key`.  Applies the lazy
        decay first — a read-only consumer after a quiet period must
        see the same decayed scale top() reports."""
        self._maybe_decay()
        c = self.counts.get(key)
        return c if c is not None else self.min_count()

    def top(self, n: int | None = None) -> list[tuple[str, float, float]]:
        """[(key, count, error)] sorted by count desc (key asc ties —
        deterministic output keeps merges/tests reproducible)."""
        self._maybe_decay()
        items = sorted(
            ((k, c, self.errors[k]) for k, c in self.counts.items()),
            key=lambda t: (-t[1], t[0]),
        )
        return items if n is None else items[:n]

    # --- federation ----------------------------------------------------------

    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        """Combined summary (self unchanged).  Pointwise-exact when the
        key union fits `capacity`; beyond that, keeps the heaviest
        `capacity` keys with composed error bounds (a key untracked by
        one side contributes that side's min_count as both count and
        error — the mergeable-summaries upper-bound recipe)."""
        if (self.capacity, self.halflife) != (
            other.capacity, other.halflife,
        ):
            # a smaller-capacity side computes min_count against its own
            # capacity, which breaks the untracked-key bound for the
            # merged result — mirror CountMin's geometry check
            raise ValueError(
                "SpaceSaving merge requires identical capacity/halflife"
            )
        out = SpaceSaving(self.capacity, self.halflife, self.clock)
        m1, m2 = self.min_count(), other.min_count()
        union = set(self.counts) | set(other.counts)
        merged = []
        for k in union:
            c = self.counts.get(k, m1) + other.counts.get(k, m2)
            e = self.errors.get(k, m1) + other.errors.get(k, m2)
            merged.append((k, c, e))
        merged.sort(key=lambda t: (-t[1], t[0]))
        for k, c, e in merged[: self.capacity]:
            out.counts[k] = c
            out.errors[k] = e
        out.total = self.total + other.total
        out._rebuild_heap()
        return out


class CountMin(_Decayed):
    """Count-Min sketch with optional exponential decay.

    Estimates are upper bounds on the (decayed) weight; width/depth/seed
    must match for `merge()` (the hash family defines the cell layout).
    """

    def __init__(
        self,
        width: int = 1024,
        depth: int = 4,
        halflife: float | None = None,
        clock=time.monotonic,
        seed: bytes = b"garage-tpu-traffic",
    ):
        if width < 8 or depth < 1 or depth > 16:
            raise ValueError("want width >= 8 and 1 <= depth <= 16")
        super().__init__(halflife, clock)
        self.width = int(width)
        self.depth = int(depth)
        self.seed = seed
        self.rows: list[list[float]] = [
            [0.0] * self.width for _ in range(self.depth)
        ]
        self.total = 0.0

    def _indexes(self, key: str | bytes) -> list[int]:
        if isinstance(key, str):
            key = key.encode("utf-8", "surrogateescape")
        d = blake2b(key, digest_size=4 * self.depth, key=self.seed).digest()
        return [
            int.from_bytes(d[4 * i : 4 * i + 4], "big") % self.width
            for i in range(self.depth)
        ]

    def _maybe_decay(self) -> None:
        f = self._decay_factor()
        if f is None:
            return
        for row in self.rows:
            for i, v in enumerate(row):
                if v:
                    row[i] = v * f
        self.total *= f

    def incr(self, key: str | bytes, by: float = 1.0) -> None:
        self._maybe_decay()
        self.total += by
        for row, i in zip(self.rows, self._indexes(key)):
            row[i] += by

    def estimate(self, key: str | bytes) -> float:
        self._maybe_decay()
        return min(
            row[i] for row, i in zip(self.rows, self._indexes(key))
        )

    def merge(self, other: "CountMin") -> "CountMin":
        if (self.width, self.depth, self.seed) != (
            other.width, other.depth, other.seed,
        ):
            raise ValueError("CountMin merge requires identical geometry")
        out = CountMin(
            self.width, self.depth, self.halflife, self.clock, self.seed
        )
        for or_, r1, r2 in zip(out.rows, self.rows, other.rows):
            for i in range(self.width):
                v = r1[i] + r2[i]
                if v:
                    or_[i] = v
        out.total = self.total + other.total
        return out


def zipf_exponent(counts: list[float]) -> float | None:
    """Least-squares zipf skew estimate from rank-ordered counts: the
    slope of ln(count) on ln(rank).  `s ~ 0` is uniform traffic, `s >= 1`
    the classic heavy-skew regime.  None below 3 positive points (two
    points always fit exactly — that is measurement, not estimation)."""
    pts = [
        (math.log(rank), math.log(c))
        for rank, c in enumerate(
            (c for c in counts if c > 0), start=1
        )
    ]
    if len(pts) < 3:
        return None
    n = len(pts)
    mx = sum(x for x, _ in pts) / n
    my = sum(y for _, y in pts) / n
    var = sum((x - mx) ** 2 for x, _ in pts)
    if var <= 0:
        return None
    cov = sum((x - mx) * (y - my) for x, y in pts)
    return round(max(0.0, -cov / var), 4)
