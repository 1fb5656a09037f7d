"""Lightweight in-process metrics registry: counters, histograms (latency
buckets by default, or a family's own value buckets) and gauges (pushed,
or polled at scrape time).  The family names the codec layers record
are the reference package's, so one dashboard reads both."""

from __future__ import annotations

from collections import defaultdict

# 0.25 ms .. 8192 ms, log2-spaced (16 finite buckets)
BUCKETS = [0.00025 * (2 ** i) for i in range(16)]

# power-of-two count buckets (1 .. 65536): batch sizes, queue depths
SIZE_BUCKETS = [float(2 ** i) for i in range(17)]


class Metrics:
    def __init__(self) -> None:
        self.counters: dict[tuple, float] = defaultdict(float)
        # (name, labels) -> [count, sum, bucket_counts]
        self.durations: dict[tuple, list] = {}
        self.gauges: dict[tuple, float] = {}
        self._gauge_fns: dict[tuple, object] = {}
        # family name -> custom bucket bounds (absent = BUCKETS, seconds)
        self._family_buckets: dict[str, list[float]] = {}

    def incr(self, name: str, labels: tuple = (), by: float = 1) -> None:
        self.counters[(name, labels)] += by

    def set_buckets(self, name: str, buckets: list[float]) -> None:
        """Declare a value-histogram family with its own bucket bounds.
        Idempotent; must precede the first observe."""
        if name in self._family_buckets:
            return
        if any(k[0] == name for k in self.durations):
            raise ValueError(
                f"set_buckets({name!r}) after the family has samples"
            )
        self._family_buckets[name] = buckets

    def observe(self, name: str, labels: tuple, value: float) -> None:
        bs = self._family_buckets.get(name, BUCKETS)
        d = self.durations.get((name, labels))
        if d is None:
            d = self.durations[(name, labels)] = [0, 0.0, [0] * (len(bs) + 1)]
        d[0] += 1
        d[1] += value
        for i, ub in enumerate(bs):
            if value <= ub:
                d[2][i] += 1
                return
        d[2][-1] += 1

    def set_gauge(self, name: str, labels: tuple, value: float) -> None:
        self.gauges[(name, labels)] = value

    def register_gauge(self, name: str, labels: tuple, fn) -> None:
        """fn() is called at scrape time."""
        self._gauge_fns[(name, labels)] = fn

    def unregister_gauge(self, name: str, labels: tuple = ()) -> None:
        self._gauge_fns.pop((name, labels), None)
        self.gauges.pop((name, labels), None)

    def counter_family_sum(self, name: str, pred=None) -> float:
        """Sum a counter family across every label set (optionally only
        those where `pred(labels_tuple)` holds)."""
        return sum(
            v
            for (n, labels), v in self.counters.items()
            if n == name and (pred is None or pred(labels))
        )

    def family_merge(self, name: str) -> tuple[int, float, list[int]] | None:
        """Merge a histogram family across all its label sets into one
        (count, sum, per-bucket counts) triple."""
        merged: list | None = None
        for (n, _labels), (cnt, total, buckets) in self.durations.items():
            if n != name:
                continue
            if merged is None:
                merged = [0, 0.0, [0] * len(buckets)]
            merged[0] += cnt
            merged[1] += total
            for i, c in enumerate(buckets):
                merged[2][i] += c
        return None if merged is None else (merged[0], merged[1], merged[2])

    def _bucket_quantile(self, name: str, counts: list[int], total: int,
                         q: float) -> float:
        bs = self._family_buckets.get(name, BUCKETS)
        target = q * total
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                return bs[i] if i < len(bs) else float("inf")
        return float("inf")

    def family_quantile(self, name: str, q: float) -> float | None:
        """Approximate quantile over the MERGED family histogram."""
        m = self.family_merge(name)
        if m is None or m[0] == 0:
            return None
        return self._bucket_quantile(name, m[2], m[0], q)

    def quantile(self, name: str, labels: tuple, q: float) -> float | None:
        """Approximate quantile from the histogram (upper bucket bound)."""
        d = self.durations.get((name, labels))
        if d is None or d[0] == 0:
            return None
        return self._bucket_quantile(name, d[2], d[0], q)


registry = Metrics()
