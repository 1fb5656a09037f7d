"""Lightweight in-process metrics registry (reference: OpenTelemetry
meters exported via the admin Prometheus endpoint, src/util/metrics.rs +
doc/book/reference-manual/monitoring.md).

Three instrument kinds, rendered into Prometheus exposition text by the
admin API, no external deps:

  - counters                  incr(name, labels)
  - latency histograms        observe()/timer() — log2-spaced buckets from
                              0.25 ms to ~8 s plus +Inf, so p99 is visible
                              (the S3 latency target is a p99), rendered in
                              standard `_bucket{le=…}`/`_count`/`_sum` form
                              (`_sum` in seconds)
  - value histograms          set_buckets(name, SIZE_BUCKETS) declares a
                              family whose observations are plain values
                              (batch sizes, byte counts), bucketed on its
                              own scheme; `_sum` is in the family's unit
  - gauges                    set_gauge() for pushed values, or
                              register_gauge(name, labels, fn) for values
                              polled at scrape time (queue lengths,
                              backlogs — reference src/block/metrics.rs,
                              src/table/metrics.rs pattern)
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager as _contextmanager

# 0.25 ms .. 8192 ms, log2-spaced (16 finite buckets)
BUCKETS = [0.00025 * (2 ** i) for i in range(16)]

# power-of-two count buckets (1 .. 65536): batch sizes, queue depths —
# matches the log2 batching the TPU dispatch layer actually does
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
        """Declare a value-histogram family with its own bucket bounds
        (e.g. SIZE_BUCKETS).  Idempotent; must precede the first observe
        — existing samples were bucketed under the old bounds, so a late
        re-declaration would silently corrupt the family."""
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

    def timer(self, name: str, labels: tuple = (), lead: float = 0.0):
        """`lead` seconds are added to the observed duration — for time
        the caller already spent on the request before the timer could
        start (e.g. the admission queue wait ahead of request_metrics)."""
        return _Timer(self, name, labels, lead)

    def set_gauge(self, name: str, labels: tuple, value: float) -> None:
        self.gauges[(name, labels)] = value

    def register_gauge(self, name: str, labels: tuple, fn) -> None:
        """fn() is called at scrape time; exceptions drop the sample."""
        self._gauge_fns[(name, labels)] = fn

    def unregister_gauge(self, name: str, labels: tuple = ()) -> None:
        self._gauge_fns.pop((name, labels), None)
        self.gauges.pop((name, labels), None)

    # --- family aggregation (cluster telemetry digest, SLO tracker) ----------

    def counter_family_sum(self, name: str, pred=None) -> float:
        """Sum a counter family across every label set (optionally only
        those where `pred(labels_tuple)` holds) — e.g. total S3 requests
        regardless of method."""
        return sum(
            v
            for (n, labels), v in self.counters.items()
            if n == name and (pred is None or pred(labels))
        )

    def gauge_family_sum(self, name: str) -> float:
        """Sum a gauge family across label sets, calling registered
        scrape-time fns (a failing fn contributes 0, like render())."""
        total = sum(v for (n, _l), v in self.gauges.items() if n == name)
        for (n, _l), fn in list(self._gauge_fns.items()):
            if n != name:
                continue
            try:
                total += float(fn())
            # graft-lint: allow-swallow(a raising gauge fn means "no sample"; logging per scrape would spam)
            except Exception:  # noqa: BLE001
                continue
        return total

    def histogram_family_count(self, name: str, pred=None) -> int:
        """Total observations of a histogram family across label sets
        (optionally only those where `pred(labels_tuple)` holds) — e.g.
        how many canary probes errored, straight from the duration
        histogram's counts without a parallel counter family."""
        return sum(
            cnt
            for (n, labels), (cnt, _total, _buckets) in self.durations.items()
            if n == name and (pred is None or pred(labels))
        )

    def family_merge(self, name: str) -> tuple[int, float, list[int]] | None:
        """Merge a histogram family across all its label sets into one
        (count, sum, per-bucket counts) triple — the cluster digest wants
        ONE p99 for `api_s3_request_duration`, not one per method."""
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

    def family_quantile(self, name: str, q: float) -> float | None:
        """Approximate quantile over the MERGED family histogram."""
        m = self.family_merge(name)
        if m is None or m[0] == 0:
            return None
        bs = self._family_buckets.get(name, BUCKETS)
        target = q * m[0]
        acc = 0
        for i, c in enumerate(m[2]):
            acc += c
            if acc >= target:
                return bs[i] if i < len(bs) else float("inf")
        return float("inf")

    def family_count_over(self, name: str, threshold: float) -> tuple[int, int]:
        """(total observations, observations ABOVE `threshold`) for a
        merged histogram family.  The threshold snaps to the NEAREST
        bucket bound: with log2 buckets a 1000 ms target evaluates at
        1024 ms — the alternative (largest bound <= threshold, 512 ms)
        would score all healthy 600-900 ms traffic as over-target and
        blow the latency SLO budget for a met SLO.  The latency-SLO
        tracker's "requests slower than the p99 target" feed."""
        m = self.family_merge(name)
        if m is None:
            return (0, 0)
        bs = self._family_buckets.get(name, BUCKETS)
        cutoff = min(bs, key=lambda b: abs(b - threshold))
        under = 0
        for i, c in enumerate(m[2][:-1]):
            if bs[i] <= cutoff:
                under += c
        return (m[0], m[0] - under)

    def quantile(self, name: str, labels: tuple, q: float) -> float | None:
        """Approximate quantile from the histogram (upper bucket bound)."""
        d = self.durations.get((name, labels))
        if d is None or d[0] == 0:
            return None
        bs = self._family_buckets.get(name, BUCKETS)
        target = q * d[0]
        acc = 0
        for i, c in enumerate(d[2]):
            acc += c
            if acc >= target:
                return bs[i] if i < len(bs) else float("inf")
        return float("inf")

    def render(self) -> list[str]:
        """Prometheus exposition lines.  Every family gets a `# TYPE`
        declaration before its first sample (the registry knows the
        instrument kind), so the output survives a strict format lint —
        asserted by the metrics-lint test against a live node."""
        lines = []
        last = None
        for (name, labels), v in sorted(self.counters.items()):
            if name != last:
                lines.append(f"# TYPE {name} counter")
                last = name
            lines.append(f"{name}{_fmt(labels)} {v:g}")
        last = None
        for (name, labels), (n, total, buckets) in sorted(self.durations.items()):
            if name != last:
                lines.append(f"# TYPE {name} histogram")
                last = name
            bs = self._family_buckets.get(name, BUCKETS)
            acc = 0
            for i, c in enumerate(buckets[:-1]):
                acc += c
                le = (("le", f"{bs[i]:g}"),)
                lines.append(f"{name}_bucket{_fmt(labels + le)} {acc}")
            lines.append(f'{name}_bucket{_fmt(labels + (("le", "+Inf"),))} {n}')
            lines.append(f"{name}_count{_fmt(labels)} {n}")
            # Prometheus-standard `_sum` for every histogram (latency
            # families used to render a nonstandard `_seconds_total`,
            # which histogram_quantile-adjacent recording rules and
            # `rate(x_sum)/rate(x_count)` averages can't use)
            if name in self._family_buckets:
                # value histogram: the sum is in the family's own unit
                lines.append(f"{name}_sum{_fmt(labels)} {total:g}")
            else:
                lines.append(f"{name}_sum{_fmt(labels)} {total:.6f}")
        gauges = dict(self.gauges)
        for (name, labels), fn in self._gauge_fns.items():
            try:
                gauges[(name, labels)] = float(fn())
            # graft-lint: allow-swallow(a raising gauge fn means "no sample"; logging per scrape would spam)
            except Exception:  # noqa: BLE001 — a dead gauge must not kill scrape
                continue
        last = None
        for (name, labels), v in sorted(gauges.items()):
            if name != last:
                lines.append(f"# TYPE {name} gauge")
                last = name
            lines.append(f"{name}{_fmt(labels)} {v:g}")
        return lines


def _esc(v) -> str:
    """Prometheus label-value escaping.  Label values can carry
    attacker-controlled strings (the admission plane's per-tenant
    gauges use the pre-auth CLAIMED key id / URL bucket name): an
    unescaped `"` or newline would corrupt the whole exposition and
    make the node metrics-dark to the scraper."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in labels) + "}"


class _Timer:
    def __init__(self, m: Metrics, name: str, labels: tuple, lead: float = 0.0):
        self.m, self.name, self.labels = m, name, labels
        self.lead = lead

    def __enter__(self):
        self.t0 = time.perf_counter() - self.lead
        return self

    def __exit__(self, exc_type, exc, tb):
        self.m.observe(self.name, self.labels, time.perf_counter() - self.t0)
        if exc_type is not None:
            self.m.incr(self.name + "_errors", self.labels)
        return False


# the process-wide registry (one storage daemon per process)
registry = Metrics()


@_contextmanager
def request_metrics(prefix: str, method: str, span_name: str,
                    lead_secs: float = 0.0, **span_attrs):
    """Shared HTTP-frontend instrumentation: `<prefix>_request_counter`,
    `<prefix>_request_duration` histogram, and a root tracing span that
    parents the request's table/block sub-spans.  Used by the s3, k2v
    and web servers so the pattern can't drift between them.
    `lead_secs` back-dates the duration sample by time already spent on
    the request before this wrapper ran (admission queue wait): the
    histogram must report the latency the client saw, or queue buildup
    is invisible to the latency-SLO burn signal."""
    from .tracing import span

    lbl = (("method", method),)
    registry.incr(f"{prefix}_request_counter", lbl)
    with span(span_name, method=method, **span_attrs):
        with registry.timer(f"{prefix}_request_duration", lbl, lead=lead_secs):
            yield
