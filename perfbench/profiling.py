"""The device trace of a window: `torch.profiler` over the card's
activity (CUPTI), reduced to the device's busy time, its kernels and
copies by name, and its idle time by what the benchmark's host spans
were doing while the card waited.

Every time here is clipped to the window.  The profiler stamps events
on the wall clock in nanoseconds; the host spans are on
`time.perf_counter`, mapped across by one pair of readings taken when
the trace starts.
"""

from __future__ import annotations

import time
from collections import defaultdict

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(event) -> str | None:
    """kernel, gpu_memcpy or gpu_memset for a device operation, else None.
    Profilers that do not name an event's activity are read by the names
    CUPTI gives copies and memsets."""
    if getattr(event, "is_user_annotation", lambda: False)():
        return None
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        kind = str(kind())
        return kind if kind in DEVICE_OPS else None
    name = event.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def start():
    """A running profiler of the card, or None where there is no card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return None
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof, time.time_ns() - time.perf_counter_ns()


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs: list[tuple[float, float]], ys: list[tuple[float, float]]) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def stop(handle, t0: float, t1: float, host_spans: list[tuple[str, float, float]]) -> dict | None:
    """Stop the profiler and reduce its device events in [t0, t1]
    (perf_counter seconds); None where nothing was traced."""
    if handle is None:
        return None
    import torch
    from torch.autograd import DeviceType

    prof, offset = handle
    torch.cuda.synchronize()
    prof.stop()
    events = [(e.name(), _kind(e), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return reduce(events, t0 * 1e9 + offset, t1 * 1e9 + offset,
                  [(n, a * 1e9 + offset, b * 1e9 + offset) for n, a, b in host_spans])


def reduce(events, w0: float, w1: float, host_spans) -> dict:
    """Device events (name, kind, start ns, end ns) and host spans (name,
    start ns, end ns) on one clock -> the window's device totals and its
    breakdown."""
    ops = []
    for name, kind, a, b in events:
        a, b = max(a, w0), min(b, w1)
        if kind is not None and b > a:
            ops.append((name, kind, a, b))
    window_s = (w1 - w0) / 1e9
    busy = _union([(a, b) for _n, _k, a, b in ops])
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_name: dict[str, float] = defaultdict(float)
    for name, _k, a, b in ops:
        by_name[name] += (b - a) / 1e9
    kernel_s = sum((b - a) for _n, k, a, b in ops if k != "gpu_memcpy") / 1e9
    copy_s = sum((b - a) for _n, k, a, b in ops if k == "gpu_memcpy") / 1e9
    # idle time, by the host span that was open across it
    idle, cur = [], w0
    for a, b in busy:
        if a > cur:
            idle.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        idle.append((cur, w1))
    spans_by_name: dict[str, list] = defaultdict(list)
    for name, a, b in host_spans:
        spans_by_name[name].append((a, b))
    gaps = {name: _overlap(idle, _union(iv)) / 1e9 for name, iv in spans_by_name.items()}
    any_span = _union([iv for ivs in spans_by_name.values() for iv in ivs])
    gaps["no_span_open"] = (sum(b - a for a, b in idle) - _overlap(idle, any_span)) / 1e9
    return {
        "window_s": window_s, "busy_s": busy_s, "kernel_s": kernel_s, "copy_s": copy_s,
        "events": len(ops), "by_name": dict(by_name),
        "breakdown": {
            "device_ops": sorted(([n, v] for n, v in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:10],
        },
    }
