"""Device-offload telemetry: every codec dispatch leaves a metrics trail.

The shared recorder the coding and hashing wrappers (ops/ec_cuda.py) and
the block codec layer call around each dispatch.  The families keep the
reference package's names (garage_tpu/ops/telemetry.py), so one
dashboard reads either package:

  tpu_codec_dispatch_total{kernel,platform}      dispatches
  tpu_codec_bytes_total{kernel,platform}         payload bytes processed
  tpu_codec_batch_size{kernel}                   blocks/dispatch histogram
  tpu_codec_dispatch_duration{kernel,platform}   seconds histogram
  jax_backend_platform{platform}                 1 for each platform that
                                                 has served a dispatch
  tpu_codec_pad_requested_total{kernel}          batch rows asked for
  tpu_codec_pad_padded_total{kernel}             batch rows dispatched
  tpu_codec_pad_waste{kernel}                    1 - requested/padded
  tpu_codec_transfer_duration{kernel}            host<->device copy secs (H)
  tpu_codec_compute_duration{kernel}             kernel secs (H): CUDA
                                                 events on the card, the
                                                 host clock on the CPU
  tpu_codec_overlap_efficiency{kernel}           EWMA of wall / (transfer
                                                 + compute)
  tpu_compile_duration{cache}                    kernel build seconds (H)

The platform label is the tensor's device type, "cuda" or "cpu".
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from ..utils.metrics import SIZE_BUCKETS, registry

registry.set_buckets("tpu_codec_batch_size", SIZE_BUCKETS)

_platforms_seen: set[str] = set()

# per-kernel overlap-efficiency EWMA state
EWMA_ALPHA = 0.2
_overlap_ewma: dict[str, float] = {}


def resolved_platform(where=None) -> str:
    """The platform label for a dispatch: the device type of `where` (a
    tensor, a `torch.device` or a device string) — "cuda" or "cpu" —
    else "unknown" (telemetry must never fail the math it observes)."""
    if where is None:
        return "unknown"
    if isinstance(where, torch.Tensor):
        return where.device.type
    try:
        return torch.device(where).type
    except (RuntimeError, TypeError):
        return "unknown"


def is_host_platform(platform: str | None) -> bool:
    """THE definition of "this dispatch runs on the host" — the one
    backend-string comparison the codec surface routes through.
    Unresolved/unknown platforms count as host: never take the device
    path on a backend that could not even be named."""
    return platform is None or platform in ("cpu", "unknown", "")


def platforms_seen() -> list[str]:
    """Platforms that have served a dispatch in this process."""
    return sorted(_platforms_seen)


def note_platform(platform: str) -> None:
    """Register the scrape-time platform gauge once per platform."""
    if platform in _platforms_seen:
        return
    _platforms_seen.add(platform)
    registry.register_gauge(
        "jax_backend_platform", (("platform", platform),), lambda: 1.0
    )


def compile_event(cache: str, secs: float) -> None:
    """Record one build event (wall seconds) for a cache/kernel family;
    ops/_build.py reports each nvcc build here."""
    registry.observe("tpu_compile_duration", (("cache", cache),), secs)


def record_pad(kernel: str, requested: int, padded: int) -> None:
    """Account one dispatch's bucket padding: `requested` batch rows
    asked for, `padded` rows actually dispatched."""
    lbl = (("kernel", kernel),)
    registry.incr("tpu_codec_pad_requested_total", lbl, float(requested))
    registry.incr("tpu_codec_pad_padded_total", lbl, float(max(padded, requested)))
    req = registry.counters[("tpu_codec_pad_requested_total", lbl)]
    pad = registry.counters[("tpu_codec_pad_padded_total", lbl)]
    if pad > 0:
        registry.set_gauge(
            "tpu_codec_pad_waste", lbl, round(1.0 - req / pad, 4)
        )


class DispatchRecord:
    """Per-dispatch handle yielded by `dispatch()`: the call site reports
    its pad geometry and brackets its transfer/compute phases; the exit
    path turns those into pad-waste counters and the overlap EWMA.

    On the card, `compute()` records a pair of CUDA events on the current
    stream and never synchronises; the events are read at exit, after the
    device->host copy that ends every dispatch has synchronised."""

    __slots__ = ("kernel", "platform", "requested", "padded",
                 "transfer_secs", "compute_secs", "_events")

    def __init__(self, kernel: str, platform: str):
        self.kernel = kernel
        self.platform = platform
        self.requested: int | None = None
        self.padded: int | None = None
        self.transfer_secs = 0.0
        self.compute_secs = 0.0
        self._events: list = []

    def pad(self, requested: int, padded: int) -> None:
        """Report this dispatch's batch geometry (first call wins)."""
        if self.requested is not None:
            return
        self.requested, self.padded = int(requested), int(padded)
        record_pad(self.kernel, requested, padded)

    @contextmanager
    def transfer(self):
        """Bracket host<->device marshalling (pad, copies to the card, the
        blocking copy back)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.transfer_secs += dt
            registry.observe(
                "tpu_codec_transfer_duration", (("kernel", self.kernel),), dt
            )

    def _observe_compute(self, dt: float) -> None:
        self.compute_secs += dt
        registry.observe(
            "tpu_codec_compute_duration", (("kernel", self.kernel),), dt
        )

    @contextmanager
    def compute(self):
        """Bracket the kernel launches."""
        if is_host_platform(self.platform):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._observe_compute(time.perf_counter() - t0)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events.append((start, end))

    def _finish(self, wall: float) -> None:
        for start, end in self._events:
            end.synchronize()  # already complete: the copy back synchronised
            self._observe_compute(start.elapsed_time(end) / 1e3)
        self._events.clear()
        phases = self.transfer_secs + self.compute_secs
        if phases > 0 and wall > 0:
            eff = wall / phases
            prev = _overlap_ewma.get(self.kernel)
            ewma = eff if prev is None else (
                EWMA_ALPHA * eff + (1 - EWMA_ALPHA) * prev
            )
            _overlap_ewma[self.kernel] = ewma
            registry.set_gauge(
                "tpu_codec_overlap_efficiency",
                (("kernel", self.kernel),), round(ewma, 4),
            )


@contextmanager
def dispatch(kernel: str, platform: str, batch: int, nbytes: int):
    """Instrument one dispatch: counters + batch-size histogram on entry,
    duration histogram (and `_errors` counter) around the body.  Yields
    the DispatchRecord the call site feeds pad geometry and phases."""
    lbl = (("kernel", kernel), ("platform", platform))
    registry.incr("tpu_codec_dispatch_total", lbl)
    registry.incr("tpu_codec_bytes_total", lbl, nbytes)
    registry.observe("tpu_codec_batch_size", (("kernel", kernel),), float(batch))
    note_platform(platform)
    rec = DispatchRecord(kernel, platform)
    t0 = time.perf_counter()
    try:
        yield rec
    except BaseException:
        registry.observe(
            "tpu_codec_dispatch_duration", lbl, time.perf_counter() - t0
        )
        registry.incr("tpu_codec_dispatch_duration_errors", lbl)
        raise
    wall = time.perf_counter() - t0
    registry.observe("tpu_codec_dispatch_duration", lbl, wall)
    rec._finish(wall)


def _finite_quantile(q: float | None) -> float | None:
    """Clamp +Inf quantiles to 2x the largest latency bucket bound so the
    snapshot stays JSON-serialisable."""
    if q is None:
        return None
    return min(q, 16.384)


def codec_snapshot(r=None) -> dict:
    """One JSON-able view of the codec X-ray, computed from a metrics
    registry (default: the process registry), with the reference
    package's keys."""
    r = r or registry
    req = r.counter_family_sum("tpu_codec_pad_requested_total")
    pad = r.counter_family_sum("tpu_codec_pad_padded_total")
    cm = r.family_merge("tpu_compile_duration")
    ll99 = _finite_quantile(
        r.family_quantile("block_codec_batch_lane_linger", 0.99)
    )
    kernels: dict[str, dict] = {}
    for (name, labels), v in sorted(r.counters.items()):
        if name not in (
            "tpu_codec_pad_requested_total", "tpu_codec_pad_padded_total"
        ):
            continue
        kern = dict(labels).get("kernel", "")
        k = kernels.setdefault(
            kern, {"requested": 0, "padded": 0, "padWaste": 0.0,
                   "overlapEfficiency": None},
        )
        field = "requested" if name.endswith("requested_total") else "padded"
        k[field] += int(v)
    ovls = []
    for kern, k in kernels.items():
        if k["padded"]:
            k["padWaste"] = round(1.0 - k["requested"] / k["padded"], 4)
        g = r.gauges.get(
            ("tpu_codec_overlap_efficiency", (("kernel", kern),))
        )
        if g is not None:
            k["overlapEfficiency"] = round(g, 4)
            ovls.append(g)
    compile_by_cache: dict[str, dict] = {}
    lanes: dict[str, dict] = {}
    for (name, labels), (cnt, total, _b) in sorted(r.durations.items()):
        if name == "tpu_compile_duration":
            cache = dict(labels).get("cache", "")
            compile_by_cache[cache] = {
                "events": int(cnt), "secs": round(total, 6),
            }
        elif name == "block_codec_batch_lane_linger":
            ld = dict(labels)
            lane = lanes.setdefault(ld.get("lane", ""), {"flush": {}})
            p99 = _finite_quantile(r.quantile(name, labels, 0.99))
            lane["flush"][ld.get("flush", "")] = {
                "blocks": int(cnt),
                "lingerSecsTotal": round(total, 6),
                "lingerP99": round(p99, 6) if p99 is not None else None,
            }
    return {
        "dispatches": int(r.counter_family_sum("tpu_codec_dispatch_total")),
        "padWaste": round(1.0 - req / pad, 4) if pad else 0.0,
        "compileEvents": int(cm[0]) if cm else 0,
        "compileSecs": round(cm[1], 6) if cm else 0.0,
        "overlapEfficiency": (
            round(sum(ovls) / len(ovls), 4) if ovls else 0.0
        ),
        "laneLingerP99": round(ll99, 6) if ll99 is not None else 0.0,
        "platforms": platforms_seen(),
        "kernels": kernels,
        "compile": compile_by_cache,
        "lanes": lanes,
    }
