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
  tpu_codec_transfer_duration{kernel}            host<->device copy secs (H):
                                                 the copies alone, the
                                                 wait for the kernels
                                                 left out
  tpu_codec_compute_duration{kernel}             kernel secs (H): CUDA
                                                 events on the card, the
                                                 host clock on the CPU
  tpu_codec_overlap_efficiency{kernel}           EWMA of wall / (transfer
                                                 + compute)
  tpu_compile_duration{cache}                    compile-event seconds (H):
                                                 one per nvcc build, and
                                                 one per first dispatch
                                                 of a cold (kernel,
                                                 padded bucket) shape
                                                 class
  tpu_compile_cache_hit_total{cache}             cache lookups answered
  tpu_compile_cache_miss_total{cache}            cache lookups that built
  tpu_mesh_engaged_total{kernel,platform,devices}  dispatches served by
                                                 the multi-entry mesh
                                                 fan-out
  block_codec_stage_duration{op,stage}           host secs of each use of
                                                 a codec-plane stage (H)
  block_codec_stage_blocks_total{op,stage}       blocks those uses carried
                                                 (pieces for `wrap`)

The stages (the `stage` label; `STAGES`, a closed catalogue: any other
name raises) time the host's part of the codec plane where it runs,
once per size or erasure-pattern group, never per block of a group:

  stack        EcCodec: `np.stack` of the group's shards (card path)
  h2d          EcCuda: the copy to the card and the pad
  kernels      EcCuda: the launches through the host's wait on the
               compute bracket's end event (`DispatchRecord.compute`)
  d2h          EcCuda: the copies back (`.cpu().numpy()`)
  unstack      EcCodec: the pieces' and hashes' `bytes()`, decode's joins
  verify_hash  BlockManager._verify_gathered: the content hashes
  wrap         wrap_piece: one stored piece (blocks = pieces)
  handoff      the batcher: a dispatch's wait for its worker thread to
               start it, plus its wait for the loop to resume it

`op` (encode | decode | reconstruct) labels every stage but the piece
store's two, `verify_hash` and `wrap`.  Each use always records into
both families, under one lock; with the tracer on (`utils/tracing.py`)
it is also a `codec:<stage>` span (attributes `op`, `blocks`, `bytes`)
under the span current where it runs, stamped on `time.time_ns`; not
`wrap`, a use a stored piece (`record_stage`), which the two families
alone carry.
`h2d` + `d2h` is what `tpu_codec_transfer_duration` times, so the
overlap gauge reads wall / (copies + compute).

The caches (the `cache` label):

  ec_recon_matrix      EcCuda's reconstruction bit-matrices, by erasure
                       pattern: a miss builds and uploads one
  ec_dispatch_bucket   a single-device encode/reconstruct dispatch: hit
                       when its batch is already a power-of-two bucket
                       (no pad rows), miss when it is padded
  ec_batch_bucket      the same rule for the fused encode + hash dispatch
  ec_apply             the kernel build cache (ops/_build.py) of K1's
  blake3_hasher        source and of K2's: hit when the digest-named
                       library is reused, miss when nvcc builds it; a
                       build's seconds are a compile event under the
                       same label.  These are the reference's names for
                       its jit caches of the same functions, so no
                       kernel name takes them and the reference's
                       dashboard lint allows them

A shape class's compile event is labelled with its kernel name, as in
the reference: on the card its wall is the first launch's cold cost
(caching-allocator growth, first-use module load).

The platform label is the tensor's device type, "cuda" or "cpu", or
"host" for the native host codec's dispatches (block/codec/ec.py), as
in the reference.

torch is imported where it is used, so the piece store and the batcher
record their stages without loading it.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext

from ..utils.metrics import SIZE_BUCKETS, registry
from ..utils.tracing import tracer

registry.set_buckets("tpu_codec_batch_size", SIZE_BUCKETS)

_platforms_seen: set[str] = set()

# (kernel, padded bucket) shape classes that have dispatched at least once
# in this process: the first dispatch of a class is a compile event,
# repeats record nothing.  The batcher's two lanes dispatch from two
# threads, so the check and the add are taken under a lock
_shape_seen: set[tuple[str, int]] = set()
_shape_lock = threading.Lock()

# per-kernel overlap-efficiency EWMA state
EWMA_ALPHA = 0.2
_overlap_ewma: dict[str, float] = {}

STAGES = ("stack", "h2d", "kernels", "d2h", "unstack", "verify_hash", "wrap", "handoff")
STAGE_OPS = ("encode", "decode", "reconstruct")
STORE_STAGES = ("verify_hash", "wrap")  # the piece store's: no `op` label
STAGE_DURATION = "block_codec_stage_duration"
STAGE_BLOCKS = "block_codec_stage_blocks_total"

# (stage, op) -> the families' labels, for every pair the catalogue has
_STAGE_LABELS = {
    (st, None): (("stage", st),) for st in STORE_STAGES
} | {
    (st, op): (("op", op), ("stage", st))
    for st in STAGES if st not in STORE_STAGES for op in STAGE_OPS
}
# the batcher's two lanes and the event loop record at once: each
# record's two updates are taken under one lock, so the counts stay exact
_stage_lock = threading.Lock()


def resolved_platform(where=None) -> str:
    """The platform label for a dispatch: the device type of `where` (a
    tensor, a `torch.device` or a device string) — "cuda" or "cpu" —
    else "unknown" (telemetry must never fail the math it observes)."""
    import torch

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


def runs_on_host(where) -> bool:
    """THE kernel wrappers' and entry points' device check: True for a
    CPU tensor or device (the plain version serves it), False for CUDA
    (the kernel launches); any other device raises, a refusal and not
    a fallback."""
    import torch

    dev = where.device if isinstance(where, torch.Tensor) else torch.device(where)
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}")


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


def mesh_engaged(kernel: str, platform: str, devices: int) -> None:
    """Count one dispatch that ran on the mesh fan-out, recorded after
    the fan-out returned (EcCuda._apply)."""
    registry.incr(
        "tpu_mesh_engaged_total",
        (("kernel", kernel), ("platform", platform), ("devices", str(devices))),
    )


def compile_event(cache: str, secs: float) -> None:
    """Record one compile event (wall seconds) for a cache/kernel family:
    an nvcc build (ops/_build.py) or the first dispatch of a cold shape
    class (`DispatchRecord._finish`)."""
    registry.observe("tpu_compile_duration", (("cache", cache),), secs)


def record_cache_event(cache: str, hit: bool) -> None:
    """Count one lookup of cache `cache` (the module docstring lists
    them): `tpu_compile_cache_hit_total` or `..._miss_total`."""
    registry.incr(
        "tpu_compile_cache_hit_total" if hit else "tpu_compile_cache_miss_total",
        (("cache", cache),),
    )


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


def _stage_labels(name: str, op: str | None) -> tuple:
    labels = _STAGE_LABELS.get((name, op))
    if labels is None:
        raise ValueError(
            f"no codec stage {name!r} with op {op!r}: the stages are {STAGES}, "
            f"each with an op of {STAGE_OPS} but {STORE_STAGES}, which take none"
        )
    return labels


def _record_stage(labels: tuple, secs: float, blocks: int) -> None:
    with _stage_lock:
        registry.observe(STAGE_DURATION, labels, secs)
        registry.incr(STAGE_BLOCKS, labels, blocks)


def record_stage(name: str, secs: float, blocks: int, op: str | None = None) -> None:
    """Record one use of stage `name` timed by the caller, and no span:
    for `wrap`, a use a stored piece, which as spans would crowd the
    exporter's buffer and run every span-end hook (flight recorder,
    latency X-ray) thousands of times a second."""
    _record_stage(_stage_labels(name, op), secs, blocks)


def _stage_attrs(op: str | None, blocks: int, nbytes: int) -> dict:
    attrs = {"blocks": blocks, "bytes": nbytes}
    if op is not None:
        attrs["op"] = op
    return attrs


class _clock:
    """The seconds of one `with` block, in `secs` once it has ended."""

    __slots__ = ("_t0", "secs")

    def __enter__(self) -> "_clock":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.secs = time.perf_counter() - self._t0
        return False


class stage(_clock):
    """Time one use of stage `name` (`STAGES`) over `blocks` blocks
    (pieces for `wrap`) and `nbytes` bytes, as a context manager: its
    seconds and blocks into `block_codec_stage_duration` /
    `block_codec_stage_blocks_total`, and, with the tracer on, a
    `codec:<name>` span under the current one.  An unknown stage, or an
    `op` its stage does not take, raises whether or not the tracer is
    on.  Each use is once a group; `record_stage` takes the per-piece
    `wrap`."""

    __slots__ = ("_labels", "_blocks", "_span")

    def __init__(self, name: str, blocks: int, op: str | None = None, nbytes: int = 0):
        self._labels = _stage_labels(name, op)
        self._blocks = blocks
        self._span = (tracer.span("codec:" + name, **_stage_attrs(op, blocks, nbytes))
                      if tracer.enabled else None)

    def __enter__(self) -> "stage":
        if self._span is not None:
            self._span.__enter__()
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        super().__exit__()
        _record_stage(self._labels, self.secs, self._blocks)
        return self._span is not None and self._span.__exit__(*exc)


class Handoff:
    """One dispatch's trip through a worker thread, the batcher's stage
    `handoff`: the wait from the hand-off until `run` starts the work in
    the worker, plus the wait from the work's return until the loop
    resumes the caller (`resumed`), recorded summed as one use.  With the
    tracer on each wait is a `codec:handoff` span of its own."""

    __slots__ = ("_labels", "_attrs", "_call", "_start", "_end")

    def __init__(self, op: str, blocks: int, nbytes: int = 0):
        self._labels = _stage_labels("handoff", op)
        self._attrs = _stage_attrs(op, blocks, nbytes)
        self._start = self._end = None
        self._call = time.perf_counter_ns()

    def run(self, fn, *args):
        """Call fn(*args) in the worker, stamping its start and return."""
        self._start = time.perf_counter_ns()
        try:
            return fn(*args)
        finally:
            self._end = time.perf_counter_ns()

    def resumed(self) -> None:
        """Record the two waits, once the caller runs again."""
        back = time.perf_counter_ns()
        waits = ((self._call, self._start), (self._end, back))
        _record_stage(self._labels, sum(b - a for a, b in waits) / 1e9,
                      self._attrs["blocks"])
        if tracer.enabled:
            offset = time.time_ns() - time.perf_counter_ns()
            for a, b in waits:
                tracer.record("codec:handoff", a + offset, b + offset, **self._attrs)


class DispatchRecord:
    """Per-dispatch handle yielded by `dispatch()`: the call site reports
    its pad geometry and brackets its transfer/compute phases; the exit
    path turns those into pad-waste counters and the overlap EWMA.

    On the card, `compute()` records a pair of CUDA events on the current
    stream; a dispatch that times its steps as stages has it wait on the
    end event, and the events are read at exit, by then complete.  Work
    launched on side streams (a mesh's entries) is brought inside the
    bracket by passing those streams to `compute()`."""

    __slots__ = ("kernel", "platform", "op", "batch", "requested", "padded",
                 "transfer_secs", "compute_secs", "_events")

    def __init__(self, kernel: str, platform: str, op: str | None = None, batch: int = 0):
        self.kernel = kernel
        self.platform = platform
        # the codec's op and the blocks asked for: the labels and counts
        # of the dispatch's stages (`h2d`, `kernels`, `d2h`)
        self.op = op
        self.batch = batch
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
    def transfer(self, name: str | None = None, nbytes: int = 0):
        """Bracket a host<->device copy (the copy to the card and its pad,
        or the copy back; the wait for the kernels is `compute`'s).  Named
        `h2d` or `d2h`, the copy is also a use of that stage over the
        dispatch's blocks and `nbytes` bytes, one reading of the clock
        for both."""
        timed = _clock() if name is None else stage(name, self.batch, self.op, nbytes)
        try:
            with timed:
                yield
        finally:
            self.transfer_secs += timed.secs
            registry.observe(
                "tpu_codec_transfer_duration", (("kernel", self.kernel),), timed.secs
            )

    def _observe_compute(self, dt: float) -> None:
        self.compute_secs += dt
        registry.observe(
            "tpu_codec_compute_duration", (("kernel", self.kernel),), dt
        )

    @contextmanager
    def compute(self, streams=(), nbytes: int | None = None):
        """Bracket the kernel launches.  `streams` are the side streams
        they run on besides the current one (None entries are skipped):
        each waits on the start event, and the current stream waits on
        each before the end event, so the bracket spans their work.  Only
        the "cuda" platform is timed by events; the CPU and the native
        host codec ("host") by the host clock.  Given `nbytes`, the
        bracket is also a use of the stage `kernels` over the dispatch's
        blocks and those bytes, and ends in the host's wait on its end
        event, so that a copy back after it times the copy alone."""
        with nullcontext() if nbytes is None else stage(
            "kernels", self.batch, self.op, nbytes
        ):
            if self.platform != "cuda":
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self._observe_compute(time.perf_counter() - t0)
                return
            import torch

            side = [s for s in streams if s is not None]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for s in side:
                s.wait_event(start)
            try:
                yield
            finally:
                current = torch.cuda.current_stream()
                for s in side:
                    current.wait_stream(s)
                end.record()
                self._events.append((start, end))
            if nbytes is not None:
                end.synchronize()

    def _finish(self, wall: float) -> None:
        # the native host codec ("host") pads nothing and has no cold
        # start of its own, so it never records a shape-class event
        if self.padded is not None and self.platform != "host":
            key = (self.kernel, self.padded)
            with _shape_lock:
                cold = key not in _shape_seen
                _shape_seen.add(key)
            if cold:
                compile_event(self.kernel, wall)
        for start, end in self._events:
            end.synchronize()  # already complete: the dispatch waited on it
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
def dispatch(kernel: str, platform: str, batch: int, nbytes: int, op: str | None = None):
    """Instrument one dispatch: counters + batch-size histogram on entry,
    duration histogram (and `_errors` counter) around the body.  Yields
    the DispatchRecord the call site feeds pad geometry and phases; a
    dispatch that times its steps as stages names the codec's `op`."""
    lbl = (("kernel", kernel), ("platform", platform))
    registry.incr("tpu_codec_dispatch_total", lbl)
    registry.incr("tpu_codec_bytes_total", lbl, nbytes)
    registry.observe("tpu_codec_batch_size", (("kernel", kernel),), float(batch))
    note_platform(platform)
    rec = DispatchRecord(kernel, platform, op, batch)
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


def reset_xray_state() -> None:
    """Forget the shape classes seen and the overlap EWMA, so the next
    dispatch of every class is cold again (tests that count compile
    events need a cold view of the process)."""
    with _shape_lock:
        _shape_seen.clear()
    _overlap_ewma.clear()


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


def probe_failure_summary() -> None:
    """The newest banked device-probe failure verdict, for the digest's
    `tpuProbe` key.  This package banks no probe profile, so there is
    never one: always None, the reference's answer for a box whose probe
    never failed (its version reads TPU probe profiles, which are not
    this package's)."""
    return None
