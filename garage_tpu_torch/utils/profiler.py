"""Sampling wall-clock profiler: attributed stacks from a live daemon.

Stdlib-only (the flight recorder's discipline): a background thread
samples `sys._current_frames()` — every thread's live stack — plus the
asyncio task set at a configurable Hz, aggregating collapsed stacks in
flamegraph.pl / speedscope form.  Because the sampler is a *thread*, it
keeps sampling while the event loop is wedged — the wedge IS the
profile, which is the point: event-loop starvation
("flakes under box load") stops being folklore and becomes attributed
stacks.

Three consumers:

  1. `profile(seconds, hz)` — on-demand runs behind admin
     `GET /v1/debug/profile?seconds=N` and `cli ... debug profile`.
  2. `SamplingProfiler` — the raw engine, also usable synchronously
     from a non-loop thread (the stall auto-capture path).
  3. `StallProfiler` — the opt-in `[admin] stall_profile` hook: when the
     event-loop watchdog (utils/flight.py) detects a stall it calls
     `on_stall(...)` from its MONITOR thread; a short burst of samples
     is captured right there (the wedged loop cannot help) and the top
     stacks ride a flight-recorder event (`loop-stall-profile`), so
     every `event_loop_blocked_total` increment leaves evidence.

The thread that owns the event loop is tagged `[event-loop]` in its
stack root: a profile whose event-loop thread spends its samples inside
codec math or zstd instead of `select()` is the starved-loop signature
(doc/monitoring.md §"Codec X-ray" runbook).

This module grew out of utils/flight.py, which re-exports the profiler
names unchanged — existing `flight.profile(...)` callers keep working.
"""

from __future__ import annotations

import asyncio
import collections
import sys
import threading
import time

# --- stack formatting helpers -------------------------------------------------


def _format_frame(frame) -> str:
    code = frame.f_code
    path = code.co_filename.replace("\\", "/").split("/")
    short = "/".join(path[-2:])
    # ';' is the folded-stack separator — keep it out of frame names
    name = code.co_name.replace(";", ",")
    return f"{name} ({short}:{frame.f_lineno})"


def _thread_stack(frame) -> list[str]:
    """Leaf frame -> root-first formatted stack."""
    out: list[str] = []
    while frame is not None:
        out.append(_format_frame(frame))
        frame = frame.f_back
    out.reverse()
    return out


def _task_frames(task) -> list:
    """Outermost-first suspended frames of an asyncio task, walking the
    cr_await chain.  Empty for a currently-RUNNING task (its frames show
    up in `sys._current_frames()` instead)."""
    frames = []
    coro = task.get_coro()
    seen = 0
    while coro is not None and seen < 64:
        seen += 1
        fr = getattr(coro, "cr_frame", None) or getattr(coro, "gi_frame", None)
        if fr is None:
            break  # running (or closed): the thread sampler owns it
        frames.append(fr)
        coro = getattr(coro, "cr_await", None) or getattr(coro, "gi_yieldfrom", None)
    return frames


def _task_label(task) -> str:
    coro = task.get_coro()
    name = getattr(coro, "__qualname__", None) or task.get_name()
    return f"task:{name}".replace(";", ",")


def _all_tasks(loop) -> set:
    """asyncio.all_tasks from another thread: the WeakSet can mutate
    mid-iteration on a live loop; retry a few times, give up quietly
    (a wedged loop — the interesting case — cannot mutate it)."""
    for _ in range(4):
        try:
            return asyncio.all_tasks(loop)
        except RuntimeError:
            continue
        # graft-lint: allow-swallow(diagnostics must never raise; sampler gives up quietly)
        except Exception:  # noqa: BLE001 — diagnostics must never raise
            break
    return set()


# --- sampling profiler --------------------------------------------------------


class ProfileResult:
    """Aggregated collapsed stacks from one profiling run."""

    def __init__(self, hz: int):
        self.hz = hz
        self.samples = 0  # sampling rounds completed
        self.stacks: collections.Counter = collections.Counter()

    def add(self, stack: tuple[str, ...]) -> None:
        self.stacks[stack] += 1

    def folded(self) -> str:
        """flamegraph.pl / speedscope folded-stack text, hottest first."""
        lines = [
            f"{';'.join(stack)} {count}"
            for stack, count in sorted(
                self.stacks.items(), key=lambda kv: -kv[1]
            )
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def top_stacks(self, n: int = 5) -> list[str]:
        """The n hottest collapsed stacks, "frames... count" form — the
        payload the stall auto-capture event carries (bounded: a flight
        record must stay a log line, not a flamegraph)."""
        return [
            f"{';'.join(stack)} {count}"
            for stack, count in sorted(
                self.stacks.items(), key=lambda kv: -kv[1]
            )[:n]
        ]

    def speedscope(self) -> dict:
        """speedscope 'sampled' profile (https://www.speedscope.app)."""
        frame_index: dict[str, int] = {}
        samples: list[list[int]] = []
        weights: list[int] = []
        for stack, count in self.stacks.items():
            samples.append(
                [frame_index.setdefault(f, len(frame_index)) for f in stack]
            )
            weights.append(count)
        total = sum(weights)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "name": "garage-tpu profile",
            "exporter": "garage-tpu flight recorder",
            "activeProfileIndex": 0,
            "shared": {"frames": [{"name": f} for f in frame_index]},
            "profiles": [
                {
                    "type": "sampled",
                    "name": f"{self.samples} rounds @ {self.hz} Hz",
                    "unit": "none",
                    "startValue": 0,
                    "endValue": total,
                    "samples": samples,
                    "weights": weights,
                }
            ],
        }


class SamplingProfiler:
    """One profiling run: a daemon thread sampling thread stacks + the
    asyncio task set at `hz` until the deadline.  `loop_ident` (the
    thread id that runs the event loop) tags that thread's stack root
    with `[event-loop]` so loop starvation is visible at a glance."""

    def __init__(self, loop, hz: int = 100, loop_ident: int | None = None):
        self.loop = loop
        self.loop_ident = loop_ident
        self.result = ProfileResult(hz)
        self._stop = False
        self._own_ident: int | None = None

    def run(self, seconds: float) -> None:
        self._own_ident = threading.get_ident()
        interval = 1.0 / self.result.hz
        deadline = time.monotonic() + seconds
        while not self._stop and time.monotonic() < deadline:
            self._sample()
            time.sleep(interval)

    def stop(self) -> None:
        self._stop = True

    def _sample(self) -> None:
        res = self.result
        res.samples += 1
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            if tid == self._own_ident:
                continue
            root = "thread:" + names.get(tid, str(tid)).replace(";", ",")
            if tid == self.loop_ident:
                root += " [event-loop]"
            res.add(tuple([root] + _thread_stack(frame)))
        # suspended asyncio tasks: where is everything parked?
        for task in _all_tasks(self.loop):
            try:
                frames = _task_frames(task)
            # graft-lint: allow-swallow(profiler samples at ~100 Hz; a vanished task is not news)
            except Exception:  # noqa: BLE001
                continue
            if not frames:
                continue  # running task, covered by the thread sample
            res.add(
                tuple([_task_label(task)] + [_format_frame(f) for f in frames])
            )


async def profile(seconds: float, hz: int = 100, loop=None) -> ProfileResult:
    """Profile this process for `seconds` without blocking the loop.
    Inputs are coerced and clamped here (seconds 0.05..60, hz 1..1000)
    so the admin HTTP and RPC front-ends share one bounds policy."""
    seconds = min(max(float(seconds), 0.05), 60.0)
    running = asyncio.get_running_loop()
    loop = loop or running
    # the awaiting thread IS the loop thread when profiling ourselves —
    # that ident gets the [event-loop] root tag
    loop_ident = threading.get_ident() if loop is running else None
    prof = SamplingProfiler(
        loop, hz=max(1, min(int(hz), 1000)), loop_ident=loop_ident
    )
    t = threading.Thread(
        target=prof.run, args=(float(seconds),),
        name="garage-profiler", daemon=True,
    )
    t.start()
    try:
        while t.is_alive():
            await asyncio.sleep(0.02)
    finally:
        prof.stop()
        t.join(timeout=2.0)
    return prof.result


# --- stall auto-capture -------------------------------------------------------


class StallProfiler:
    """Opt-in bridge from the event-loop watchdog to the profiler
    (`[admin] stall_profile = true`): every counted stall episode
    captures a short synchronous sample burst and records a
    `loop-stall-profile` flight event carrying the top stacks.

    `on_stall` runs on the WATCHDOG MONITOR THREAD while the loop is
    still wedged — the only moment the culprit is on-stack — so the
    burst is sampled inline (no thread spawn mid-incident), bounded by
    `seconds`, and rate-limited by `min_interval` (a loop thrashing in
    and out of stalls must not turn the profiler into the load)."""

    def __init__(
        self,
        seconds: float = 0.25,
        hz: int = 50,
        top: int = 5,
        min_interval: float = 30.0,
    ):
        self.seconds = float(seconds)
        self.hz = int(hz)
        self.top = int(top)
        self.min_interval = float(min_interval)
        self.captures = 0
        self._last = 0.0

    def on_stall(self, overdue: float, loop=None, loop_ident=None) -> None:
        now = time.monotonic()
        if now - self._last < self.min_interval:
            return
        self._last = now
        try:
            prof = SamplingProfiler(loop, hz=self.hz, loop_ident=loop_ident)
            prof.run(self.seconds)  # synchronous: already off-loop
            res = prof.result
            self.captures += 1
            from .flight import record_event

            record_event(
                "loop-stall-profile",
                {
                    "overdueMs": round(overdue * 1000, 1),
                    "samples": res.samples,
                    "hz": res.hz,
                    "topStacks": "\n".join(res.top_stacks(self.top)),
                },
                severity="warn",
            )
        # graft-lint: allow-swallow(stall diagnostics must never take the watchdog thread down)
        except Exception:  # noqa: BLE001
            return
