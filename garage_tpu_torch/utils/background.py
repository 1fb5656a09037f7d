"""Background worker runtime.

Mirrors reference src/util/background/ (mod.rs:16, worker.rs:41-59): workers
implement `work()` (one unit, returns its next state) and `wait_for_work()`
(sleep until something to do); a supervisor tracks per-worker state, last
error, and consecutive-error count, applying exponential backoff after
failures (worker.rs:188-232).  `BgVars` are runtime-tunable knobs exposed via
the `worker set`/`worker get` CLI (src/util/background/vars.rs).

asyncio-native: each worker is a task; the runner owns cancellation with an
exit deadline (reference worker.rs:19 — 8 s).
"""

from __future__ import annotations

import asyncio
import enum
import itertools
import logging
import time
import traceback
from typing import Any, Callable

logger = logging.getLogger("garage.background")

EXIT_DEADLINE_SEC = 8.0

# EWMA smoothing for per-worker iteration duration / throughput
EWMA_ALPHA = 0.25

# worker_state gauge encoding
_STATE_NUM = {"idle": 0, "busy": 1, "throttled": 2, "done": 3}

# gauge `id` label source: PROCESS-wide, not per-runner.  The metrics
# registry is a process-global singleton and tests run several in-process
# Garage nodes — per-runner ids would collide ((name, labels) keys would
# overwrite each other, and one node's shutdown would delete the others'
# worker families).
_gauge_ids = itertools.count(1)

def spawn(coro, name: str | None = None) -> asyncio.Task:
    """create_task with a strong reference held until completion and
    crash logging — delegates to the shared supervised-spawn registry
    (utils/aio.py), kept as an alias for its existing call sites."""
    from .aio import spawn_supervised

    return spawn_supervised(coro, name=name)


class WorkerState(enum.Enum):
    BUSY = "busy"  # did work, call work() again immediately
    THROTTLED = "throttled"  # busy but wait a given delay (value set aside)
    IDLE = "idle"  # call wait_for_work()
    DONE = "done"  # worker finished, exit


class Worker:
    """Subclass and override name/work/wait_for_work."""

    def name(self) -> str:
        return type(self).__name__

    def status(self) -> dict[str, Any]:
        """Freeform progress info for `worker info` (reference WorkerStatus)."""
        return {}

    async def work(self) -> WorkerState | tuple[WorkerState, float]:
        """Do one unit of work.  Return THROTTLED with a delay as
        (WorkerState.THROTTLED, seconds) to self-throttle."""
        raise NotImplementedError

    async def wait_for_work(self) -> None:
        """Sleep until there may be work; default polls every second."""
        await asyncio.sleep(1.0)

    def tranquility(self) -> int | None:
        """Current tranquility setting, for workers that have one
        (resync, scrub) — shown in `worker list`."""
        return None

    def queue_length(self) -> int | None:
        """Backlog behind this worker, if it drains one — exported as
        `worker_queue_length{worker=...}`.  The default recognizes the
        conventional status() keys; override for anything else."""
        st = self.status()
        for k in ("queue", "todo", "queued"):
            v = st.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return int(v)
        return None


class WorkerInfo:
    def __init__(self, name: str):
        self.name = name
        self.state: str = "idle"
        self.errors = 0
        self.consecutive_errors = 0
        self.last_error: str | None = None
        self.tranquility: int | None = None
        self.progress: dict[str, Any] = {}
        # per-iteration runtime stats (reference WorkerStatus deepening)
        self.iterations = 0
        self.last_duration_secs: float | None = None
        self.duration_ewma_secs: float | None = None
        self.throughput: float | None = None  # work() completions / sec, EWMA
        self.last_completed: float | None = None  # unix timestamp
        self._last_mono: float | None = None

    def note_iteration(self, duration: float) -> None:
        """Record one completed work() call (success or error)."""
        now_mono = time.monotonic()
        self.iterations += 1
        self.last_duration_secs = duration
        self.duration_ewma_secs = (
            duration
            if self.duration_ewma_secs is None
            else EWMA_ALPHA * duration + (1 - EWMA_ALPHA) * self.duration_ewma_secs
        )
        if self._last_mono is not None:
            gap = max(now_mono - self._last_mono, 1e-9)
            rate = 1.0 / gap
            self.throughput = (
                rate
                if self.throughput is None
                else EWMA_ALPHA * rate + (1 - EWMA_ALPHA) * self.throughput
            )
        self._last_mono = now_mono
        self.last_completed = time.time()


class BackgroundRunner:
    """Spawns and supervises workers (reference src/util/background/mod.rs)."""

    def __init__(self) -> None:
        self.workers: dict[int, tuple[Worker, WorkerInfo, asyncio.Task]] = {}
        self._next_id = 1
        self._stopping = False
        self._gauge_keys: dict[int, list[tuple]] = {}

    def spawn(self, worker: Worker) -> int:
        wid = self._next_id
        self._next_id += 1
        info = WorkerInfo(worker.name())
        self._register_worker_gauges(wid, worker, info)
        task = asyncio.create_task(
            self._run_worker(wid, worker, info), name=worker.name()
        )
        self.workers[wid] = (worker, info, task)
        return wid

    def _register_worker_gauges(self, wid: int, worker: Worker, info: WorkerInfo):
        """Registry-backed per-worker health families (replaces the old
        bare inline `worker_errors` gauge): errors, state, throughput,
        and queue length where the worker exposes one.  The `id` label
        keeps labelsets unique across same-named workers (a repair
        launched twice, or several in-process nodes) — it is a process-
        wide spawn sequence, not the per-runner `worker list` id."""
        from .metrics import registry

        lbl = (("worker", info.name), ("id", str(next(_gauge_ids))))
        keys = self._gauge_keys[wid] = []

        def reg(name, fn):
            registry.register_gauge(name, lbl, fn)
            keys.append((name, lbl))

        reg("worker_errors_total", lambda i=info: i.errors)
        reg("worker_state", lambda i=info: _STATE_NUM.get(i.state, -1))
        # fn raising on None drops the sample at scrape time
        reg("worker_throughput", lambda i=info: float(i.throughput))
        reg("worker_queue_length", lambda w=worker: int(w.queue_length()))

    def _unregister_worker_gauges(self, wid: int) -> None:
        from .metrics import registry

        for name, labels in self._gauge_keys.pop(wid, []):
            registry.unregister_gauge(name, labels)

    async def _run_worker(self, wid: int, worker: Worker, info: WorkerInfo) -> None:
        try:
            await self._work_loop(worker, info)
        finally:
            # a finished/cancelled worker must not keep exporting gauges
            # (each `repair` launch spawns fresh workers — without this,
            # a long-lived daemon accumulates dead-worker families and
            # pins the Worker objects via the gauge closures)
            self._unregister_worker_gauges(wid)

    async def _work_loop(self, worker: Worker, info: WorkerInfo) -> None:
        while not self._stopping:
            try:
                # time work() alone: status()/wait_for_work() must not
                # pollute the duration/throughput stats (an exception out
                # of a 30 s idle wait is not a 30 s work unit)
                t0 = time.perf_counter()
                try:
                    res = await worker.work()
                finally:
                    info.note_iteration(time.perf_counter() - t0)
                info.consecutive_errors = 0
                if isinstance(res, tuple):
                    state, delay = res
                else:
                    state, delay = res, 0.0
                info.state = state.value
                info.progress = worker.status()
                info.tranquility = worker.tranquility()
                if state == WorkerState.DONE:
                    return
                if state == WorkerState.THROTTLED and delay > 0:
                    await asyncio.sleep(delay)
                elif state == WorkerState.IDLE:
                    try:
                        await asyncio.wait_for(worker.wait_for_work(), timeout=30.0)
                    except asyncio.TimeoutError:
                        pass
            except asyncio.CancelledError:
                # shutdown cancelled us: end *cancelled* (not "done") so
                # reap/wait-side accounting sees a cancelled worker; the
                # runner's finally still unregisters the gauges
                raise
            except Exception as e:  # noqa: BLE001 — supervisor must survive
                info.errors += 1
                info.consecutive_errors += 1
                info.last_error = f"{e!r}"
                logger.warning(
                    "worker %s error: %s\n%s", info.name, e, traceback.format_exc()
                )
                # exponential backoff, capped (reference worker.rs:188-232)
                await asyncio.sleep(min(60.0, 2.0 ** min(info.consecutive_errors, 6)))

    def worker_info(self) -> dict[int, WorkerInfo]:
        return {wid: info for wid, (_w, info, _t) in self.workers.items()}

    async def shutdown(self) -> None:
        self._stopping = True
        tasks = [t for (_w, _i, t) in self.workers.values()]
        for t in tasks:
            t.cancel()
        if tasks:
            done, pending = await asyncio.wait(tasks, timeout=EXIT_DEADLINE_SEC)
            for t in pending:
                logger.warning("worker %s did not exit before deadline", t.get_name())
        # per-worker gauges are removed by each _run_worker's finally;
        # sweep whatever remains (tasks that missed the exit deadline)
        for wid in list(self._gauge_keys):
            self._unregister_worker_gauges(wid)


class BgVars:
    """Runtime-mutable named variables with getter/setter hooks
    (reference src/util/background/vars.rs)."""

    def __init__(self) -> None:
        self._vars: dict[str, tuple[Callable[[], str], Callable[[str], None]]] = {}

    def register_rw(
        self, name: str, get: Callable[[], str], set_: Callable[[str], None]
    ) -> None:
        self._vars[name] = (get, set_)

    def get(self, name: str) -> str:
        if name not in self._vars:
            raise KeyError(f"unknown variable {name!r}")
        return self._vars[name][0]()

    def set(self, name: str, value: str) -> None:
        if name not in self._vars:
            raise KeyError(f"unknown variable {name!r}")
        self._vars[name][1](value)

    def all(self) -> dict[str, str]:
        out = {}
        for k, (g, _s) in sorted(self._vars.items()):
            try:
                out[k] = g()
            except Exception as e:  # noqa: BLE001 — one dead var must not hide the rest
                out[k] = f"(unavailable: {e})"
        return out
