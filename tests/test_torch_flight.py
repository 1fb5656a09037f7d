"""The port's flight recorder and profiler (garage_tpu_torch/utils/flight.py,
utils/profiler.py) held to the reference modules of the same names:

  - the event-loop watchdog counts a blocked loop, records the stall in
    the lag histogram and logs a task dump with trace ids;
  - the slow-request ring drops roots under its threshold and keeps its
    top K, with the same record shape as the reference's;
  - flight events (`record_event`) land in the ring and the event bank
    with the reference's fields, and `slow_response` serializes both
    alike;
  - the sampling profiler attributes a hot function on the event loop
    (the reference's live-daemon profile endpoint test needs `api/`; the
    profiler under it is checked here directly), and its folded and
    speedscope outputs have the reference's shape.

Inputs that are data (event attributes, span counts) come from numpy
with a seed; the timings are the tests' own."""

import asyncio
import logging
import time

import numpy as np

from garage_tpu.utils import flight as j_flight
from garage_tpu.utils import profiler as j_profiler
from garage_tpu.utils import tracing as j_tracing
from garage_tpu_torch.utils import flight as t_flight
from garage_tpu_torch.utils import profiler as t_profiler
from garage_tpu_torch.utils import tracing as t_tracing
from garage_tpu_torch.utils.metrics import registry

FLIGHT = [(j_flight, j_tracing), (t_flight, t_tracing)]


def test_watchdog_counts_blocked_loop_and_dumps_tasks(caplog):
    key = ("event_loop_blocked_total", ())
    tr = t_tracing.Tracer()
    tr.sink = "http://sink.invalid"
    traced_id = {}

    async def traced():
        with tr.span("blocked-op") as s:
            traced_id["hex"] = s.trace_id.hex()
            await asyncio.sleep(10)

    async def main():
        wd = t_flight.EventLoopWatchdog(threshold=0.05, tick=0.02)
        wd.start()
        before = registry.counters[key]
        lurk = asyncio.create_task(asyncio.sleep(10), name="lurker-task")
        span_task = asyncio.create_task(traced(), name="traced-task")
        try:
            await asyncio.sleep(0.1)  # let the beat establish a baseline
            time.sleep(0.4)  # deliberately block the event loop
            await asyncio.sleep(0.1)  # the loop-side beat observes the lag
            assert registry.counters[key] == before + 1
            d = registry.durations[("event_loop_lag_seconds", ())]
            assert d[0] > 0 and d[1] >= 0.3
        finally:
            lurk.cancel()
            span_task.cancel()
            wd.stop()

    with caplog.at_level(logging.WARNING, logger="garage.flight"):
        asyncio.run(asyncio.wait_for(main(), 30))
    assert "event loop blocked" in caplog.text
    assert "lurker-task" in caplog.text
    assert "blocked in" in caplog.text
    assert f"trace={traced_id['hex']}" in caplog.text


def ring_records(flight, tracing, children: list[int]):
    """Slow-request ring of top 3 at 5 ms: one fast root, then one slow
    root per entry of `children` with that many child spans."""
    t = tracing.Tracer()
    rec = flight.SlowRequestRecorder(threshold_ms=5.0, top_k=3)
    t.add_hook(rec.on_span_end)
    try:
        assert t.enabled  # the hook alone enables span creation
        with t.span("fast-root"):
            pass
        assert rec.snapshot() == [] and not rec.pending
        for i, n in enumerate(children):
            with t.span(f"slow-{i}", idx=i) as s:
                for _ in range(n):
                    with t.span("child"):
                        pass
                # fake 50 ms, 10 ms more for each root: the top 3 are the
                # last three whatever the host's clock adds
                s.start_ns -= (50 + 10 * i) * 1_000_000
        assert not rec.pending  # roots finalize their trees
        assert t._buf == []  # hooks alone must not fill the export buffer
        return rec.snapshot()
    finally:
        t.remove_hook(rec.on_span_end)
        assert not t.enabled


def shape(records: list[dict]) -> list:
    """What two runs share: names, attributes, span names and parent
    structure (ids and clocks differ)."""
    return [(r["name"], r["attrs"], r.get("ok"), r.get("event", False),
             [s["name"] for s in r["spans"]],
             [s["parentSpanId"] is None for s in r["spans"]],
             sorted(r)) for r in records]


def test_slow_request_ring_is_bounded_and_thresholded():
    children = np.random.default_rng(9).integers(1, 4, 5).tolist()
    ref, port = (ring_records(f, t, children) for f, t in FLIGHT)
    assert len(port) == 3 and all(r["durationMs"] >= 5.0 for r in port)
    assert len(port[0]["spans"]) == 1 + children[int(port[0]["attrs"]["idx"])]
    assert shape(port) == shape(ref)


def test_flight_events_and_slow_response():
    rng = np.random.default_rng(10)
    events = [(f"ev-{i}", {"blocks": int(rng.integers(0, 1000)), "node": f"n{i}"},
               sev) for i, sev in enumerate(["info", "warn", "critical", "bogus"])]

    def run(flight):
        rec = flight.SlowRequestRecorder(threshold_ms=5.0, top_k=8)
        for name, attrs, sev in events:
            flight.record_event(name, attrs, recorder=rec, severity=sev)
        resp = flight.slow_response(rec)
        return resp, list(rec.events), flight.slow_response(None)

    (ref, ref_events, ref_off), (port, port_events, port_off) = (run(f) for f, _t in FLIGHT)
    assert port_off == ref_off == {"enabled": False, "thresholdMs": None, "topK": None,
                                   "requests": []}
    assert shape(port["requests"]) == shape(ref["requests"])
    assert [e["severity"] for e in port_events] == ["info", "warn", "critical", "info"]
    assert [e["severity"] for e in port_events] == [e["severity"] for e in ref_events]
    assert port["enabled"] and port["thresholdMs"] == 5.0 and port["topK"] == 8
    assert [r["attrs"] for r in port["requests"]] == [
        {k: str(v) for k, v in a.items()} for _n, a, _s in events]


def hot_spin_marker():
    """Deliberately hot function: its name must appear in the profile."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.01:
        sum(i * i for i in range(500))


def test_sampling_profiler_attributes_the_hot_loop():
    async def spin(stop: asyncio.Event) -> None:
        while not stop.is_set():
            hot_spin_marker()
            await asyncio.sleep(0)

    async def main(profiler):
        stop = asyncio.Event()
        task = asyncio.create_task(spin(stop))
        try:
            return await profiler.profile(0.4, hz=200)
        finally:
            stop.set()
            await task

    results = [asyncio.run(asyncio.wait_for(main(p), 30)) for p in (j_profiler, t_profiler)]
    ref, port = results
    assert port.samples > 10
    assert "hot_spin_marker" in port.folded()
    assert any("[event-loop]" in s for s in port.top_stacks(5))
    assert sorted(port.speedscope()) == sorted(ref.speedscope())
    assert t_flight.profile is t_profiler.profile  # re-exported, as in the reference
