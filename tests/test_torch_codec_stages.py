"""The codec plane's stages (`ops/telemetry.py`: `stage`, `Handoff`,
`DispatchRecord.transfer` / `.compute`) on the CPU, with a CPU `EcCodec` at
`impl="xla"` (the card path through EcCuda's plain versions): the
catalogue is closed; each stage records once per size or
erasure-pattern group with exact block counts, in `EcCodec`, `EcCuda`,
`BlockManager._verify_gathered`, `wrap_piece` and the batcher; the
counts stay exact under concurrent recorders; with the tracer off no
span is built, with it on the `codec:*` spans nest under the open span
(a batcher's under the request whose entry heads the batch), `wrap` is
never a span, and the spans give `perfbench.profiling.reduce` each idle gap by stage.  Then the
benchmark's readers of the stage families (`perfbench/metrics/`), each
against a registry diff around a CPU run.

Tolerance: zero for counts; sums of seconds compared to 1e-9."""

import asyncio
import os
import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from garage_tpu_torch.block import codec_batch
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.block.codec_batch import CodecBatcher
from garage_tpu_torch.block.manager import BlockManager, wrap_piece
from garage_tpu_torch.ops import telemetry
from garage_tpu_torch.utils import tracing
from garage_tpu_torch.utils.data import blake2sum
from garage_tpu_torch.utils.metrics import Metrics
from perfbench import harness, profiling
from torch_mirror import time_limit

torch.set_num_threads(1)

_limit = time_limit(120)

K, M = 4, 2
BLOCK = 4096  # 1024 B pieces: the fused encode hashes them
DEVICE_STAGES = ("h2d", "kernels", "d2h")
CODEC_STAGES = ("stack",) + DEVICE_STAGES + ("unstack",)


@pytest.fixture(autouse=True)
def tracer_off(monkeypatch):
    """The tracer as a node with no sink and no flight recorder has it:
    off, whatever an earlier test in this worker left attached."""
    monkeypatch.setattr(tracing.tracer, "_hooks", [])
    monkeypatch.setattr(tracing.tracer, "sink", None)


@pytest.fixture
def reg(monkeypatch):
    """A private registry for the stage families and the batcher's
    dispatch counters, so counts are exact whatever else the worker ran."""
    r = Metrics()
    monkeypatch.setattr(telemetry, "registry", r)
    monkeypatch.setattr(codec_batch, "registry", r)
    return r


@pytest.fixture
def codec():
    return EcCodec(K, M, device="cpu")


@pytest.fixture
def spans():
    """Every span the tracer finishes while the test runs (the tracer on)."""
    seen = []
    tracing.tracer.add_hook(seen.append)
    yield seen
    tracing.tracer.remove_hook(seen.append)


def uses(r, stage, op=None) -> int:
    labels = (("stage", stage),) if op is None else (("op", op), ("stage", stage))
    d = r.durations.get((telemetry.STAGE_DURATION, labels))
    return d[0] if d else 0


def blocks(r, stage, op=None) -> float:
    labels = (("stage", stage),) if op is None else (("op", op), ("stage", stage))
    return r.counters.get((telemetry.STAGE_BLOCKS, labels), 0)


def pieces_of(codec, block):
    return codec.encode_batch_hashed([block], "xla")[0][0]


def manager_of(codec):
    return SimpleNamespace(codec=codec, block_config=SimpleNamespace(batch_impl="xla"))


# --- the catalogue -------------------------------------------------------------


@pytest.mark.parametrize("name,op", [
    ("scrub", None), ("scrub", "encode"), ("stack", None), ("kernels", "scrub"),
    ("wrap", "encode"), ("verify_hash", "decode"),
])
def test_the_catalogue_is_closed(reg, name, op):
    assert not tracing.tracer.enabled
    with pytest.raises(ValueError, match="no codec stage"):
        telemetry.stage(name, 1, op)
    with pytest.raises(ValueError, match="no codec stage"):
        telemetry.record_stage(name, 0.0, 1, op)
    assert not reg.durations and not reg.counters


def test_the_catalogue_is_the_documented_one():
    assert telemetry.STAGES == ("stack", "h2d", "kernels", "d2h", "unstack",
                                "verify_hash", "wrap", "handoff")
    with pytest.raises(ValueError):
        telemetry.Handoff("scrub", 1)
    for name in telemetry.STAGES:
        assert f"\n  {name} " in telemetry.__doc__


# --- once per group, exact blocks --------------------------------------------------


def _encode(codec):
    blocks_in = [os.urandom(BLOCK) for _ in range(5)] + [os.urandom(1000)] * 2
    codec.encode_batch_hashed(blocks_in, "xla")
    return {"encode": (2, 7)}  # two size groups, seven blocks


def _decode(codec):
    a, b = os.urandom(BLOCK), os.urandom(BLOCK)
    pa, pb = pieces_of(codec, a), pieces_of(codec, b)
    items = [({i: p for i, p in enumerate(pa) if i != 0}, BLOCK),
             ({i: p for i, p in enumerate(pb) if i != 0}, BLOCK),
             ({i: p for i, p in enumerate(pb) if i != 2}, BLOCK),
             ({i: p for i, p in enumerate(pa) if i < K}, BLOCK)]  # systematic
    assert codec.decode_batch(items, "xla") == [a, b, b, a]
    return {"decode": (2, 3)}  # two erasure patterns; the systematic join records nothing


def _reconstruct(codec):
    pa = pieces_of(codec, os.urandom(BLOCK))
    pb = pieces_of(codec, os.urandom(BLOCK))
    out = codec.reconstruct_batch([({i: p for i, p in enumerate(pa) if i != 1}, [1], BLOCK),
                                   ({i: p for i, p in enumerate(pb) if i != 1}, [1], BLOCK),
                                   ({i: p for i, p in enumerate(pb) if i != 5}, [5], BLOCK)],
                                  "xla")
    assert out[0][1] == pa[1] and out[2][5] == pb[5]
    return {"reconstruct": (2, 3)}


def _verify(codec):
    good, bad = os.urandom(BLOCK), os.urandom(BLOCK)
    items = [(blake2sum(x), {i: p for i, p in enumerate(pieces_of(codec, x)) if i != 3}, BLOCK)
             for x in (good, bad)]
    items[1][1][0] = bytes(BLOCK // K)  # a corrupt survivor
    assert BlockManager._verify_gathered(manager_of(codec), items) == [True, False]
    return {"decode": (1, 2), "verify_hash": (1, 2)}


def _wrap(_codec):
    for _ in range(3):
        wrap_piece(BLOCK, b"p" * 1024, b"h" * 32)
    wrap_piece(BLOCK, b"p" * 1024)  # hashed on the host
    return {"wrap": (4, 4)}


@pytest.mark.parametrize("call", [_encode, _decode, _reconstruct, _verify, _wrap],
                         ids=lambda f: f.__name__[1:])
def test_each_stage_records_once_per_group(reg, codec, call):
    want = call(codec)
    # each input `pieces_of` made was an encode of one block
    made = {"_decode": 2, "_reconstruct": 2, "_verify": 2}.get(call.__name__, 0)
    if made:
        want["encode"] = (made, made)
    got = {}
    for (name, labels), (n, _s, _b) in reg.durations.items():
        if name == telemetry.STAGE_DURATION:
            lb = dict(labels)
            got.setdefault(lb.get("op", lb["stage"]), {})[lb["stage"]] = (
                n, reg.counters[(telemetry.STAGE_BLOCKS, labels)])
    assert got == {
        what: {what: counts} if what in telemetry.STORE_STAGES
        else {st: counts for st in CODEC_STAGES}
        for what, counts in want.items()
    }


def test_the_host_backend_records_no_stage(reg, codec):
    codec.encode_batch_hashed([os.urandom(BLOCK)] * 3, "host")
    codec.decode_batch([({i: bytes(1024) for i in range(1, K + 1)}, BLOCK)], "host")
    assert not any(name.startswith("block_codec_stage") for name, _l in reg.durations)


def test_copies_time_apart_from_the_kernels(reg, codec):
    """`tpu_codec_transfer_duration` is the copies alone: one observation
    a copy, each the `h2d` or `d2h` stage's own reading; the kernels'
    stage holds the compute bracket."""
    codec.encode_batch_hashed([os.urandom(BLOCK)] * 3, "xla")
    n, transfer, _b = reg.durations[("tpu_codec_transfer_duration", (("kernel", "ec_encode_hash"),))]
    copies = [reg.durations[(telemetry.STAGE_DURATION, (("op", "encode"), ("stage", s)))]
              for s in ("h2d", "d2h")]
    assert n == 2 and all(c[0] == 1 for c in copies)
    assert transfer == pytest.approx(sum(c[1] for c in copies), rel=1e-12)
    kernels = reg.durations[(telemetry.STAGE_DURATION, (("op", "encode"), ("stage", "kernels")))]
    compute = reg.durations[("tpu_codec_compute_duration", (("kernel", "ec_encode_hash"),))]
    assert kernels[0] == compute[0] == 1 and kernels[1] >= compute[1]


# --- concurrency: exact counts, one handoff a dispatch -------------------------------


def _degraded(codec):
    """A block and its pieces less one data piece: a degraded read."""
    block = os.urandom(BLOCK)
    return block, {i: p for i, p in enumerate(pieces_of(codec, block)) if i != 1}


async def _two_lanes(codec, n_encodes, n_decodes, degraded):
    """n_encodes blocks through the encode lane and n_decodes degraded
    reads through the decode lane, all in flight at once."""
    block, pieces = degraded
    batcher = CodecBatcher(codec, impl="xla", max_blocks=4, linger_msec=1.0)
    try:
        enc = [batcher.encode(os.urandom(BLOCK)) for _ in range(n_encodes)]
        dec = [batcher.decode(dict(pieces), BLOCK) for _ in range(n_decodes)]
        out = await asyncio.gather(*enc, *dec)
    finally:
        await batcher.close()
    assert all(o == block for o in out[n_encodes:])


def test_counts_stay_exact_while_two_lanes_dispatch(reg, codec):
    degraded = _degraded(codec)
    reg.durations.clear()
    reg.counters.clear()
    asyncio.run(_two_lanes(codec, 37, 23, degraded))
    for st in CODEC_STAGES:
        assert blocks(reg, st, "encode") == 37 and blocks(reg, st, "decode") == 23
        assert uses(reg, st, "encode") == uses(reg, "stack", "encode")
        assert uses(reg, st, "decode") == uses(reg, "stack", "decode")
    assert blocks(reg, "handoff", "encode") == 37 and blocks(reg, "handoff", "decode") == 23


def test_handoff_is_recorded_once_per_dispatch(reg, codec):
    asyncio.run(_two_lanes(codec, 9, 6, _degraded(codec)))
    enc = sum(v for (n, _l), v in reg.counters.items() if n == "block_codec_batch_dispatch_total")
    dec = sum(v for (n, _l), v in reg.counters.items()
              if n == "block_codec_batch_decode_dispatch_total")
    assert enc >= 3 and dec >= 2  # max_blocks 4
    assert uses(reg, "handoff", "encode") == enc
    assert uses(reg, "handoff", "decode") == dec
    assert reg.durations[(telemetry.STAGE_DURATION,
                          (("op", "encode"), ("stage", "handoff")))][1] > 0


def test_concurrent_records_lose_no_update(reg):
    """More recorder threads than cores, switching every microsecond."""
    threads, each = 2 * (os.cpu_count() or 4), 1500
    switch = sys.getswitchinterval()

    def work():
        for _ in range(each):
            telemetry.record_stage("wrap", 0.0, 1)
            with telemetry.stage("stack", 2, "encode"):
                pass

    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    assert uses(reg, "wrap") == blocks(reg, "wrap") == threads * each
    assert uses(reg, "stack", "encode") == threads * each
    assert blocks(reg, "stack", "encode") == 2 * threads * each


# --- the tracer: off builds nothing, on nests under the open span ---------------------


def _everything(codec):
    _encode(codec)
    _decode(codec)
    _reconstruct(codec)
    _verify(codec)
    _wrap(codec)
    asyncio.run(_two_lanes(codec, 5, 3, _degraded(codec)))


def test_tracer_off_builds_no_span(reg, codec, monkeypatch):
    built, called = [], []

    class Counted(tracing.Span):
        def __init__(self, *a, **kw):
            built.append(a[0])
            super().__init__(*a, **kw)

    monkeypatch.setattr(tracing, "Span", Counted)
    tracing.tracer.add_hook(called.append)
    tracing.tracer.remove_hook(called.append)
    assert not tracing.tracer.enabled
    _everything(codec)
    assert built == [] and called == []
    assert uses(reg, "handoff", "encode") > 0 and uses(reg, "wrap") > 0


def test_tracer_on_nests_codec_spans_under_the_open_span(reg, codec, spans):
    async def main():
        with tracing.tracer.span("request") as outer:
            await asyncio.to_thread(_encode, codec)
            await asyncio.to_thread(_verify, codec)
            await asyncio.to_thread(_reconstruct, codec)
            _wrap(codec)
        return outer

    outer = asyncio.run(main())
    codec_spans = [s for s in spans if s.name.startswith("codec:")]
    traced = set(telemetry.STAGES) - {"handoff", "wrap"}
    assert {s.name for s in codec_spans} == {f"codec:{st}" for st in traced}
    for s in codec_spans:
        assert s.parent_id == outer.span_id and s.trace_id == outer.trace_id
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        assert {"blocks", "bytes"} <= set(s.attrs)
        assert ("op" in s.attrs) == (s.name[6:] not in telemetry.STORE_STAGES)
    # one span a use of each traced stage; `wrap` records its uses alone
    for st in telemetry.STAGES:
        n = sum(1 for s in codec_spans if s.name == f"codec:{st}")
        recorded = sum(d[0] for (name, lb), d in reg.durations.items()
                       if name == telemetry.STAGE_DURATION and dict(lb)["stage"] == st)
        assert n == (recorded if st in traced else 0)
    assert uses(reg, "wrap") == 4


def test_batcher_spans_file_under_the_request_they_serve(reg, codec, spans):
    """A batcher first used inside request A goes on to serve request B:
    B's dispatches file their spans under B, none under A, and each
    handoff is two spans, its two waits."""
    degraded = _degraded(codec)
    batcher = None

    async def request(name):
        with tracing.tracer.span(name) as req:
            block, pieces = degraded
            out = await asyncio.gather(
                *[batcher.encode(os.urandom(BLOCK)) for _ in range(5)],
                *[batcher.decode(dict(pieces), BLOCK) for _ in range(3)])
            assert out[5:] == [block] * 3
        return req

    async def main():
        nonlocal batcher
        batcher = CodecBatcher(codec, impl="xla", max_blocks=4, linger_msec=1.0)
        try:
            return [await request("A"), await request("B")]
        finally:
            await batcher.close()

    a, b = asyncio.run(main())
    codec_spans = [s for s in spans if s.name.startswith("codec:") and s.start_ns >= a.start_ns]
    assert {s.name for s in codec_spans} == {f"codec:{st}" for st in CODEC_STAGES + ("handoff",)}
    for req in (a, b):
        mine = [s for s in codec_spans if req.start_ns <= s.start_ns <= req.end_ns]
        assert mine and all(s.trace_id == req.trace_id and s.parent_id == req.span_id
                            for s in mine)
    assert len(codec_spans) == sum(s.trace_id in (a.trace_id, b.trace_id) for s in codec_spans)
    assert sum(s.name == "codec:handoff" for s in codec_spans) == 2 * (
        uses(reg, "handoff", "encode") + uses(reg, "handoff", "decode"))


def test_spans_give_reduce_each_idle_gap_by_stage(reg, codec, spans):
    """The device is busy exactly under each `codec:kernels` span: every
    other stage's spans are idle time, which `reduce` files under them."""
    with tracing.tracer.span("window") as window:
        _encode(codec)
        _reconstruct(codec)
    host = [(s.name, s.start_ns, s.end_ns) for s in spans if s.name.startswith("codec:")]
    device = [("gf_bitplane_kernel", "kernel", a, b) for n, a, b in host if n == "codec:kernels"]
    out = profiling.reduce(device, window.start_ns, window.end_ns, host)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["codec:kernels"] == 0.0
    for stage in ("stack", "h2d", "d2h", "unstack"):
        want = sum(b - a for n, a, b in host if n == f"codec:{stage}") / 1e9
        assert gaps[f"codec:{stage}"] == pytest.approx(want, abs=1e-9)
    busy = sum(b - a for _n, _k, a, b in device) / 1e9
    assert out["busy_s"] == pytest.approx(busy, abs=1e-9)


# --- the benchmark's readers of the stage families ----------------------------------


def _ingest(codec):
    async def main():
        batcher = CodecBatcher(codec, impl="xla", max_blocks=4, linger_msec=1.0)
        try:
            for pieces, hashes in await asyncio.gather(
                    *[batcher.encode(os.urandom(BLOCK)) for _ in range(10)]):
                for p, h in zip(pieces, hashes):
                    wrap_piece(BLOCK, p, h)
        finally:
            await batcher.close()

    asyncio.run(main())


def _repair(codec):
    blocks_in = [os.urandom(BLOCK) for _ in range(6)]
    items = [(blake2sum(x), {i: p for i, p in enumerate(pieces_of(codec, x)) if i != j % (K + M)},
              BLOCK) for j, x in enumerate(blocks_in)]
    ok = BlockManager._verify_gathered(manager_of(codec), items)
    recs = codec.reconstruct_batch([(p, [j % (K + M)], n) for j, (_h, p, n) in enumerate(items)],
                                   "xla")
    for j, rec in enumerate(recs):
        wrap_piece(BLOCK, rec[j % (K + M)])
    assert all(ok)


@pytest.fixture(scope="module")
def diffs():
    """A RegistryDiff around an ingest-like and a repair-like CPU run of
    the program, each after a run of the same kind outside the window."""
    out = {}
    codec = EcCodec(K, M, device="cpu")
    for name, run in (("ingest", _ingest), ("repair", _repair)):
        with pytest.MonkeyPatch.context() as mp:
            r = Metrics()
            mp.setattr(telemetry, "registry", r)
            mp.setattr(codec_batch, "registry", r)
            run(codec)
            before = harness.registry_snapshot(r)
            run(codec)
            out[name] = harness.RegistryDiff(before, harness.registry_snapshot(r))
    return out


def _secs(diff, stage, ops):
    return sum(s for (n, lb), (_c, s) in diff.durations.items()
               if n == telemetry.STAGE_DURATION and dict(lb)["stage"] == stage
               and dict(lb).get("op") in ops)


def _count(diff, stage, ops):
    return sum(v for (n, lb), v in diff.counters.items()
               if n == telemetry.STAGE_BLOCKS and dict(lb)["stage"] == stage
               and dict(lb).get("op") in ops)


ING, REP, NONE = ("encode",), ("decode", "reconstruct"), (None,)
# metric -> (its run, numerator stage and ops, denominator stage and ops)
READERS = {
    "codec.stack_ms_per_block.ingest": ("ingest", "stack", ING, "stack", ING),
    "codec.stack_ms_per_block.repair": ("repair", "stack", REP, "verify_hash", NONE),
    "codec.unstack_ms_per_block.ingest": ("ingest", "unstack", ING, "stack", ING),
    "codec.unstack_ms_per_block.repair": ("repair", "unstack", REP, "verify_hash", NONE),
    "device_api.h2d_host_ms_per_block.ingest": ("ingest", "h2d", ING, "stack", ING),
    "device_api.h2d_host_ms_per_block.repair": ("repair", "h2d", REP, "verify_hash", NONE),
    "device_api.kernels_host_ms_per_block.ingest": ("ingest", "kernels", ING, "stack", ING),
    "device_api.kernels_host_ms_per_block.repair": ("repair", "kernels", REP, "verify_hash",
                                                    NONE),
    "device_api.d2h_host_ms_per_block.ingest": ("ingest", "d2h", ING, "stack", ING),
    "device_api.d2h_host_ms_per_block.repair": ("repair", "d2h", REP, "verify_hash", NONE),
    "store.wrap_ms_per_block.ingest": ("ingest", "wrap", NONE, "stack", ING),
    "store.wrap_ms_per_block.repair": ("repair", "wrap", NONE, "verify_hash", NONE),
    "store.verify_hash_ms_per_block.repair": ("repair", "verify_hash", NONE, "verify_hash", NONE),
    "batcher.handoff_ms.ingest": ("ingest", "handoff", ING, None, None),
}


def test_every_new_reader_is_declared():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    declared = {m["name"]: m for m in bench["per_layer"] if m["source"] == "program_span"}
    assert set(READERS) <= set(declared)
    for name, (run, *_rest) in READERS.items():
        assert declared[name]["workloads"] == (
            ["ec8-3.ingest"] if run == "ingest" else ["rs10-4.repair", "ec8-3.repair"])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_the_stage_seconds_over_the_programs_blocks(diffs, name):
    run, stage, ops, per, per_ops = READERS[name]
    diff = diffs[run]
    got = harness.reader(name)(SimpleNamespace(reg=diff))
    if per is None:  # a mean over the stage's uses: ms a dispatch
        n = sum(c for (m, lb), (c, _s) in diff.durations.items()
                if m == telemetry.STAGE_DURATION and dict(lb) == {"op": "encode", "stage": stage})
        want = 1e3 * _secs(diff, stage, ops) / n
    else:
        want = 1e3 * _secs(diff, stage, ops) / _count(diff, per, per_ops)
    assert _count(diff, stage, ops) > 0
    assert got == pytest.approx(want, rel=1e-12) and got > 0


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_where_its_stage_never_ran(diffs, name):
    """An empty window (the parent commit, which has no stage families,
    reads so), and the run's own window with its stage taken out."""
    empty = harness.RegistryDiff(({}, {}), ({}, {}))
    assert harness.reader(name)(SimpleNamespace(reg=empty)) is None
    run, stage, ops, _per, _per_ops = READERS[name]
    diff = diffs[run]
    gone = harness.RegistryDiff(({}, {}), ({}, {}))
    gone.counters = {k: v for k, v in diff.counters.items()
                     if not (k[0] == telemetry.STAGE_BLOCKS and dict(k[1])["stage"] == stage
                             and dict(k[1]).get("op") in ops)}
    gone.durations = {k: v for k, v in diff.durations.items()
                      if not (k[0] == telemetry.STAGE_DURATION and dict(k[1])["stage"] == stage
                              and dict(k[1]).get("op") in ops)}
    assert harness.reader(name)(SimpleNamespace(reg=gone)) is None
