"""garage_tpu_torch block codec and codec batcher on the CPU: `EcCodec`
against the JAX package's `EcCodec` (fused encode + hash with ragged
sizes, degraded decode across erasure patterns, repair), and
`CodecBatcher` coalescing, linger, cancellation and close semantics,
mirroring tests/test_codec_batch.py."""

import asyncio
import os
import time

import numpy as np
import pytest
import torch

from garage_tpu.block.codec.ec import EcCodec as JaxEcCodec
from garage_tpu.utils import latency as jlatency
from garage_tpu_torch.block.codec import ReplicaCodec, get_codec
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.block.codec_batch import CodecBatcher
from garage_tpu_torch.ops.blake3_ref import blake3
from garage_tpu_torch.utils.aio import supervised_count
from garage_tpu_torch.utils import latency as tlatency
from garage_tpu_torch.utils.error import Error
from garage_tpu_torch.utils.metrics import registry

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)


def run(coro):
    return asyncio.run(coro)


def _blocks(rng, sizes):
    return [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in sizes]


# --- codec against the reference ------------------------------------------------


@pytest.mark.parametrize("k,m,impl", [
    pytest.param(2, 1, "xla", id="2-1"),
    pytest.param(8, 3, "xla", id="8-3"),
    *[pytest.param(k, m, impl, id=f"{k}-{m}-{impl}")
      for k, m in [(2, 1), (8, 3)] for impl in ("auto", "host")],
])
def test_encode_batch_hashed_matches_reference(k, m, impl):
    """Pieces and per-piece hashes identical to the JAX codec's path of
    the same `impl` ("xla": its device path; "auto" and "host" on a CPU
    codec: its native host path), ragged sizes included (mirrors
    tests/test_codec_batch.py:212-225)."""
    rng = np.random.default_rng(7)
    port = EcCodec(k, m, device="cpu")
    ref = JaxEcCodec(k, m, tpu_enable=True, platform="cpu")
    blocks = _blocks(rng, (64, 256, 1000, 4096, 256, 3 * 1024 * k))
    out = port.encode_batch_hashed(blocks, impl)
    want = ref.encode_batch_hashed(blocks, impl)
    assert len(out) == len(blocks)
    for blk, (pieces, hashes), (rpieces, rhashes) in zip(blocks, out, want):
        assert pieces == rpieces == ref.encode(blk)
        assert port.encode(blk) == pieces
        assert hashes == rhashes
        if hashes is not None:
            assert hashes == [blake3(p) for p in pieces]


@pytest.mark.parametrize("lost", [[0], [1, 5], [0, 2, 9], [3, 8, 10], [8, 9, 10]])
def test_decode_batch_matches_reference(lost):
    k, m = 8, 3
    rng = np.random.default_rng(len(lost) * 10 + lost[0])
    port = EcCodec(k, m, device="cpu")
    ref = JaxEcCodec(k, m, tpu_enable=True, platform="cpu")
    blocks = _blocks(rng, [8192] * 6 + [5000, 700, 8192, 64])
    items = []
    for blk in blocks:
        pieces = ref.encode(blk)
        items.append(({i: p for i, p in enumerate(pieces) if i not in lost}, len(blk)))
    got = port.decode_batch(items, "xla")
    assert got == ref.decode_batch(items, "xla") == blocks
    assert port.decode(*items[0]) == blocks[0]


def test_reconstruct_batch_matches_reference():
    k, m = 4, 2
    rng = np.random.default_rng(3)
    port = EcCodec(k, m, device="cpu")
    ref = JaxEcCodec(k, m, tpu_enable=True, platform="cpu")
    blocks = _blocks(rng, [4096] * 10)
    wants = [[0], [5], [1, 4]] * 3 + [[2, 3]]
    batches = []
    for blk, want in zip(blocks, wants):
        pieces = port.encode(blk)
        batches.append(({i: p for i, p in enumerate(pieces) if i not in want}, want, len(blk)))
    got = port.reconstruct_batch(batches, "xla")
    assert got == ref.reconstruct_batch(batches)
    for (pieces, want, n), blk, rec in zip(batches, blocks, got):
        full = port.encode(blk)
        assert rec == {w: full[w] for w in want}
    assert port.reconstruct_pieces(*batches[0]) == got[0]


def test_codec_rejects_too_few_or_short_pieces():
    codec = EcCodec(4, 2, device="cpu")
    pieces = codec.encode(b"x" * 1000)
    with pytest.raises(ValueError):
        codec.decode({0: pieces[0], 5: pieces[5]}, 1000)
    with pytest.raises(ValueError):
        codec.reconstruct_batch([({i: pieces[i] for i in range(3)}, [4], 1000)])
    short = {1: pieces[1], 2: pieces[2], 3: pieces[3][:-1], 4: pieces[4]}
    with pytest.raises(ValueError):
        codec.decode(short, 1000)


def test_get_codec_and_counters():
    assert isinstance(get_codec(None), ReplicaCodec)
    ec = get_codec((4, 2), device="cpu")
    assert isinstance(ec, EcCodec) and (ec.n_pieces, ec.min_pieces) == (6, 4)
    assert ec.piece_len(1000) == JaxEcCodec(4, 2, tpu_enable=False).piece_len(1000)
    lbl = (("op", "encode"), ("path", "cpu"))
    before = registry.counters.get(("block_codec_blocks_total", lbl), 0)
    ec.encode_batch_hashed([b"a" * 100, b"b" * 100], "xla")
    assert registry.counters[("block_codec_blocks_total", lbl)] == before + 2
    sys_lbl = (("op", "decode"), ("path", "systematic"))
    before = registry.counters.get(("block_codec_blocks_total", sys_lbl), 0)
    pieces = ec.encode(b"c" * 100)
    assert ec.decode({i: pieces[i] for i in range(4)}, 100) == b"c" * 100
    assert registry.counters[("block_codec_blocks_total", sys_lbl)] == before + 1


# --- batcher ---------------------------------------------------------------------


class StubCodec:
    """Records each coalesced dispatch; optionally fails the next one."""

    n_pieces = 3
    min_pieces = 2

    def __init__(self, delay: float = 0.0):
        self.batches: list[int] = []
        self.fail_next = False
        self.delay = delay

    def encode_batch_hashed(self, blocks, impl="auto"):
        if self.delay:
            time.sleep(self.delay)  # runs in the to_thread worker
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("injected dispatch failure")
        self.batches.append(len(blocks))
        return [([b, b, b], None) for b in blocks]


def test_concurrent_encodes_coalesce_into_one_dispatch():
    async def main():
        codec = StubCodec()
        b = CodecBatcher(codec, linger_msec=20.0)
        try:
            blocks = [os.urandom(64) for _ in range(8)]
            res = await asyncio.gather(*[b.encode(x) for x in blocks])
            assert codec.batches == [8]
            for x, (pieces, _h) in zip(blocks, res):
                assert pieces == [x, x, x]
        finally:
            await b.close()

    run(main())


def test_lone_request_flushes_after_linger():
    async def main():
        codec = StubCodec()
        b = CodecBatcher(codec, linger_msec=5.0)
        key = ("block_codec_batch_dispatch_total", (("flush", "linger"),))
        try:
            before = registry.counters.get(key, 0)
            pieces, _h = await asyncio.wait_for(b.encode(b"x" * 64), 5.0)
            assert pieces == [b"x" * 64] * 3
            assert codec.batches == [1]
            assert registry.counters.get(key, 0) == before + 1
        finally:
            await b.close()

    run(main())


@pytest.mark.parametrize("knob,sizes,want", [
    ("max_blocks", [64] * 8, [4, 4]),
    ("max_bytes", [1000] * 6, [3, 3]),
])
def test_full_batch_flushes_without_waiting_for_linger(knob, sizes, want):
    async def main():
        codec = StubCodec()
        kw = {"max_blocks": 4} if knob == "max_blocks" else {"max_bytes": 3000}
        b = CodecBatcher(codec, linger_msec=60_000.0, **kw)
        try:
            await asyncio.wait_for(
                asyncio.gather(*[b.encode(os.urandom(n)) for n in sizes]), 10.0
            )
            assert codec.batches == want
        finally:
            await b.close()

    run(main())


def test_cancelled_put_does_not_poison_the_batch():
    async def main():
        codec = StubCodec()
        b = CodecBatcher(codec, linger_msec=200.0)
        try:
            blocks = [os.urandom(64) for _ in range(4)]
            tasks = [asyncio.create_task(b.encode(x)) for x in blocks]
            await asyncio.sleep(0.02)
            tasks[1].cancel()
            res = await asyncio.wait_for(
                asyncio.gather(*tasks, return_exceptions=True), 10.0
            )
            assert isinstance(res[1], asyncio.CancelledError)
            for i in (0, 2, 3):
                assert res[i][0] == [blocks[i]] * 3
            assert codec.batches == [3]
        finally:
            await b.close()

    run(main())


def test_dispatch_error_fails_only_that_batch():
    async def main():
        codec = StubCodec()
        b = CodecBatcher(codec, linger_msec=5.0)
        try:
            codec.fail_next = True
            res = await asyncio.wait_for(
                asyncio.gather(*[b.encode(os.urandom(64)) for _ in range(3)],
                               return_exceptions=True),
                10.0,
            )
            assert all(isinstance(r, Error) for r in res)
            pieces, _ = await asyncio.wait_for(b.encode(b"y" * 64), 5.0)
            assert pieces == [b"y" * 64] * 3
        finally:
            await b.close()

    run(main())


def test_close_mid_dispatch_fails_the_inflight_batch():
    async def main():
        b = CodecBatcher(StubCodec(delay=0.4), linger_msec=1.0)
        tasks = [asyncio.create_task(b.encode(b"q" * 64)) for _ in range(3)]
        await asyncio.sleep(0.1)  # linger expired: dispatch is in flight
        await b.close()
        res = await asyncio.wait_for(asyncio.gather(*tasks, return_exceptions=True), 5.0)
        assert all(isinstance(r, (Error, asyncio.CancelledError)) for r in res), res

    run(main())


def test_close_fails_pending_and_reaps_the_flusher():
    async def main():
        b = CodecBatcher(StubCodec(), linger_msec=60_000.0)
        t = asyncio.create_task(b.encode(b"z" * 64))
        await asyncio.sleep(0.02)
        base = supervised_count()
        await b.close()
        with pytest.raises(Error):
            await asyncio.wait_for(t, 5.0)
        assert supervised_count() < base
        with pytest.raises(Error):
            await b.encode(b"w" * 64)
        assert not any(
            name == "block_codec_batch_queue_depth" and fn
            for (name, _l), fn in registry._gauge_fns.items()
            if _l in (b._encode.gauge_key[1], b._decode.gauge_key[1])
        )

    run(main())


def test_batcher_over_ec_codec_matches_reference():
    """Concurrent PUTs and degraded GETs through the batcher on a CPU
    EcCodec: coalesced, and byte-identical to the JAX codec."""
    k, m = 4, 2
    rng = np.random.default_rng(11)
    blocks = _blocks(rng, [4096] * 12 + [1000, 64])
    ref = JaxEcCodec(k, m, tpu_enable=True, platform="cpu")

    async def main():
        b = CodecBatcher(EcCodec(k, m, device="cpu"), linger_msec=20.0, impl="xla")
        try:
            d0 = registry.counter_family_sum("block_codec_batch_dispatch_total")
            puts = await asyncio.gather(*[b.encode(x) for x in blocks])
            assert registry.counter_family_sum("block_codec_batch_dispatch_total") - d0 == 1
            reads = await asyncio.gather(*[
                b.decode({i: p for i, p in enumerate(pieces) if i not in (j % k, k)},
                         len(blk))
                for j, (blk, (pieces, _h)) in enumerate(zip(blocks, puts))
            ])
            return puts, reads
        finally:
            await b.close()

    puts, reads = run(main())
    assert reads == blocks
    want = ref.encode_batch_hashed(blocks, "xla")
    assert [p for p, _h in puts] == [p for p, _h in want]
    assert [h for _p, h in puts] == [h for _p, h in want]


def test_phase_catalogue_is_the_references():
    assert set(tlatency.PHASES) <= set(jlatency.PHASES)
    with tlatency.phase_span("codec_batch_wait"):
        pass
    with pytest.raises(ValueError):
        tlatency.phase_span("not_a_phase")
