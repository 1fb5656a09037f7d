"""Ingest: uploading clients in a closed loop through the batcher.

Parameters (the traffic file): `clients`, `blocks_in_flight` each,
`pool_bytes` of distinct blocks of the configuration's size taken in
turn, `warmup_s`, and the check set: `check_bytes` of blocks drawn from
the seed, `check_runs_per_block` completions of each kept.

`drive` runs the loop and `compare` judges what it kept: each kept
completion piece by piece (header, BLAKE3 and bytes) against the pieces
the reference makes from the block.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from collections import defaultdict
from types import SimpleNamespace

import numpy as np

from perfbench.harness import check_set, entry, per_second
from perfbench.reference import blake3, gf256
from perfbench.reference.layout import split, stored


def _bucket(b: int) -> int:
    return 1 if b <= 1 else 1 << (b - 1).bit_length()


def _p95(values: list[float]) -> float | None:
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, -(-95 * len(ordered) // 100) - 1)]


async def drive(*, codec, cfg, traffic, pool, rng, seconds, impl, spans,
                open_window, close_window, log):
    """Each of `clients` keeps `blocks_in_flight` blocks in flight, each
    block `await CodecBatcher.encode(block)` and then `wrap_piece` of
    each of its k+m pieces, the calls `BlockManager.rpc_put_block` makes
    without the RPC.  A block's latency runs from its call into the
    batcher until its last piece is wrapped."""
    from garage_tpu_torch.block.codec_batch import CodecBatcher
    from garage_tpu_torch.block.manager import wrap_piece

    checks = check_set(len(pool), cfg["block_size"], traffic, rng)
    batcher = CodecBatcher(codec, impl=impl)
    # every batch bucket the window can dispatch, once, before the window
    most = max(1, min(batcher.max_blocks, batcher.max_bytes // cfg["block_size"]))
    b = 1
    while b <= _bucket(most):
        await asyncio.to_thread(codec.encode_batch_hashed, pool[:min(b, most)], impl)
        b *= 2
    log(f"ingest: buckets up to {_bucket(most)} warmed")

    st = SimpleNamespace(t0=None, t1=None, stop=False, attempted=0, failed=0,
                         done_bytes=0, done_blocks=0, errors=[])
    lat: list[float] = []
    kept: dict[int, list] = defaultdict(list)
    cursor = itertools.count()
    done: list[tuple[float, int]] = []

    async def client():
        while not st.stop:
            i = next(cursor) % len(pool)
            block = pool[i]
            t0 = time.perf_counter()
            in_window = st.t0 is not None and st.t1 is None
            st.attempted += in_window
            try:
                pieces, hashes = await batcher.encode(block)
                with spans.span("store.wrap_piece", 1):
                    hs = hashes if hashes is not None else [None] * len(pieces)
                    stored_pieces = [wrap_piece(len(block), p, h) for p, h in zip(pieces, hs)]
            except Exception as e:  # noqa: BLE001 - counted, and named in the notes
                if in_window:
                    st.failed += 1
                    st.errors.append(repr(e))
                continue
            t1 = time.perf_counter()
            if in_window:
                lat.append(t1 - t0)
                if i in checks and len(kept[i]) < traffic["check_runs_per_block"]:
                    kept[i].append(stored_pieces)
            if st.t0 is not None and st.t1 is None:
                st.done_bytes += len(block)
                st.done_blocks += 1
                done.append((t1, len(block)))

    tasks = [asyncio.create_task(client())
             for _ in range(traffic["clients"] * traffic["blocks_in_flight"])]
    try:
        await asyncio.sleep(traffic["warmup_s"])
        st.t0 = await open_window()
        await asyncio.sleep(seconds)
        st.t1 = await close_window()
        st.stop = True
        await asyncio.gather(*tasks)
    finally:
        st.stop = True
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await batcher.close()
    notes = [
        f"ingest: {st.done_blocks} blocks ({st.done_bytes} B) done in the window, "
        f"{st.attempted} submitted, {st.failed} failed; p95 over {len(lat)} latencies",
        f"ingest: MiB done each second: {per_second(done, st.t0, st.t1)}",
    ] + [f"error: {e}" for e in st.errors[:5]]
    return {
        "measured": {"latencies_s": lat, "done_bytes": st.done_bytes,
                     "done_blocks": st.done_blocks, "p95_s": _p95(lat)},
        "kept": dict(kept),
        "attempted": st.attempted, "failed": st.failed, "notes": notes,
    }


def _expected(block: bytes, k: int, m: int) -> list[bytes]:
    data = split(block, k)
    coded = np.concatenate([data, gf256.encode(data, m)])
    digests = blake3.hash_rows(coded)
    return [stored(len(block), row, d.tobytes()) for row, d in zip(coded, digests)]


def compare(cfg: dict, pool: list[bytes], kept: dict, log=print) -> dict:
    k, m = cfg["k"], cfg["m"]
    wrong = checked = 0
    for i, runs in kept.items():
        want = _expected(pool[i], k, m)
        for got in runs:
            checked += 1
            wrong += sum(1 for a, b in zip(got, want) if a != b) + abs(len(got) - len(want))
    log(f"check: {checked} completions of {len(kept)} blocks compared, "
        f"{checked * (k + m)} pieces")
    return {"pieces_wrong": entry(wrong, 0, "<="), "checked": entry(checked, 1, ">=")}
