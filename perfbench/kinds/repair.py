"""Repair: the backlog of one lost node, in the repair planner's rounds.

Parameters (the traffic file): `pool_bytes` of distinct blocks of the
configuration's size, cycled, each of which lost one piece (each rank
as often as the others, in an order drawn from the seed, as placement
spreads them); `warmup_s`; and the check set:
`check_bytes` of blocks drawn from the seed, `check_per_rank` more of
each lost rank (so every erasure pattern is compared in every run), and
`corrupt_blocks` drawn from the seed whose survivors carry one corrupt
byte (the verification has to refuse them), `check_runs_per_block`
outcomes of each kept.

`drive` runs the rounds and `compare` judges what it kept: each verdict
against the reference's (do the k surviving pieces decode to the block?)
and the piece stored with it against the one the reference rebuilds;
and every lost rank of the pool has to be among those compared.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from collections import defaultdict
from types import SimpleNamespace

import numpy as np

from perfbench.harness import check_set, content_hashes, entry, per_second, seeded_ranks
from perfbench.reference import gf256, layout


def survivors(cfg: dict, traffic: dict, pool: list[bytes], rng) -> tuple[list, set[int], set[int]]:
    """For each block: (content hash, lost rank, the k pieces
    `gather_pieces` would return: the first k ranks that survive, made
    by the reference), then the check set and the corrupt blocks."""
    k, m = cfg["k"], cfg["m"]
    n = k + m
    s = layout.piece_len(cfg["block_size"], k)
    hashes = content_hashes(pool)
    ranks = seeded_ranks(len(pool), n, rng)
    checks = check_set(len(pool), cfg["block_size"], traffic, rng)
    for r in range(n):
        of_rank = [i for i, lost in enumerate(ranks) if lost == r]
        checks |= set(rng.sample(of_rank, min(len(of_rank), traffic["check_per_rank"])))
    corrupt = set(rng.sample(range(len(pool)), min(len(pool), traffic["corrupt_blocks"])))
    first_parity = gf256.cauchy(k, m)[:1]
    entries = []
    for i, block in enumerate(pool):
        lost = ranks[i]
        present = [p for p in range(n) if p != lost][:k]
        data = layout.split(block, k)
        pieces = {p: data[p].tobytes() for p in present if p < k}
        if k in present:
            pieces[k] = gf256.apply(first_parity, data)[0].tobytes()
        if i in corrupt:
            p = rng.choice(present)
            bad = bytearray(pieces[p])
            bad[rng.randrange(s)] ^= rng.randrange(1, 256)
            pieces[p] = bytes(bad)
        entries.append((hashes[i], lost, pieces, len(block)))
    return entries, checks | corrupt, corrupt


async def drive(*, codec, cfg, traffic, pool, rng, seconds, impl, spans,
                open_window, close_window, log):
    """Rounds are sized as `RepairPlanner._pick_batch` sizes them, and
    each runs `bulk_reconstruct`'s steps after the gather in a worker
    thread: `_verify_gathered` (one `decode_batch`, then the content
    hash of each block), `reconstruct_batch` of the blocks that
    verified, and `wrap_piece` of each rebuilt piece."""
    from garage_tpu_torch.block import repair_plan
    from garage_tpu_torch.block.manager import BlockManager, wrap_piece

    k = cfg["k"]
    entries, checks, corrupt = survivors(cfg, traffic, pool, rng)
    log(f"repair: {len(entries)} blocks' survivors made, {len(checks)} in the check set, "
        f"{len(corrupt)} of them with a corrupt byte")

    est = k * codec.piece_len(cfg["block_size"])
    budget = repair_plan.PlanParams().bytes_in_flight
    per_round = max(1, min(repair_plan.DEFAULT_BATCH_TARGET, budget // est, len(entries)))
    manager = SimpleNamespace(codec=codec, block_config=SimpleNamespace(batch_impl=impl))

    def verify(items):
        with spans.span("store.verify", len(items)):
            return BlockManager._verify_gathered(manager, items)

    st = SimpleNamespace(t0=None, t1=None, stop=False, attempted=0, failed=0,
                         done_bytes=0, done_blocks=0, rounds=0, refused=0, errors=[])
    kept: dict[int, list] = defaultdict(list)
    cursor = itertools.count()
    done: list[tuple[float, int]] = []

    async def one_round() -> int:
        idx = [next(cursor) % len(entries) for _ in range(per_round)]
        in_window = st.t0 is not None and st.t1 is None
        st.attempted += in_window * len(idx)
        try:
            ok = await asyncio.to_thread(verify, [(entries[i][0], entries[i][2], entries[i][3])
                                                  for i in idx])
            good = [i for i, g in zip(idx, ok) if g]
            recs = await asyncio.to_thread(
                codec.reconstruct_batch,
                [(entries[i][2], [entries[i][1]], entries[i][3]) for i in good], impl,
            ) if good else []
            stored = {}
            for i, rec in zip(good, recs):
                with spans.span("store.wrap_piece", 1):
                    stored[i] = wrap_piece(entries[i][3], rec[entries[i][1]])
                if st.t0 is not None and st.t1 is None:
                    st.done_bytes += entries[i][3]
                    st.done_blocks += 1
                    done.append((time.perf_counter(), entries[i][3]))
        except Exception as e:  # noqa: BLE001 - counted, and named in the notes
            if in_window:
                st.failed += len(idx)
                st.errors.append(repr(e))
            return len(idx)
        if in_window:
            st.rounds += 1
            st.refused += len(idx) - len(good)
            for i, g in zip(idx, ok):
                if i in checks and len(kept[i]) < traffic["check_runs_per_block"]:
                    kept[i].append((bool(g), stored.get(i)))
        return len(idx)

    warm = asyncio.Event()

    async def rounds():
        t_warm = time.perf_counter()
        warmed = 0
        while not st.stop:
            warmed += await one_round()
            if (not warm.is_set() and warmed >= len(entries)
                    and time.perf_counter() - t_warm >= traffic["warmup_s"]):
                log(f"repair: warm after {warmed} blocks")
                warm.set()

    task = asyncio.create_task(rounds())
    try:
        warm_wait = asyncio.create_task(warm.wait())
        await asyncio.wait({warm_wait, task}, return_when=asyncio.FIRST_COMPLETED)
        warm_wait.cancel()
        st.t0 = await open_window()
        await asyncio.sleep(seconds)
        st.t1 = await close_window()
        st.stop = True
        await task  # the round in flight at the close finishes
    finally:
        st.stop = True
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
    notes = [
        f"repair: {per_round} blocks a round ({est} B of survivors a block against "
        f"bytes_in_flight {budget}), {st.rounds} rounds in the window",
        f"repair: {st.done_blocks} blocks ({st.done_bytes} B) restored in the window, "
        f"{st.attempted} attempted, {st.refused} refused by the verification, {st.failed} failed",
        f"repair: MiB done each second: {per_second(done, st.t0, st.t1)}",
    ] + [f"error: {e}" for e in st.errors[:5]]
    return {
        "measured": {"done_bytes": st.done_bytes, "done_blocks": st.done_blocks,
                     "rounds": st.rounds, "per_round": per_round},
        "kept": {"seen": dict(kept),
                 "inputs": {i: (entries[i][1], entries[i][2]) for i in kept},
                 "lost_ranks": len({e[1] for e in entries})},
        "attempted": st.attempted, "failed": st.failed, "notes": notes,
    }


def _expected(block: bytes, k: int, m: int, lost: int,
              pieces: dict[int, bytes]) -> tuple[bool, bytes | None]:
    arrs = {p: np.frombuffer(b, dtype=np.uint8) for p, b in pieces.items()}
    data = gf256.rebuild(k, m, arrs, list(range(k)))
    if data.tobytes()[:len(block)] != block:
        return False, None
    return True, layout.stored(len(block), gf256.rebuild(k, m, arrs, [lost])[0])


def compare(cfg: dict, pool: list[bytes], kept: dict, log=print) -> dict:
    k, m = cfg["k"], cfg["m"]
    verdicts_wrong = pieces_wrong = checked = refused = 0
    patterns = set()
    for i, runs in kept["seen"].items():
        lost, pieces = kept["inputs"][i]
        verdict, piece = _expected(pool[i], k, m, lost, pieces)
        refused += not verdict
        patterns.add(lost)
        for got_verdict, got_piece in runs:
            checked += 1
            verdicts_wrong += got_verdict != verdict
            pieces_wrong += got_piece != piece
    log(f"check: {checked} verdicts on {len(kept['seen'])} blocks compared, "
        f"{len(patterns)} lost ranks among them, {refused} of the blocks refused by "
        f"the reference")
    return {"verdicts_wrong": entry(verdicts_wrong, 0, "<="),
            "pieces_wrong": entry(pieces_wrong, 0, "<="),
            "checked": entry(checked, 1, ">="),
            "patterns": entry(len(patterns), kept["lost_ranks"], ">=")}
