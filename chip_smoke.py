#!/usr/bin/env python3
"""Chip smoke test of garage_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the two hand-written kernels from garage_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card at the shapes
the main path gives it (tolerance 0: integer math), then drives the
erasure-coded data plane through the entry points a storage node calls,
at EC(8,3) with 1 MiB blocks:

  1. device line: name, count, `nvidia-smi` name and power limit
  2. build: both kernels, build seconds, ptxas register/spill lines,
     and the int32 opcodes and shared-memory loads in the SASS of K2
     (the count its bound uses) and of K1's two table widths
  3. K1 (GF(2^8) coding) vs `gf_bitmatmul`: EC(8,3) encode at B=64,
     S=131072; two EC(8,3) repair patterns; EC(16,4) encode at
     S=65536; a ragged S and a byte-path S; r = 6 and r = 12 (8-byte
     table entries, one and two output groups); q = 1 with an arbitrary
     0/1 matrix.  Kernel time over 50 calls and over a CUDA-graph
     replay of 50 launches (the card's time without the host), plain
     time, bound, GB/s
  4. K2 (BLAKE3) vs `blake3_batch_ref` on (64*11, 131072) rows and on
     L in {64, 1024, 4096}; a few rows vs the pure-Python oracle
  5. the slice, with every launch counter set to 0 just before it:
     256 concurrent 1 MiB PUTs through CodecBatcher(EcCodec) (pieces
     vs the numpy oracle, every piece hash vs the plain hasher on the
     card), degraded GETs in four erasure patterns, a repair batch, and
     a 256-block ScrubRepairPipeline batch vs the plain versions
  6. one JSON line listing each kernel: launches in phase 5, mismatches,
     times and bound

The last line is {"ok": true, "device": {...}}; any failed check exits
non-zero without it, as does a machine without CUDA.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.block.codec_batch import CodecBatcher
from garage_tpu_torch.models.pipeline import ScrubRepairPipeline, scrub_stats
from garage_tpu_torch.ops import _build, gf
from garage_tpu_torch.ops.blake3_ref import blake3
from garage_tpu_torch.ops.ec_cuda import (
    coding_state_from_numpy, gf_bitmatmul, gf_bitmatmul_cuda,
)
from garage_tpu_torch.ops.hash_cuda import blake3_batch, blake3_batch_ref
from garage_tpu_torch.tools.timing import graph_ms, time_ms
from garage_tpu_torch.utils.metrics import registry

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, at the 700 W limit
INT32_LANES_PER_SM = 64  # per pipe: the ALU pipe, and the IMAD pipe
# int32 instructions of one compression, counted in csrc/blake3.cu: the
# XORs and rotates (LOP3, SHF/PRMT) run only on the ALU pipe; the adds
# may also issue on the IMAD pipe (IMAD.IADD)
BLAKE3_ALU_ONLY_OPS = 7 * 8 * 8 + 8
BLAKE3_ADD_OPS = 7 * 8 * 4
SEED = 0
BLOCK = 1 << 20
K, M = 8, 3


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sass_int_ops(so_path, kernel: str) -> dict[str, int] | None:
    """Counts of the int32 opcodes (IADD3, IMAD, LOP3, SHF, PRMT) and the
    shared-memory loads (LDS) in one kernel's SASS, read with cuobjdump;
    IMAD and LDS by their full names, since IMAD.IADD is an add and
    IMAD.MOV a move, and LDS.64 moves two words.  A check on the
    instruction counts the bounds and PERF.md use.  None where cuobjdump
    is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(so_path)],
                          capture_output=True, text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        if kernel in part.splitlines()[0]:
            ops = re.findall(
                r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9.]*)", part)
            names = [op if op.startswith(("IMAD", "LDS")) else op.split(".")[0]
                     for op in ops]
            return {op: names.count(op) for op in sorted(set(names))
                    if op.split(".")[0] in ("IADD3", "IMAD", "LOP3", "SHF", "PRMT", "LDS")}
    raise SmokeFailure(f"{kernel} not found in the SASS of {so_path}")


def rand_u8(shape, gen, dev) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def diff(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(mismatching elements, max absolute difference)."""
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


# --- phase 3: K1 ---------------------------------------------------------------


def check_k1(dev, gen) -> dict:
    enc83 = gf.bitmatrix_of(gf.cauchy_parity_matrix(K, M))
    others = [i for i in range(K + M) if i != 2]
    lost3 = [0, 3, 6]
    keep3 = [i for i in range(K + M) if i not in lost3]
    rng = np.random.default_rng(SEED)
    cases = [  # (name, q, B, S, (8r, 8q) bit-matrix)
        ("ec83_encode", K, 64, 131072, enc83),
        ("ec83_lose1", K, 64, 131072,
         gf.bitmatrix_of(gf.reconstruction_matrix(K, M, others, [2]))),
        ("ec83_lose3", K, 64, 131072,
         gf.bitmatrix_of(gf.reconstruction_matrix(K, M, keep3, lost3))),
        ("ec164_encode", 16, 64, 65536, gf.bitmatrix_of(gf.cauchy_parity_matrix(16, 4))),
        ("ec83_ragged", K, 8, 4160, enc83),
        ("ec83_bytepath", K, 8, 4099, enc83),
        # 8-byte table entries: r = 6 in one output group, r = 12 in two
        ("ec126_encode", 12, 16, 65536, gf.bitmatrix_of(gf.cauchy_parity_matrix(12, 6))),
        ("ec2012_encode", 20, 8, 65536, gf.bitmatrix_of(gf.cauchy_parity_matrix(20, 12))),
        # q = 1 with an arbitrary 0/1 matrix (no GF expansion), r = 5
        ("q1_arbitrary", 1, 64, 65536, rng.integers(0, 2, (40, 8), dtype=np.uint8)),
    ]
    rows = {}
    for name, q, b, s, bm_np in cases:
        bm = torch.from_numpy(bm_np).to(dev)
        r = bm.shape[0] // 8
        x = rand_u8((b, q, s), gen, dev)
        got = gf_bitmatmul_cuda(bm, x)
        want = gf_bitmatmul(bm, x)
        torch.cuda.synchronize()
        mism, err = diff(got, want)
        out = torch.empty_like(got)
        kern_ms = time_ms(lambda: gf_bitmatmul_cuda(bm, x, out=out), 50)
        card_ms = graph_ms(lambda: gf_bitmatmul_cuda(bm, x, out=out), 50)
        plain_ms = time_ms(lambda: gf_bitmatmul(bm, x), 3)
        nbytes = b * q * s + b * r * s + bm.numel()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {
            "mismatches": mism, "max_abs_err": err, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
        }
        print(f"K1 {name}: B={b} q={q} r={r} S={s} mismatches={mism} "
              f"kernel_ms={kern_ms:.6f} graph_ms={card_ms:.6f} plain_ms={plain_ms:.6f} "
              f"bound_us={bound_ms * 1e3:.3f} achieved_GBps="
              f"{nbytes / (kern_ms * 1e-3) / 1e9:.3f} "
              f"bound_share={bound_ms / kern_ms:.4f}")
        require(mism == 0, f"K1 {name}: {mism} bytes differ from gf_bitmatmul")
    return rows


# --- phase 4: K2 ---------------------------------------------------------------


def blake3_bound_ms(n: int, length: int, sm_count: int, clock_hz: float):
    chunks = max(1, length // 1024)
    comps = n * (length // 64 + (chunks - 1 if chunks > 1 else 0))
    # lane-cycles per compression on one SM: the ALU pipe carries at least
    # the ALU-only ops, and both pipes together carry every op
    lane_cycles = max(BLAKE3_ALU_ONLY_OPS / INT32_LANES_PER_SM,
                      (BLAKE3_ALU_ONLY_OPS + BLAKE3_ADD_OPS) / (2 * INT32_LANES_PER_SM))
    ops_ms = comps * lane_cycles / (sm_count * clock_hz) * 1e3
    bytes_ms = (n * length + n * 32) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_k2(dev, gen, sm_count: int, clock_hz: float) -> dict:
    rows = {}
    for n, length in ((64 * (K + M), 131072), (4096, 64), (4096, 1024), (2048, 4096)):
        x = rand_u8((n, length), gen, dev)
        got = blake3_batch(x)
        want = blake3_batch_ref(x)
        torch.cuda.synchronize()
        mism, err = diff(got, want)
        got_np, x_np = got.cpu().numpy(), x[:3].cpu().numpy()
        for i in range(2 if length > 4096 else 3):
            require(bytes(got_np[i]) == blake3(bytes(x_np[i])),
                    f"K2 L={length}: row {i} differs from the pure-Python oracle")
        kern_ms = time_ms(lambda: blake3_batch(x), 20)
        plain_ms = time_ms(lambda: blake3_batch_ref(x), 1)
        bound_ms, bound_by = blake3_bound_ms(n, length, sm_count, clock_hz)
        rows[(n, length)] = {
            "mismatches": mism, "max_abs_err": err, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(f"K2 rows={n} L={length}: mismatches={mism} kernel_ms={kern_ms:.6f} "
              f"plain_ms={plain_ms:.6f} bound_us={bound_ms * 1e3:.3f} ({bound_by}) "
              f"achieved_GBps={n * length / (kern_ms * 1e-3) / 1e9:.3f} "
              f"bound_share={bound_ms / kern_ms:.4f}")
        require(mism == 0, f"K2 L={length}: {mism} digest bytes differ from blake3_batch_ref")
    return rows


# --- phase 5: the slice --------------------------------------------------------


def dispatch_breakdown() -> dict:
    """Per codec kernel, from the dispatch telemetry (ops/telemetry.py):
    dispatches, their wall seconds, kernel seconds (CUDA events) and
    host<->device copy seconds."""
    out: dict[str, dict] = {}
    fields = {"tpu_codec_dispatch_duration": "wall_s",
              "tpu_codec_compute_duration": "kernel_s",
              "tpu_codec_transfer_duration": "transfer_s"}
    for (name, labels), (cnt, total, _b) in registry.durations.items():
        if name in fields:
            row = out.setdefault(dict(labels)["kernel"], {})
            row[fields[name]] = total
            if name == "tpu_codec_dispatch_duration":
                row["dispatches"] = cnt
    return out


async def put_and_get(codec: EcCodec, blocks: list[bytes]):
    batcher = CodecBatcher(codec, max_blocks=64)
    try:
        async def client(i: int):
            return [await batcher.encode(blocks[4 * i + j]) for j in range(4)]

        d0 = registry.counter_family_sum("block_codec_batch_dispatch_total")
        t0 = time.perf_counter()
        per_client = await asyncio.gather(*[client(i) for i in range(64)])
        t_put = time.perf_counter() - t0
        puts = [r for rs in per_client for r in rs]
        put_dispatches = registry.counter_family_sum("block_codec_batch_dispatch_total") - d0

        patterns = [[3], [0, 6], [1, 4, 7], [2, 8, 10]]
        d0 = registry.counter_family_sum("block_codec_batch_decode_dispatch_total")
        t0 = time.perf_counter()
        reads = await asyncio.gather(*[
            batcher.decode(
                {j: p for j, p in enumerate(pieces) if j not in patterns[i % 4]},
                len(blocks[i]),
            )
            for i, (pieces, _h) in enumerate(puts)
        ])
        t_get = time.perf_counter() - t0
        get_dispatches = registry.counter_family_sum(
            "block_codec_batch_decode_dispatch_total") - d0
        return puts, put_dispatches, t_put, reads, get_dispatches, t_get, len(patterns)
    finally:
        await batcher.close()


def run_slice(dev, gen) -> dict:
    rng = np.random.default_rng(SEED)
    raw = rng.integers(0, 256, 256 * BLOCK, dtype=np.uint8)
    blocks = [raw[i * BLOCK:(i + 1) * BLOCK].tobytes() for i in range(256)]
    codec = EcCodec(K, M, device=dev)
    s = codec.piece_len(BLOCK)

    t0 = time.perf_counter()
    puts, put_disp, t_put, reads, get_disp, t_get, n_patterns = asyncio.run(
        put_and_get(codec, blocks))
    sync(dev)
    t_io = time.perf_counter() - t0

    # PUT: pieces vs the numpy oracle on a sample, every hash vs the plain hasher
    enc = gf.cauchy_parity_matrix(K, M)
    for i in range(0, 256, 16):
        pieces, hashes = puts[i]
        data = np.frombuffer(blocks[i], dtype=np.uint8).reshape(K, s)
        parity = gf.apply_matrix_ref(enc, data)
        require(pieces[:K] == [bytes(d) for d in data], f"PUT block {i}: data pieces")
        require(pieces[K:] == [bytes(p) for p in parity], f"PUT block {i}: parity vs oracle")
    require(all(h is not None for _p, h in puts), "PUT: a block came back without hashes")
    all_pieces = torch.from_numpy(np.frombuffer(
        b"".join(p for pieces, _h in puts for p in pieces), dtype=np.uint8,
    ).copy()).to(dev).view(256 * (K + M), s)
    plain_h = blake3_batch_ref(all_pieces).cpu().numpy()
    got_h = np.frombuffer(b"".join(h for _p, hs in puts for h in hs), dtype=np.uint8)
    hash_mism = int((plain_h.reshape(-1) != got_h).sum())
    require(hash_mism == 0, f"PUT: {hash_mism} hash bytes differ from blake3_batch_ref")
    for i, j in ((0, 0), (255, K + M - 1)):
        require(puts[i][1][j] == blake3(puts[i][0][j]), f"PUT block {i} piece {j}: oracle")
    require(put_disp < 256, f"PUT: {put_disp} dispatches for 256 blocks (no coalescing)")
    print(f"PUT: 256 blocks in {put_disp:.0f} encode dispatches, pieces and hashes exact")

    # degraded GET
    bad = [i for i in range(256) if reads[i] != blocks[i]]
    require(not bad, f"GET: blocks {bad[:8]} differ after decode")
    print(f"GET: 256 degraded reads in {n_patterns} erasure patterns, "
          f"{get_disp:.0f} decode dispatches, all exact")

    # repair: lost data and parity pieces
    t1 = time.perf_counter()
    losses = [[5, 9]] * 32 + [[0, 1, 10]] * 32
    batches = [
        ({j: p for j, p in enumerate(puts[i][0]) if j not in lost}, lost, BLOCK)
        for i, lost in enumerate(losses)
    ]
    rebuilt = codec.reconstruct_batch(batches)
    t_repair = time.perf_counter() - t1
    for i, (lost, rec) in enumerate(zip(losses, rebuilt)):
        require(all(rec[w] == puts[i][0][w] for w in lost), f"repair block {i}")
    print(f"repair: 64 blocks, pieces {losses[0]} and {losses[-1]}, exact")

    # scrub: the flagship pipeline vs the plain versions on the card
    pipe = ScrubRepairPipeline(K, M, s, device=dev)
    data = rand_u8((256, K, s), gen, dev)
    t2 = time.perf_counter()
    parity, hashes, stats = pipe.encode_and_hash_fn()(data)
    stats_host = stats.cpu()  # ends the timed work with a device->host copy
    t_scrub = time.perf_counter() - t2
    bm = coding_state_from_numpy(enc, dev)["bitmat"]
    plain_par = torch.cat([gf_bitmatmul(bm, data[i:i + 64]) for i in range(0, 256, 64)])
    plain_hash = blake3_batch_ref(
        torch.cat([data, plain_par], dim=1).view(256 * (K + M), s)
    ).view(256, K + M, 32)
    plain_stats = scrub_stats(plain_hash).cpu()
    require(torch.equal(parity, plain_par), "scrub: parity differs from gf_bitmatmul")
    require(torch.equal(hashes, plain_hash), "scrub: hashes differ from blake3_batch_ref")
    require(torch.equal(stats_host, plain_stats), "scrub: stats differ")
    print(f"scrub: 256 blocks, stats={stats_host.tolist()}, exact")

    wall = t_io + t_repair + t_scrub
    served = 256 + 256 + 64 + 256
    nbytes = 256 * BLOCK * 2 + 64 * K * s + 256 * K * s
    print(f"slice: requests_served={served} bytes={nbytes} wall_s={wall:.6f} "
          f"(put {t_put:.6f}, get {t_get:.6f}, put+get {t_io:.6f}, "
          f"repair {t_repair:.6f}, scrub {t_scrub:.6f})")
    print(f"slice dispatches: {json.dumps(dispatch_breakdown())}")
    return {"hash_mismatches": hash_mism}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {name} count={count} sms={sm_count} max_sm_clock_mhz={clock_mhz:.0f}")
    print(card)  # nvidia-smi's own line: name, power limit

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: wall_s={time.perf_counter() - t0:.3f} per_source="
          f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    for src, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}")
    ops = sass_int_ops(_build._target("blake3"), "blake3_small_kernel")
    print(f"sass blake3_small_kernel (one compression in its loop): "
          f"{ops if ops is None else json.dumps(ops)} "
          f"counted: alu_only={BLAKE3_ALU_ONLY_OPS} adds={BLAKE3_ADD_OPS}")
    for width in (4, 8):
        ops = sass_int_ops(_build._target("gf_bitplane"), f"gf_bitplane_kernelILi{width}E")
        print(f"sass gf_bitplane_kernel<{width}> (whole kernel): "
              f"{ops if ops is None else json.dumps(ops)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k1 = check_k1(dev, gen)
    k2 = check_k2(dev, gen, sm_count, clock_mhz * 1e6)

    gf_bitmatmul_cuda.launches = 0
    blake3_batch.launches = 0
    slice_res = run_slice(dev, gen)
    launches = {"gf": gf_bitmatmul_cuda.launches, "blake3": blake3_batch.launches}
    require(launches["gf"] > 0, "the slice never launched K1")
    require(launches["blake3"] > 0, "the slice never launched K2")

    main_k1 = k1["ec83_encode"]
    main_k2 = k2[(64 * (K + M), 131072)]
    kernels = [
        {
            "name": "gf_bitplane", "route": "cuda",
            "source": "garage_tpu_torch/csrc/gf_bitplane.cu",
            "replaces": "garage_tpu/ops/ec_tpu.py:116",
            "launches": launches["gf"],
            "mismatches": sum(r["mismatches"] for r in k1.values()),
            "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
            "ms": main_k1["ms"], "plain_ms": main_k1["plain_ms"],
            "bound_ms": main_k1["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "blake3", "route": "cuda",
            "source": "garage_tpu_torch/csrc/blake3.cu",
            "replaces": "garage_tpu/ops/hash_tpu.py:93",
            "launches": launches["blake3"],
            "mismatches": sum(r["mismatches"] for r in k2.values())
            + slice_res["hash_mismatches"],
            "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
            "ms": main_k2["ms"], "plain_ms": main_k2["plain_ms"],
            "bound_ms": main_k2["bound_ms"], "bound_by": main_k2["bound_by"],
            "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
