#!/usr/bin/env python3
"""Chip smoke test of garage_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the two hand-written kernels from garage_tpu_torch/csrc with nvcc
(and the host library, the GF(2^8) host codec, BLAKE3 and the native
metadata engine, with g++), holds each against its plain PyTorch version on the card at the
shapes the main path gives it (tolerance 0: integer math), then drives
the erasure-coded data plane, the block store through the entry points
a storage node calls, and a cluster of whole nodes through the S3 API,
at EC(8,3) with 1 MiB blocks, and a cluster of daemons, each a process
of its own, on each metadata engine:

  1. device line: name, count, `nvidia-smi` name and power limit
  2. build: both kernels (and the replaced K2 design kept as a
     yardstick, tools/blake3_block_per_row.cu), build seconds, ptxas
     register and stack-frame lines per kernel, and the int32 opcodes
     and shared-memory loads in the SASS of K2's kernels (the
     multi-chunk kernel's per compression: the counts its bound uses)
     and of K1's two table widths
  3. K1 (GF(2^8) coding) vs `gf_bitmatmul`: EC(8,3) encode at B=64,
     S=131072; two EC(8,3) repair patterns; EC(16,4) encode at
     S=65536; a ragged S and a byte-path S; r = 6 and r = 12 (8-byte
     table entries, one and two output groups); q = 1 with an arbitrary
     0/1 matrix.  Kernel time over 50 calls and over a CUDA-graph
     replay of 50 launches (the card's time without the host), plain
     time, bound, GB/s
  4. K2 (BLAKE3) vs `blake3_batch_ref` on (64*11, 131072) rows and on
     L in {64, 1024, 4096}; a few rows vs the pure-Python oracle; eager
     and CUDA-graph times beside the replaced design's on the same rows;
     then K3 (`encode_hash_tensor`, B=64) and K5 (the pipeline's `fwd`,
     B=256) vs the plain versions composed the same way, with their
     bounds (K1's byte bound plus K2's operation bound), and K3's split:
     the copy design's allocation and copy, K1 through a strided view
     and K2 on the k+m buffer, beside K1 + K2 alone
  5. the slice, with every launch counter set to 0 just before it:
     256 concurrent 1 MiB PUTs through CodecBatcher(EcCodec) (pieces
     vs the numpy oracle, every piece hash vs the plain hasher on the
     card), degraded GETs in four erasure patterns, a repair batch, and
     a 256-block ScrubRepairPipeline batch vs the plain versions
  6. the mesh fan-out (K6) over an explicit 4-entry mesh: 4 cards where
     4 are visible, else 4 entries on card 0, one stream each.  With the
     launch counters set to 0 just before it: EC(8,3) encode of 256 1 MiB
     blocks through EcCodec.encode_batch; EC(16,4) encode and repair of
     259 1 MiB blocks that lose ranks {0, 5, 17, 19}; `sharded_apply` of
     EC(8,3) at 11 and 259 blocks; `dryrun_multichip(4)`.  Then each is
     held against the single-device path, the oracle or the original
     shards, `tpu_mesh_engaged_total` is read, the 4-entry and 1-entry
     runs are timed in turns, and the fan-out of K1 at the 256-block
     encode is timed (eager and by CUDA-graph replay) against one launch
     and against the plain version
  7. the block store, with the launch counters set to 0 just before
     it: 11 nodes of this package in one process over loopback TCP
     (tools/block_cluster.py), EC(8,3), each node's EcCodec on the card,
     256 blocks of 1 MiB.  PUT from 32 clients (every stored header hash
     vs the plain hasher), GET (bit-exact), degraded GET with 3 nodes
     stopped (bit-exact, through the batcher's decode lane), repair of
     a node restarted with its data dir wiped (`drive_bulk`; piece files
     byte-identical; its verification and rebuild dispatches, at most 8
     K1 launches), a `ScrubWorker` pass that finds exactly 3 flipped
     bytes through K2, and resync; each part's wall time, K1/K2
     launches and dispatch breakdown; then a cProfile of 64 more PUTs
     and GETs
  8. the S3 cluster, with the launch counters set to 0 just before it:
     11 nodes of this package in one process (tools/s3_cluster.py), each
     a whole `Garage` (tables, model, block store) with sqlite metadata,
     metadata replicated 3 times, EC(8,3) with each node's EcCodec on the
     card, S3 served by nodes 0 and 1, driven through the port's own
     `S3Client`: a key through `GarageHelper` and a bucket; 64 objects
     of 4 MiB from 8 concurrent clients over both endpoints (ETags the
     bodies' MD5) and 256 inline objects of 1 KiB; one multipart upload
     of 8 parts of 8 MiB (`ListParts` checked, then completed); one
     SSE-C object; `ListObjectsV2` by prefix, 100 keys a page; every
     object read back through the other endpoint and one ranged GET
     across a block boundary; one node stopped (the lowest data rank
     that serves no endpoint) and every 4 MiB object read again; one
     `DeleteObject` and its 404; 8 sampled blocks' piece files against
     the plain versions on the card.  Each part's wall, K1/K2/K3
     launches, kernel seconds and dispatches; MiB/s; the codec batch
     sizes under S3 traffic; every response status (2xx but the one
     404); a cProfile of 16 more 4 MiB PUTs and GETs
  9. the daemons: 11 processes of `python -m garage_tpu_torch.cli
     server` (tools/daemons.py), each with its own CUDA context on card
     0 and its EcCodec there, EC(8,3), sqlite, metadata replicated 3
     times, the config's defaults; S3 on daemons 0 and 1, K2V on daemon
     0, the website on daemon 1, the admin API on each.  Configured by
     CLI processes only (`node id`, `node connect`, `layout assign` x11,
     `layout apply`, `key new`, `bucket create`, `bucket allow`, `bucket
     website --allow`), then driven over HTTP with phase 8's objects and
     clients: the 4 MiB and 1 KiB PUTs, GETs through the other endpoint
     and a ranged GET, 256 K2V items inserted, read back as a batch and
     one poll, a website GET; one daemon stopped by SIGTERM (the lowest
     data rank that serves no endpoint; it must exit 0), the degraded
     GETs and website GETs; that daemon restarted with its data dir
     wiped and `repair blocks` until its piece files are byte-identical
     and `cluster durability` reports no missing pieces; 8 sampled
     blocks' piece files against the plain versions on the card; 3
     flipped piece bytes on one daemon found by `repair scrub start`
     (exactly 3).  Each part's wall beside phase 8's, and the daemons'
     K1/K2/K3 launches read from their `/metrics`
     (`cuda_kernel_launches_total`); every codec dispatch must be on
     the CUDA platform; boot time, CLI call times, card memory, loop
     lag, request and table latencies, every response status; SIGTERM
     to all, each exits 0
  10. the metadata engines, on phase 9's stopped daemons: `convert-db`
     processes, run side by side, turn the sqlite metadata of daemons
     1, 4, 7, 10 into the native engine and of daemons 2, 5, 8 into the
     log engine (0, 3, 6, 9 stay on sqlite; S3 daemon 0 is sqlite, S3
     daemon 1 native), every tree's rows identical before and after;
     the 11 daemons booted again on the card with those engines (the
     native engine's binding read from their logs); every 4 MiB and
     1 KiB object of phase 9 read through both S3 endpoints; 16 new
     4 MiB objects PUT (K3 on the card) and read back; SIGTERM to all
     (each exits 0) and every db reopened in this process, each new
     object's row on its replicas, log and native dbs among them; then
     on this host, through the `Db` interface with fsync on, 20,000
     inserts in transactions of 1 and of 64 and a full scan per engine.
     Each part's wall
  11. the host codec (`_native/gf8.cpp`, no TPU kernel: what a CPU codec
     or `[block] batch_impl = "host"` runs) on this card's host:
     `gf8_apply` against K1 on the card and against `gf_bitmatmul`, byte
     for byte, on EC(8,3) encode of 64 blocks of 1 MiB (one call a
     block), EC(16,4) encode and a reconstruct with 3 erasures; then
     `EcCodec(8, 3)` on the card with impl="host" and impl="auto" on 16
     blocks of 1 MiB: the same pieces, piece hashes and degraded
     decodes, no launch from "host", K3 and K1 launched by "auto"; the
     host codec's ms per block for `encode_batch_hashed` and
     `decode_batch` beside the card's and K3's, on a JSON line of its own
  12. one JSON line listing each kernel: launches in phase 5 (in phase 6
     for the fan-out; `launches_block_store` in phase 7, `launches_s3`
     in phase 8, `launches_daemons` in phase 9, K3's in phase 10 as
     `k3_launches_engines`; the fan-out's two are
     its dispatches, `tpu_mesh_engaged_total`), mismatches, times and
     bound (K2's with its graph time, the replaced design's times, its
     stack frames, K3 against K1 + K2, and K5's eager and graph times)

The last line is {"ok": true, "device": {...}}; any failed check exits
non-zero without it, as does a machine without CUDA.
"""

from __future__ import annotations

import asyncio
import base64
import cProfile
import hashlib
import json
import os
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import aiohttp
import numpy as np
import torch

from garage_tpu_torch import _native
from garage_tpu_torch.api.s3.client import S3Client, S3Error
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.block.codec_batch import CodecBatcher
from garage_tpu_torch.block.repair import ScrubWorker
from garage_tpu_torch.block.repair_plan import drive_bulk
from garage_tpu_torch.db import open_db
from garage_tpu_torch.graft_entry import dryrun_multichip
from garage_tpu_torch.k2v_client import K2VClient
from garage_tpu_torch.model.s3.object_table import ObjectTable
from garage_tpu_torch.models.pipeline import ScrubRepairPipeline, scrub_stats
from garage_tpu_torch.net.handshake import node_id_of
from garage_tpu_torch.ops import _build, gf
from garage_tpu_torch.ops.blake3_ref import blake3
from garage_tpu_torch.ops.ec_cuda import (
    EcCuda, coding_state_from_numpy, ec_apply_mesh, encode_hash_tensor, gf_bitmatmul,
    gf_bitmatmul_cuda,
)
from garage_tpu_torch.ops.hash_cuda import (
    blake3_batch, blake3_batch_ref, blake3_pieces, blake3_pieces_ref,
)
from garage_tpu_torch.parallel.mesh import make_mesh
from garage_tpu_torch.tools.block_cluster import (
    make_cluster, restart_node, stop_all, stop_node, wait_until,
)
from garage_tpu_torch.tools.daemons import (
    ADMIN_TOKEN, CLI_WALLS, METRICS_TOKEN, WEB_ROOT, Daemon, cli, cli_many, configure,
    free_ports, kill_all, metric_samples,
)
from garage_tpu_torch.tools.daemons import stop_all as stop_daemons
from garage_tpu_torch.tools.k2_compare import (
    BLAKE3_ADD_OPS, BLAKE3_ALU_ONLY_OPS, blake3_bound_ms, old_k2,
)
from garage_tpu_torch.tools.s3_cluster import (
    make_key, make_s3_cluster, stop_s3_cluster, stop_s3_node,
)
from garage_tpu_torch.tools.sass import per_compression, sass_int_ops
from garage_tpu_torch.tools.timing import graph_ms, time_ms
from garage_tpu_torch.utils.background import WorkerState
from garage_tpu_torch.utils.data import blake2sum
from garage_tpu_torch.utils.metrics import registry
from garage_tpu_torch.utils.serde import unpack

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, at the 700 W limit
SEED = 0
BLOCK = 1 << 20
# phase 7's node directories live under the checkout's gitignored build/
SCRATCH = Path(__file__).resolve().parent / "build"
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


K2_SHAPES = ((64 * (K + M), 131072), (4096, 64), (4096, 1024), (2048, 4096))


def check_k2(dev, gen, sm_count: int, clock_hz: float) -> dict:
    """K2 at each shape against `blake3_batch_ref` and the pure-Python
    oracle; timed eager (20 calls) and by CUDA-graph replay, beside the
    design it replaced (tools/blake3_block_per_row.cu) timed the same
    way on the same rows, and beside the plain version."""
    rows = {}
    for n, length in K2_SHAPES:
        x = rand_u8((n, length), gen, dev)
        got = blake3_batch(x)
        want = blake3_batch_ref(x)
        old_out = torch.empty_like(got)
        old_k2(x, old_out)
        torch.cuda.synchronize()
        mism, err = diff(got, want)
        require(torch.equal(old_out, want), f"K2 L={length}: the replaced design disagrees")
        got_np, x_np = got.cpu().numpy(), x[:3].cpu().numpy()
        for i in range(2 if length > 4096 else 3):
            require(bytes(got_np[i]) == blake3(bytes(x_np[i])),
                    f"K2 L={length}: row {i} differs from the pure-Python oracle")
        # both through a wrapper that allocates its output, as the port's does
        kern_ms, old_ms = (time_ms(lambda: blake3_batch(x), 20),
                           time_ms(lambda: old_k2(x), 20))
        kern_graph, old_graph = (graph_ms(lambda: blake3_batch(x), 20),
                                 graph_ms(lambda: old_k2(x), 20))
        plain_ms = time_ms(lambda: blake3_batch_ref(x), 1)
        bound_ms, bound_by = blake3_bound_ms(n, length, sm_count, clock_hz)
        rows[(n, length)] = {
            "mismatches": mism, "max_abs_err": err, "ms": kern_ms, "graph_ms": kern_graph,
            "old_ms": old_ms, "old_graph_ms": old_graph,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(f"K2 rows={n} L={length}: mismatches={mism} kernel_ms={kern_ms:.6f} "
              f"graph_ms={kern_graph:.6f} replaced_design_ms={old_ms:.6f} "
              f"replaced_design_graph_ms={old_graph:.6f} plain_ms={plain_ms:.6f} "
              f"bound_us={bound_ms * 1e3:.3f} ({bound_by}) "
              f"achieved_GBps={n * length / (kern_ms * 1e-3) / 1e9:.3f} "
              f"bound_share={bound_ms / kern_ms:.4f} graph_share={bound_ms / kern_graph:.4f} "
              f"replaced_graph_share={bound_ms / old_graph:.4f}")
        require(mism == 0, f"K2 L={length}: {mism} digest bytes differ from blake3_batch_ref")
    return rows


def split_k3(dev, gen, bm, s: int, b: int = 64) -> dict:
    """Where the time of a K3 dispatch goes, by CUDA events (eager, 20
    calls) and CUDA-graph replay at B=64: the parts of the design that
    copied the data shards into one k+m buffer (allocation and copy, K1
    writing parity through the buffer's strided view, K2 on the buffer;
    the replaced K2 too), beside K1 into a contiguous tensor, K2 reading
    the pieces where they lie, and K3 as it is."""
    n = K + M
    x = rand_u8((b, K, s), gen, dev)
    shards = torch.empty((b, n, s), dtype=torch.uint8, device=dev)
    shards[:, :K].copy_(x)
    parity = torch.empty((b, M, s), dtype=torch.uint8, device=dev)
    flat_out = torch.empty((b * n, 32), dtype=torch.uint8, device=dev)

    def alloc_copy():
        buf = torch.empty((b, n, s), dtype=torch.uint8, device=dev)
        buf[:, :K].copy_(x)

    def copy_k3():  # the design K3 replaced, its K2 included
        buf = torch.empty((b, n, s), dtype=torch.uint8, device=dev)
        buf[:, :K].copy_(x)
        gf_bitmatmul_cuda(bm, buf[:, :K], out=buf[:, K:])
        old_k2(buf.view(b * n, s), flat_out)

    parts = {
        "alloc_copy": alloc_copy,
        "k1_strided": lambda: gf_bitmatmul_cuda(bm, shards[:, :K], out=shards[:, K:]),
        "k1_contiguous": lambda: gf_bitmatmul_cuda(bm, x, out=parity),
        "k2_buffer": lambda: blake3_batch(shards.view(b * n, s)),
        "k2_replaced_buffer": lambda: old_k2(shards.view(b * n, s), flat_out),
        "k2_pieces": lambda: blake3_pieces(x, parity),
        "k3_copy_design": copy_k3,
        "k3": lambda: encode_hash_tensor(bm, x),
    }
    out = {name: {"ms": time_ms(fn, 20), "graph_ms": graph_ms(fn, 20)}
           for name, fn in parts.items()}
    k1_k2 = {w: out["k1_contiguous"][w] + out["k2_buffer"][w] for w in ("ms", "graph_ms")}
    print(f"K3 split B={b} S={s} (ms eager / graph): " + "; ".join(
        f"{name} {v['ms']:.6f} / {v['graph_ms']:.6f}" for name, v in out.items()))
    print(f"K3 B={b}: k3 {out['k3']['ms']:.6f} / {out['k3']['graph_ms']:.6f} ms against "
          f"K1 + K2 alone {k1_k2['ms']:.6f} / {k1_k2['graph_ms']:.6f} ms: "
          f"{out['k3']['ms'] / k1_k2['ms']:.4f}x eager, "
          f"{out['k3']['graph_ms'] / k1_k2['graph_ms']:.4f}x graph")
    return {"parts": out, "k1_plus_k2": k1_k2}


def time_composites(dev, gen, sm_count: int, clock_hz: float) -> dict:
    """K3 (`encode_hash_tensor`: K1, then K2 over the data and parity
    pieces where they lie, on one stream) at a full batcher dispatch,
    B=64, and K5 (the pipeline's `fwd`: K3 plus the scrub statistics) at
    phase 5's scrub batch, B=256; EC(8,3), 1 MiB blocks.  Each timed
    eagerly and by CUDA-graph replay, against the same composition of the
    plain versions (K1's in 64-block chunks) and against its bound: K1's
    byte bound plus K2's operation bound at the same shape.  Then K3's
    split (`split_k3`)."""
    s = BLOCK // K
    bm = coding_state_from_numpy(gf.cauchy_parity_matrix(K, M), dev)["bitmat"]
    fwd = ScrubRepairPipeline(K, M, s, device=dev).encode_and_hash_fn()

    def plain(x, stats: bool):
        par = torch.cat([gf_bitmatmul(bm, x[i:i + 64]) for i in range(0, x.shape[0], 64)])
        h = blake3_pieces_ref(x, par)
        return (par, h, scrub_stats(h)) if stats else (par, h)

    rows = {}
    for name, b, kern, stats in (("K3", 64, lambda x: encode_hash_tensor(bm, x), False),
                                 ("K5", 256, fwd, True)):
        x = rand_u8((b, K, s), gen, dev)
        got, want = kern(x), plain(x, stats)
        torch.cuda.synchronize()
        mism = sum(diff(g, w)[0] for g, w in zip(got, want))
        require(mism == 0, f"{name}: {mism} elements differ from the plain versions")
        ms = time_ms(lambda: kern(x), 20)
        g_ms = graph_ms(lambda: kern(x), 20)
        plain_ms = time_ms(lambda: plain(x, stats), 1)
        k1_ms = (b * K * s + b * M * s + bm.numel()) / HBM_BYTES_PER_S * 1e3
        k2_ms, k2_by = blake3_bound_ms(b * (K + M), s, sm_count, clock_hz)
        rows[name] = {"ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                      "bound_ms": k1_ms + k2_ms}
        print(f"{name} B={b} S={s}: mismatches={mism} ms={ms:.6f} graph_ms={g_ms:.6f} "
              f"plain_ms={plain_ms:.6f} bound_ms={k1_ms + k2_ms:.6f} (K1 bytes {k1_ms:.6f} "
              f"+ K2 {k2_by} {k2_ms:.6f}) bound_share={(k1_ms + k2_ms) / ms:.4f} "
              f"bound_share_graph={(k1_ms + k2_ms) / g_ms:.4f}")
    rows["K3_split"] = split_k3(dev, gen, bm, s)
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


# --- phase 6: the mesh fan-out ----------------------------------------------------

MESH_N = 4
LOST164 = [0, 5, 17, 19]


def compute_s(kernel: str) -> float:
    """Kernel seconds (CUDA events) the dispatch telemetry has recorded
    for `kernel` so far."""
    return registry.durations.get(
        ("tpu_codec_compute_duration", (("kernel", kernel),)), (0, 0.0))[1]


def engaged(kernel: str, platform: str) -> float:
    return registry.counters.get(("tpu_mesh_engaged_total", (
        ("kernel", kernel), ("platform", platform), ("devices", str(MESH_N)))), 0.0)


def host_fold(hashes: np.ndarray) -> int:
    words = hashes.reshape(-1, 4).astype(np.uint32) @ (256 ** np.arange(4)).astype(np.uint32)
    return int(np.bitwise_xor.reduce(words))


def drive_mesh(dev, mesh) -> dict:
    """The fan-out's main path, with the launch counters set to 0 just
    before it and read just after, then its checks (whose launches are
    not counted).  Returns the counts and what `time_mesh` reuses."""
    rng = np.random.default_rng(SEED + 6)
    s83 = BLOCK // K
    raw83 = rng.integers(0, 256, (256, K, s83), dtype=np.uint8)
    blocks83 = [raw83[i].tobytes() for i in range(256)]
    k2, m2 = 16, 4
    raw164 = rng.integers(0, 256, (259, k2, BLOCK // k2), dtype=np.uint8)
    blocks164 = [raw164[i].tobytes() for i in range(259)]
    pipe = ScrubRepairPipeline(K, M, s83, device=dev)
    scrub_data = {b: rng.integers(0, 256, (b, K, s83), dtype=np.uint8) for b in (11, 259)}
    codec83 = EcCodec(K, M, device=dev, mesh=mesh)
    codec164 = EcCodec(k2, m2, device=dev, mesh=mesh)
    plat = dev.type
    engaged0 = {kern: engaged(kern, plat) for kern in ("ec_encode", "ec_reconstruct")}

    gf_bitmatmul_cuda.launches = 0
    blake3_batch.launches = 0
    enc83 = codec83.encode_batch(blocks83)
    pieces164 = codec164.encode_batch(blocks164)
    batches = [({j: p for j, p in enumerate(pieces) if j not in LOST164}, LOST164, BLOCK)
               for pieces in pieces164]
    rebuilt = codec164.reconstruct_batch(batches)
    scrubbed = {b: pipe.sharded_apply(mesh, x) for b, x in scrub_data.items()}
    dryrun_multichip(MESH_N, devices=mesh.devices)
    launches = {"gf": gf_bitmatmul_cuda.launches, "blake3": blake3_batch.launches}
    if dev.type == "cuda":
        require(launches["gf"] > 0, "the mesh phase never launched K1")
        require(launches["blake3"] > 0, "the mesh phase never launched K2")
    for kern, before in engaged0.items():
        require(engaged(kern, plat) > before,
                f"tpu_mesh_engaged_total{{kernel={kern}}} did not move")
    print(f"mesh phase launches: K1 {launches['gf']}, K2 {launches['blake3']}; "
          f"tpu_mesh_engaged_total devices={MESH_N}: ec_encode {engaged('ec_encode', plat):.0f}, "
          f"ec_reconstruct {engaged('ec_reconstruct', plat):.0f}")

    mism = 0
    # EC(8,3) encode: against the single-device path, a sample against the oracle
    par83 = np.stack([np.frombuffer(b"".join(p[K:]), dtype=np.uint8).reshape(M, s83)
                      for p in enc83])
    mism += int((par83 != EcCuda(K, M, device=dev, n_devices=1).encode(raw83)).sum())
    require(all(p[:K] == [bytes(d) for d in raw83[i]] for i, p in enumerate(enc83)),
            "mesh encode: data pieces differ from the blocks")
    for i in (0, 131, 255):
        require(np.array_equal(par83[i], gf.encode_blocks_ref(raw83[i], K, M)),
                f"mesh encode: block {i} parity differs from the oracle")
    # EC(16,4): encode against the single-device path, repair against the original shards
    par164 = np.stack([np.frombuffer(b"".join(p[k2:]), dtype=np.uint8).reshape(m2, -1)
                       for p in pieces164])
    mism += int((par164 != EcCuda(k2, m2, device=dev, n_devices=1).encode(raw164)).sum())
    require(np.array_equal(par164[7], gf.encode_blocks_ref(raw164[7], k2, m2)),
            "mesh EC(16,4) encode: block 7 parity differs from the oracle")
    full164 = np.concatenate([raw164, par164], axis=1)
    got164 = np.stack([np.stack([np.frombuffer(r[w], dtype=np.uint8) for w in LOST164])
                       for r in rebuilt])
    mism += int((got164 != full164[:, LOST164]).sum())
    # sharded_apply: against the single-device step and a host fold
    fwd = pipe.encode_and_hash_fn()
    for b, (parity, hashes, stats) in scrubbed.items():
        want = [t.cpu().numpy() for t in fwd(torch.from_numpy(scrub_data[b]).to(dev))]
        mism += int((parity != want[0]).sum()) + int((hashes != want[1]).sum())
        require(np.array_equal(stats, want[2]), f"sharded_apply {b}: stats {stats} != {want[2]}")
        require(int(stats[0]) == b and int(stats[1]) == host_fold(hashes),
                f"sharded_apply {b}: stats differ from the host count and fold")
    require(mism == 0, f"mesh phase: {mism} bytes differ from the single-device path")
    print(f"mesh checks: EC(8,3) 256-block encode, EC(16,4) 259-block encode and repair of "
          f"ranks {LOST164}, sharded_apply at 11 and 259 blocks, dryrun_multichip({MESH_N}): "
          f"all exact")
    return {"launches": launches, "mismatches": mism, "raw83": raw83, "blocks83": blocks83,
            "batches164": batches, "pipe": pipe, "x259": scrub_data[259]}


def event_s(fn) -> float:
    """Seconds between CUDA events on the current stream around fn(),
    which ends in a device->host copy."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def time_mesh(dev, mesh, run: dict) -> dict:
    """Wall and kernel time of the 4-entry and the 1-entry runs of the
    same work, in turns (4, 1, 1, 4); then the fan-out of K1 at the
    256-block EC(8,3) encode on device-resident slices, against one
    launch over the whole batch and against the plain version."""
    k2, m2 = 16, 4
    codecs = {
        "encode 256 x 1 MiB EC(8,3)": ("ec_encode", "encode_batch", run["blocks83"],
                                       EcCodec(K, M, device=dev, mesh=mesh),
                                       EcCodec(K, M, device=dev, n_devices=1)),
        "repair 259 x 1 MiB EC(16,4)": ("ec_reconstruct", "reconstruct_batch", run["batches164"],
                                        EcCodec(k2, m2, device=dev, mesh=mesh),
                                        EcCodec(k2, m2, device=dev, n_devices=1)),
    }
    for label, (kernel, method, arg, fan_codec, one_codec) in codecs.items():
        res = {"mesh": [], "single": []}
        for name, codec in (("mesh", fan_codec), ("single", one_codec),
                            ("single", one_codec), ("mesh", fan_codec)):
            k0, t0 = compute_s(kernel), time.perf_counter()
            getattr(codec, method)(arg)
            res[name].append((time.perf_counter() - t0, compute_s(kernel) - k0))
        print(f"mesh times {label}: " + "; ".join(
            f"{name} wall_s={[round(w, 6) for w, _ in v]} kernel_s={[round(k, 6) for _, k in v]}"
            for name, v in res.items()))
    pipe, x259 = run["pipe"], run["x259"]
    fwd = pipe.encode_and_hash_fn()
    res = {"mesh": [], "single": []}
    for name in ("mesh", "single", "single", "mesh"):
        t0 = time.perf_counter()
        if name == "mesh":
            ks = event_s(lambda: pipe.sharded_apply(mesh, x259))
        else:
            ks = event_s(lambda: [t.cpu() for t in fwd(torch.from_numpy(x259).to(dev))])
        res[name].append((time.perf_counter() - t0, ks))
    print("mesh times sharded_apply 259 x EC(8,3) (kernel_s: events around the whole call, "
          "copies included): " + "; ".join(
              f"{name} wall_s={[round(w, 6) for w, _ in v]} kernel_s={[round(k, 6) for _, k in v]}"
              for name, v in res.items()))

    raw83 = run["raw83"]
    s83 = raw83.shape[2]
    x = torch.from_numpy(raw83).to(dev)
    xparts = mesh.scatter(x, 256)
    enc = gf.cauchy_parity_matrix(K, M)
    bms = [coding_state_from_numpy(enc, d)["bitmat"] for d in mesh.devices]
    outs = ec_apply_mesh(mesh, bms, xparts)
    mesh.join(outs)
    fan = torch.cat([o.to(dev) for o in outs])
    plain = torch.cat([gf_bitmatmul(bms[0], x[i:i + 64]) for i in range(0, 256, 64)])
    mism, err = diff(fan, plain)
    require(mism == 0, f"K1 fan-out: {mism} bytes differ from gf_bitmatmul")
    def fan_out():
        ec_apply_mesh(mesh, bms, xparts)
        mesh.join()

    fan_ms, fan_graph = time_ms(fan_out, 20), graph_ms(fan_out, 20)
    one_ms = time_ms(lambda: gf_bitmatmul_cuda(bms[0], x), 20)
    one_graph = graph_ms(lambda: gf_bitmatmul_cuda(bms[0], x), 20)
    plain_ms = time_ms(lambda: [gf_bitmatmul(bms[0], x[i:i + 64]) for i in range(0, 256, 64)], 1)
    bound_ms = (256 * K * s83 + 256 * M * s83) / HBM_BYTES_PER_S * 1e3
    print(f"K6 fan-out of K1, EC(8,3) B=256 S={s83} over {MESH_N} entries: mismatches={mism} "
          f"fanout_ms={fan_ms:.6f} fanout_graph_ms={fan_graph:.6f} one_launch_ms={one_ms:.6f} "
          f"one_launch_graph_ms={one_graph:.6f} plain_ms={plain_ms:.6f} "
          f"bound_ms={bound_ms:.6f} bound_share={bound_ms / fan_ms:.4f}")
    return {"mismatches": mism, "max_abs_err": err, "ms": fan_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms}


# --- phase 7: the block store ----------------------------------------------------

N_NODES = K + M  # one rank of every block on each node
N_BLOCKS = 256  # one repair round (RepairWorker.EC_REPAIR_BATCH)
N_CLIENTS = 32
# With as many nodes as pieces, every block has the same rank order, so
# each node holds one fixed rank; the parts pick their nodes by rank.
STOPPED_RANKS = (0, 3, 9)  # the degraded GETs run without 2 data ranks and 1 parity
READER_RANK = 5
# the degraded GETs go through another node: the reader's read cache
# holds the blocks it has just served
DEGRADED_READER_RANK = 6
BLOCK_STORE_TIMEOUT_S = 600  # a stuck part fails the phase instead of the call


def breakdown_delta(before: dict, after: dict) -> dict:
    """Per codec kernel, what the dispatch telemetry recorded between two
    `dispatch_breakdown()` readings."""
    out = {}
    for kern, row in after.items():
        prev = before.get(kern, {})
        d = {k: v - prev.get(k, 0) for k, v in row.items()}
        if d.get("dispatches"):
            out[kern] = d
    return out


class Part:
    """Wall time, K1/K2/K3 launches, kernel seconds and dispatch
    breakdown of one part of phases 7 and 8, printed when the part ends."""

    def __init__(self, name: str, results: dict, label: str = "block store"):
        self.name, self.results, self.label = name, results, label

    def __enter__(self):
        self.k1, self.k2 = gf_bitmatmul_cuda.launches, blake3_batch.launches
        self.k3 = encode_hash_tensor.launches
        self.disp = dispatch_breakdown()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        wall = time.perf_counter() - self.t0
        disp = breakdown_delta(self.disp, dispatch_breakdown())
        row = {"wall_s": wall, "k1_launches": gf_bitmatmul_cuda.launches - self.k1,
               "k2_launches": blake3_batch.launches - self.k2,
               "k3_launches": encode_hash_tensor.launches - self.k3,
               "kernel_s": sum(d.get("kernel_s", 0.0) for d in disp.values()),
               "dispatches": disp}
        self.results[self.name] = row
        print(f"{self.label} {self.name}: wall_s={wall:.6f} K1={row['k1_launches']} "
              f"K2={row['k2_launches']} K3={row['k3_launches']} "
              f"kernel_s={row['kernel_s']:.6f} dispatch={json.dumps(disp)}")
        return False


def count_codec_calls(codec, methods) -> dict:
    """Wrap `methods` of one node's EcCodec to tally, per method, its
    calls, the blocks they carried, the `ec_reconstruct` dispatches they
    made (ops/telemetry.py's records) and their K1 launches."""
    key = ("tpu_codec_dispatch_total", (("kernel", "ec_reconstruct"),
                                        ("platform", codec._ec.platform)))
    tally = {}
    for method in methods:
        row = tally[method] = {"calls": 0, "blocks": 0, "dispatches": 0, "k1_launches": 0}
        fn = getattr(codec, method)

        def wrapped(items, *impl, _fn=fn, _row=row):
            d0, k0 = registry.counters.get(key, 0.0), gf_bitmatmul_cuda.launches
            try:
                return _fn(items, *impl)
            finally:
                _row["calls"] += 1
                _row["blocks"] += len(items)
                _row["dispatches"] += int(registry.counters.get(key, 0.0) - d0)
                _row["k1_launches"] += gf_bitmatmul_cuda.launches - k0

        setattr(codec, method, wrapped)
    return tally


def piece_files(mgr, hashes) -> dict:
    """{(hash, rank): file bytes} of every piece `mgr` holds."""
    return {(h, r): open(path, "rb").read()
            for h in hashes for r, (path, _c) in mgr.local_pieces(h).items()}


async def all_pieces_stored(nodes, hashes) -> None:
    """Wait until every node holds its own rank of every block."""
    pending = {(x.index, h) for x in nodes for h in hashes}

    def check() -> bool:
        pending.difference_update({
            (i, h) for i, h in list(pending)
            if nodes[i].manager.find_block_file(h, piece=nodes[i].manager.ec_ranks_of(h)[0])})
        return not pending

    await wait_until(check, 60, "every node holds its rank of every block")


def reference(mgr, hashes) -> None:
    """Reference the blocks in `mgr`'s rc, as the block_ref table would:
    repair and resync act only on referenced blocks."""
    mgr.db.transaction(lambda tx: [mgr.rc.incr(tx, h) for h in hashes] and None)


async def gather_limited(n: int, items, fn):
    """fn(item) for every item, at most `n` in flight (n clients)."""
    it = iter(enumerate(items))
    out = [None] * len(items)

    async def client():
        for i, item in it:
            out[i] = await fn(item)

    await asyncio.gather(*[client() for _ in range(n)])
    return out


async def drive_block_store(dev, root) -> dict:
    """Phase 7's main path on an 11-node EC(8,3) cluster of this package's
    nodes; the launch counters are set to 0 by the caller just before."""
    rng = np.random.default_rng(SEED + 7)
    raw = rng.integers(0, 256, (N_BLOCKS, BLOCK), dtype=np.uint8)
    blocks = [raw[i].tobytes() for i in range(N_BLOCKS)]
    hashes = [blake2sum(b) for b in blocks]
    s = EcCodec(K, M, device="cpu").piece_len(BLOCK)
    res: dict = {}
    keys = [rng.bytes(32) for _ in range(N_NODES)]  # node ids from the seed
    nodes = await make_cluster(root, N_NODES, lambda i: EcCodec(K, M, device=dev), keys=keys)
    down: set[int] = set()
    try:
        layout = nodes[0].system.layout_manager.history.current()
        order = layout.nodes_of(hashes[0])
        require(all(layout.nodes_of(h) == order for h in hashes),
                "the blocks do not share one rank order")
        index_of = {x.app.id: x.index for x in nodes}
        by_rank = [index_of[n] for n in order]
        stopped = [by_rank[r] for r in STOPPED_RANKS]
        reader, degraded_reader = by_rank[READER_RANK], by_rank[DEGRADED_READER_RANK]
        print(f"block store: node index by rank {by_rank}")
        with Part("put", res):  # until every PUT is acknowledged (its piece quorum)
            await gather_limited(N_CLIENTS, list(zip(hashes, blocks)),
                                 lambda hb: nodes[0].manager.rpc_put_block(*hb))
        with Part("put_settle", res):  # until the last background piece send lands
            await all_pieces_stored(nodes, hashes)
        for x in nodes:
            reference(x.manager, hashes)
        files = [piece_files(x.manager, hashes) for x in nodes]
        for x, node_files in zip(nodes, files):
            require(sorted(node_files) == sorted((h, x.manager.ec_ranks_of(h)[0]) for h in hashes),
                    f"PUT: node {x.index} does not hold exactly its rank of every block")
        heads, pieces = [], []
        for node_files in files:
            for stored in node_files.values():
                heads.append(stored[12:44])
                pieces.append(stored[44:])
        require(all(len(p) == s for p in pieces), "PUT: a piece has the wrong length")
        want = blake3_batch_ref(torch.from_numpy(
            np.frombuffer(b"".join(pieces), dtype=np.uint8).copy()).to(dev).view(-1, s))
        bad = int((want.cpu().numpy() != np.frombuffer(b"".join(heads), dtype=np.uint8)
                   .reshape(-1, 32)).any(axis=1).sum())
        require(bad == 0, f"PUT: {bad} stored header hashes differ from blake3_batch_ref")
        print(f"block store put: {N_BLOCKS} blocks x {BLOCK} B from {N_CLIENTS} clients on "
              f"node 0; {len(pieces)} piece files on {N_NODES} nodes, every header hash "
              f"equals the plain hasher's")

        with Part("get", res):
            got = await gather_limited(N_CLIENTS, hashes, nodes[reader].manager.rpc_get_block)
        bad = [i for i in range(N_BLOCKS) if got[i] != blocks[i]]
        require(not bad, f"GET: blocks {bad[:8]} differ from what was PUT")
        print(f"block store get: {N_BLOCKS} blocks through node {reader} (rank {READER_RANK}), "
              f"all exact")

        for i in stopped:
            await stop_node(nodes[i])
            down.add(i)
        with Part("degraded_get", res):
            got = await gather_limited(N_CLIENTS, hashes,
                                       nodes[degraded_reader].manager.rpc_get_block)
        bad = [i for i in range(N_BLOCKS) if got[i] != blocks[i]]
        require(not bad, f"degraded GET: blocks {bad[:8]} differ from what was PUT")
        # the card's decode kernel; a CPU rehearsal's codec decodes on the host
        decode_kernel = "ec_reconstruct" if dev.type == "cuda" else "ec_decode_host"
        decoded = res["degraded_get"]["dispatches"].get(decode_kernel, {})
        require(decoded.get("dispatches", 0) > 0, "degraded GET: no decode dispatch ran")
        if dev.type == "cuda":
            require(res["degraded_get"]["k1_launches"] > 0, "degraded GET never launched K1")
        print(f"block store degraded get: ranks {list(STOPPED_RANKS)} stopped, {N_BLOCKS} blocks "
              f"through node {degraded_reader} in {decoded['dispatches']} decode dispatches, "
              f"all exact")

        # the other stopped nodes come back with their disks; the first
        # comes back with its data dir wiped (a replaced drive)
        up = [x for i, x in enumerate(nodes) if i not in down]
        for i in (*stopped[1:], stopped[0]):
            if i == stopped[0]:
                shutil.rmtree(nodes[i].data_dir)
            nodes[i] = await restart_node(root, nodes[i], up, EcCodec(K, M, device=dev))
            down.discard(i)
            up.append(nodes[i])
            reference(nodes[i].manager, hashes)
        mgr = nodes[stopped[0]].manager
        tally = count_codec_calls(mgr.codec, ("decode_batch", "reconstruct_batch"))
        with Part("repair", res):
            rebuilt = await drive_bulk(mgr, hashes)
        require(rebuilt == N_BLOCKS, f"repair: rebuilt {rebuilt} of {N_BLOCKS} pieces")
        res["repair"]["codec_calls"] = tally
        print(f"block store repair dispatches: verification (decode_batch) "
              f"{json.dumps(tally['decode_batch'])}, rebuild (reconstruct_batch) "
              f"{json.dumps(tally['reconstruct_batch'])}")
        if dev.type == "cuda":
            require(res["repair"]["k1_launches"] > 0, "repair never launched K1")
            # one verification dispatch per erasure pattern (the blocks all
            # lack rank 0: one pattern), then the grouped rebuild
            require(res["repair"]["k1_launches"] <= 8,
                    f"repair: {res['repair']['k1_launches']} K1 launches, want at most 8")
        after = piece_files(mgr, hashes)
        require(after == files[stopped[0]],
                "repair: rebuilt piece files differ from the files before the wipe")
        print(f"block store repair: ranks {list(STOPPED_RANKS[1:])} restarted, rank "
              f"{STOPPED_RANKS[0]} restarted with its data dir wiped, {rebuilt} pieces rebuilt by "
              f"drive_bulk, byte-identical to the lost files")

        scrubbed = nodes[reader].manager
        before = files[reader]
        flipped = []
        for h in hashes[:3]:
            ((_r, (path, _c)),) = scrubbed.local_pieces(h).items()
            data = bytearray(open(path, "rb").read())
            data[44 + 1000] ^= 0x5A
            open(path, "wb").write(bytes(data))
            flipped.append(path)
        worker = ScrubWorker(scrubbed)
        worker.state.tranquility = 0
        with Part("scrub", res):
            while await worker.work() != WorkerState.IDLE:
                pass  # the pass is complete when the worker starts its rest
        require(worker.state.corruptions == 3,
                f"scrub: {worker.state.corruptions} corruptions found, want 3")
        require(all(os.path.exists(p + ".corrupted") and not os.path.exists(p)
                    for p in flipped), "scrub: the 3 corrupted files were not quarantined")
        if dev.type == "cuda":
            require(res["scrub"]["k2_launches"] > 0, "scrub never launched K2")
        with Part("resync", res):
            while await scrubbed.resync.resync_iter():
                pass
        require(piece_files(scrubbed, hashes) == before,
                "resync: the scrubbed node's piece files differ from the PUT's")
        print(f"block store scrub: 3 flipped bytes on node {reader}, 3 corruptions "
              f"found and quarantined, resync restored the exact files")
        await profile_host(nodes, rng, by_rank[7])
    finally:
        await stop_all([x for i, x in enumerate(nodes) if i not in down])
    return res


async def profile_host(nodes, rng, getter: int) -> None:
    """Where the host's time goes: 64 more PUTs from 32 clients on node 0
    and their GETs through node `getter`, under cProfile (on Python 3.12
    it also sees the worker threads of the codec dispatches and file
    I/O).  Outside the timed parts; its launches count with the phase."""
    more = [rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes() for _ in range(64)]
    pairs = [(blake2sum(b), b) for b in more]
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    await gather_limited(N_CLIENTS, pairs, lambda hb: nodes[0].manager.rpc_put_block(*hb))
    got = await gather_limited(N_CLIENTS, [h for h, _b in pairs],
                               nodes[getter].manager.rpc_get_block)
    prof.disable()
    wall = time.perf_counter() - t0
    require(got == more, "profiled GET: blocks differ from what was PUT")
    print_profile(prof, f"block store host profile (64 PUTs + 64 GETs, wall_s={wall:.6f}")


def print_profile(prof: cProfile.Profile, head: str) -> None:
    """The 15 functions with the most own time."""
    stats = pstats.Stats(prof)
    print(f"{head}, profiled_s={stats.total_tt:.6f}), top functions by own time:")
    rows = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:15]
    for (path, line, fn), (_cc, ncalls, tt, ct, _callers) in rows:
        print(f"  {tt:.6f}s own {ct:.6f}s cum {ncalls} calls "
              f"{'/'.join(Path(path).parts[-2:])}:{line} {fn}")


def run_block_store(dev) -> dict:
    root = Path(tempfile.mkdtemp(prefix="block-store-", dir=SCRATCH))
    try:
        return asyncio.run(asyncio.wait_for(drive_block_store(dev, root), BLOCK_STORE_TIMEOUT_S))
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- phase 8: the S3 cluster -----------------------------------------------------

S3_ENDPOINTS = 2  # nodes 0 and 1 serve S3
S3_CLIENTS = 8
N_BIG, BIG_BLOCKS = 64, 4  # 64 objects of 4 blocks (4 MiB)
N_SMALL, SMALL = 256, 1024  # under INLINE_THRESHOLD: inline in the object table
MPU_PARTS, PART_BLOCKS = 8, 8  # one upload of 8 parts of 8 blocks (8 MiB)
N_PROFILED = 16
N_SAMPLED = 8
S3_BUCKET = "smoke-bucket"
S3_TIMEOUT_S = 600  # a stuck part fails the phase instead of the call
# All 11 nodes share one process and one event loop, so a request waits
# on the whole cluster's work and the loop's lag is the whole cluster's:
# at the default request p99 target (1 s) and loop-lag p99 limit (0.5 s)
# the shedding ladder climbs to shedding writes (on an H100 host, a
# loop-lag p99 of 0.5-8 s took it to "shed-write" and a DeleteObject got
# 503 SlowDown).  The limits are raised, not the ladder switched off.
S3_EXTRA = {"admin": {"slo_latency_p99_target_msec": 60000.0},
            "overload": {"loop_lag_p99_msec": 60000.0}}


class CountingClient(S3Client):
    """The port's S3 client, tallying the status of every response."""

    def __init__(self, endpoint: str, key_id: str, secret: str, statuses: Counter):
        super().__init__(endpoint, key_id, secret)
        self.statuses = statuses

    async def _req(self, *a, **kw):
        st, h, data = await super()._req(*a, **kw)
        self.statuses[st] += 1
        return st, h, data


def record_batches(nodes, part: list[str]) -> dict:
    """Wrap every node's codec batcher lanes to record the size of each
    dispatch, per lane, under the part named by `part[0]` at the time."""
    sizes: dict = {}
    for x in nodes:
        batcher = x.garage.block_manager.batcher
        for lane in (batcher._encode, batcher._decode):
            def wrapped(items, impl, _fn=lane.dispatch_fn, _name=lane.name):
                sizes.setdefault(part[0], {}).setdefault(_name, []).append(len(items))
                return _fn(items, impl)

            lane.dispatch_fn = wrapped
    return sizes


def batch_summary(sizes: list[int]) -> dict:
    return {"dispatches": len(sizes), "blocks": sum(sizes), "max": max(sizes, default=0),
            "mean": sum(sizes) / len(sizes) if sizes else 0.0,
            "hist": dict(sorted(Counter(sizes).items()))}


def sampled_pieces(nodes, block: bytes) -> tuple[list[bytes], list[bytes]]:
    """(pieces in rank order, header hashes) of one block, read back from
    the piece files in every node's data directory (a stopped node's
    files included)."""
    h = blake2sum(block)
    found = {}
    for x in nodes:
        for rank, (path, compressed) in x.garage.block_manager.local_pieces(h).items():
            require(not compressed, f"piece {rank} of {h.hex()[:16]} is compressed")
            found[rank] = open(path, "rb").read()
    return pieces_in_rank_order(h, found)


def pieces_in_rank_order(h: bytes, found: dict) -> tuple[list[bytes], list[bytes]]:
    """(pieces, header hashes) of block `h` from its piece files' bytes by
    rank, which must hold every rank."""
    require(sorted(found) == list(range(K + M)),
            f"block {h.hex()[:16]}: piece files of ranks {sorted(found)} on disk")
    return [found[r][44:] for r in range(K + M)], [found[r][12:44] for r in range(K + M)]


def check_pieces(dev, pieces_of, blocks: list[bytes]) -> int:
    """The sampled blocks' pieces on disk (`pieces_of(block)`: pieces and
    header hashes in rank order) against the plain versions on the card:
    the data pieces are the block's bytes, the parity pieces equal
    `gf_bitmatmul` of the data pieces, and every header hash equals
    `blake3_batch_ref` of its piece.  Returns the pieces checked."""
    s = BLOCK // K
    bm = coding_state_from_numpy(gf.cauchy_parity_matrix(K, M), dev)["bitmat"]
    pieces, heads = zip(*(pieces_of(b) for b in blocks))
    flat = torch.from_numpy(np.frombuffer(
        b"".join(p for ps in pieces for p in ps), dtype=np.uint8).copy()).to(dev)
    require(flat.numel() == len(blocks) * (K + M) * s, "sampled pieces: wrong lengths")
    flat = flat.view(len(blocks), K + M, s)
    for i, b in enumerate(blocks):
        require(b"".join(pieces[i][:K]) == b, f"sampled block {i}: data pieces differ")
    parity = gf_bitmatmul(bm, flat[:, :K].contiguous())
    mism, _err = diff(parity, flat[:, K:])
    require(mism == 0, f"sampled blocks: {mism} parity bytes differ from gf_bitmatmul")
    want = blake3_batch_ref(flat.view(-1, s)).cpu().numpy()
    got = np.frombuffer(b"".join(h for hs in heads for h in hs), dtype=np.uint8).reshape(-1, 32)
    bad = int((want != got).any(axis=1).sum())
    require(bad == 0, f"sampled blocks: {bad} header hashes differ from blake3_batch_ref")
    return len(blocks) * (K + M)


def s3_objects(rng) -> tuple[list[bytes], list[bytes]]:
    """The 4 MiB and the 1 KiB objects of phases 8 and 9, drawn from
    `rng` (both phases draw them from a generator seeded `SEED + 8`, so
    they move the same bytes)."""
    big = [rng.integers(0, 256, BIG_BLOCKS * BLOCK, dtype=np.uint8).tobytes()
           for _ in range(N_BIG)]
    small = [rng.integers(0, 256, SMALL, dtype=np.uint8).tobytes() for _ in range(N_SMALL)]
    return big, small


async def drive_s3(dev, root) -> dict:
    """Phase 8's main path: 11 nodes of this package, each a whole
    `Garage` with its EcCodec(8, 3) on the card, S3 on the first two,
    driven through the port's own `S3Client`.  The launch counters are
    set to 0 by the caller just before."""
    rng = np.random.default_rng(SEED + 8)
    big_len, part_len = BIG_BLOCKS * BLOCK, PART_BLOCKS * BLOCK
    big, small = s3_objects(rng)
    parts = [rng.integers(0, 256, part_len, dtype=np.uint8).tobytes() for _ in range(MPU_PARTS)]
    keys = [rng.bytes(32) for _ in range(N_NODES)]  # node ids from the seed
    res: dict = {}
    statuses: Counter = Counter()
    label = "s3"
    nodes = await make_s3_cluster(root, N_NODES, mode=f"ec:{K}:{M}", block_size=BLOCK,
                                  engine="sqlite", device=str(dev), s3_nodes=S3_ENDPOINTS,
                                  keys=keys, extra=S3_EXTRA)
    part = [None]
    batches = record_batches(nodes, part)
    clients: list[CountingClient] = []
    other: list[CountingClient] = []
    down: set[int] = set()
    try:
        part[0] = "setup"
        key_id, secret = await make_key(nodes[0].garage, "smoke-key")
        eps = [x.endpoint for x in nodes[:S3_ENDPOINTS]]
        # client c talks to endpoint c % 2; other[c] to the other endpoint
        clients = [CountingClient(eps[c % S3_ENDPOINTS], key_id, secret, statuses)
                   for c in range(S3_CLIENTS)]
        other = [CountingClient(eps[(c + 1) % S3_ENDPOINTS], key_id, secret, statuses)
                 for c in range(S3_CLIENTS)]
        await clients[0].create_bucket(S3_BUCKET)
        require(S3_BUCKET in await other[0].list_buckets(), "the bucket is not listed")
        print(f"s3 setup: {N_NODES} nodes EC({K},{M}), block {BLOCK} B, sqlite, meta rf 3, "
              f"S3 on nodes 0 and 1; key {key_id} through GarageHelper, bucket {S3_BUCKET}")

        big_keys = [f"big/{i:03d}" for i in range(N_BIG)]
        small_keys = [f"small/{i:04d}" for i in range(N_SMALL)]
        etags: dict[str, str] = {}

        async def put_share(c: int, items):
            for k, body in items[c::S3_CLIENTS]:
                etags[k] = await clients[c].put_object(S3_BUCKET, k, body)

        part[0] = "put"
        with Part("put", res, label):
            await asyncio.gather(*[put_share(c, list(zip(big_keys, big)))
                                   for c in range(S3_CLIENTS)])
        with Part("put_small", res, label):
            await asyncio.gather(*[put_share(c, list(zip(small_keys, small)))
                                   for c in range(S3_CLIENTS)])
        bad = [k for k, b in zip(big_keys + small_keys, big + small)
               if etags[k] != hashlib.md5(b).hexdigest()]
        require(not bad, f"PUT: ETags of {bad[:4]} are not the MD5 of the body")
        if dev.type == "cuda":
            require(res["put"]["k3_launches"] > 0, "the S3 PUTs never launched K3")
        require(res["put_small"]["k1_launches"] == 0 and not res["put_small"]["dispatches"],
                "the inline PUTs reached the codec")

        part[0] = "multipart"
        mpu_key = "mpu/object"
        with Part("multipart", res, label):
            uid = await clients[0].create_multipart_upload(S3_BUCKET, mpu_key)
            part_etags = await asyncio.gather(*[
                clients[i % S3_CLIENTS].upload_part(S3_BUCKET, mpu_key, uid, i + 1, p)
                for i, p in enumerate(parts)])
            listed = await other[0].list_parts(S3_BUCKET, mpu_key, uid)
            await clients[1].complete_multipart_upload(
                S3_BUCKET, mpu_key, uid, list(enumerate(part_etags, 1)))
        require([(p["part"], p["etag"], p["size"]) for p in listed]
                == [(i + 1, hashlib.md5(p).hexdigest(), part_len) for i, p in enumerate(parts)],
                f"ListParts: {listed}")
        mpu_body = b"".join(parts)

        # one object under a customer key (SSE-C): AES-GCM on the host,
        # the ciphertext's blocks through the codec
        part[0] = "sse_c"
        sse_key = rng.bytes(32)
        sse = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
               "x-amz-server-side-encryption-customer-key": base64.b64encode(sse_key).decode(),
               "x-amz-server-side-encryption-customer-key-md5":
                   base64.b64encode(hashlib.md5(sse_key).digest()).decode()}
        sse_body = big[-1][::-1]
        with Part("sse_c", res, label):
            st, _h, data = await clients[0]._req("PUT", f"/{S3_BUCKET}/sse/object",
                                                  body=sse_body, headers=dict(sse))
            clients[0]._check(st, data)
            got_sse = await other[0].get_object(S3_BUCKET, "sse/object", headers=dict(sse))
        require(got_sse == sse_body, "SSE-C: the object read back differs")

        part[0] = "list"
        with Part("list", res, label):
            listed_keys = {}
            for prefix in ("big/", "small/", "mpu/", "sse/"):
                token, pages = None, 0
                while True:
                    page = await other[pages % S3_CLIENTS].list_objects_v2(
                        S3_BUCKET, prefix=prefix, max_keys=100, continuation_token=token)
                    listed_keys.update({e["key"]: (e["size"], e["etag"]) for e in page["keys"]})
                    pages += 1
                    token = page["next_token"]
                    if not page["truncated"]:
                        break
        want_keys = {**{k: (big_len, etags[k]) for k in big_keys},
                     **{k: (SMALL, etags[k]) for k in small_keys}}
        require({k: v for k, v in listed_keys.items() if k not in (mpu_key, "sse/object")}
                == want_keys,
                "ListObjectsV2 did not return every key with its size and ETag")
        require(mpu_key in listed_keys and listed_keys[mpu_key][0] == len(mpu_body),
                "ListObjectsV2: the multipart object is missing")

        async def get_share(c: int, ks, via):
            return [(k, await via[c].get_object(S3_BUCKET, k)) for k in ks[c::S3_CLIENTS]]

        part[0] = "get"
        with Part("get", res, label):
            # each object through the endpoint it was not PUT through
            got = await asyncio.gather(*[get_share(c, big_keys, other) for c in range(S3_CLIENTS)])
            got_mpu = await clients[0].get_object(S3_BUCKET, mpu_key)
            lo = BLOCK - 100
            ranged = await other[1].get_object(S3_BUCKET, big_keys[0],
                                               range_=f"bytes={lo}-{BLOCK + 99}")
        body_of = dict(zip(big_keys, big))
        bad = [k for kb in got for k, b in kb if b != body_of[k]]
        require(not bad, f"GET: {bad[:4]} differ from what was PUT")
        require(got_mpu == mpu_body, "GET: the multipart object differs")
        require(ranged == big[0][lo:BLOCK + 100], "ranged GET across a block boundary differs")
        with Part("get_small", res, label):
            got = await asyncio.gather(*[get_share(c, small_keys, other)
                                         for c in range(S3_CLIENTS)])
        body_of = dict(zip(small_keys, small))
        require(all(b == body_of[k] for kb in got for k, b in kb), "GET: inline objects differ")

        # one node stopped, chosen by rank: the lowest data rank that
        # serves no S3 endpoint (every block has the same rank order)
        layout = nodes[0].garage.layout_manager.history.current()
        hashes = [blake2sum(b[j * BLOCK:(j + 1) * BLOCK]) for b in big for j in range(BIG_BLOCKS)]
        order = layout.nodes_of(hashes[0])
        require(all(layout.nodes_of(h) == order for h in hashes[:64]),
                "the blocks do not share one rank order")
        index_of = {x.garage.node_id: x.index for x in nodes}
        by_rank = [index_of[n] for n in order]
        victim_rank = next(r for r in range(K) if by_rank[r] >= S3_ENDPOINTS)
        victim = by_rank[victim_rank]
        await stop_s3_node(nodes[victim])
        down.add(victim)
        part[0] = "degraded_get"
        with Part("degraded_get", res, label):
            # through the endpoint each object was PUT through: its read
            # cache holds the other endpoint's objects, not these
            got = await asyncio.gather(*[get_share(c, big_keys, clients)
                                         for c in range(S3_CLIENTS)])
        body_of = dict(zip(big_keys, big))
        bad = [k for kb in got for k, b in kb if b != body_of[k]]
        require(not bad, f"degraded GET: {bad[:4]} differ from what was PUT")
        if dev.type == "cuda":
            require(res["degraded_get"]["k1_launches"] > 0, "the degraded GETs never launched K1")
        print(f"s3 degraded get: node {victim} (rank {victim_rank}) stopped, {N_BIG} objects "
              f"of {big_len} B byte-exact through their PUT endpoints")

        part[0] = "delete"
        with Part("delete", res, label):
            await clients[0].delete_object(S3_BUCKET, small_keys[0])
            try:
                await other[0].get_object(S3_BUCKET, small_keys[0])
                require(False, "GET of a deleted key succeeded")
            except S3Error as e:
                require(e.status == 404 and e.code == "NoSuchKey",
                        f"GET of a deleted key: {e.status} {e.code}")

        part[0] = "pieces"
        sample = [big[i][j * BLOCK:(j + 1) * BLOCK] for i, j in zip(
            range(0, N_BIG, N_BIG // N_SAMPLED), [n % BIG_BLOCKS for n in range(N_SAMPLED)])]
        checked = check_pieces(dev, lambda b: sampled_pieces(nodes, b), sample)
        print(f"s3 pieces: {len(sample)} sampled blocks, {checked} piece files: data pieces "
              f"are the blocks' bytes, parity equals gf_bitmatmul, every header hash equals "
              f"blake3_batch_ref, on {dev}")

        codes = {st: n for st, n in sorted(statuses.items())}
        require(all(200 <= st < 300 for st in codes if st != 404) and codes.get(404) == 1,
                f"response statuses {codes}: want 2xx, and one 404")
        mib = 1 << 20
        put_bytes, get_bytes = N_BIG * big_len, N_BIG * big_len + len(mpu_body)
        res["rates_mib_s"] = {
            "put": put_bytes / mib / res["put"]["wall_s"],
            "put_small_objects_per_s": N_SMALL / res["put_small"]["wall_s"],
            "multipart": len(mpu_body) / mib / res["multipart"]["wall_s"],
            "get": get_bytes / mib / res["get"]["wall_s"],
            "degraded_get": put_bytes / mib / res["degraded_get"]["wall_s"],
        }
        res["batches"] = {p: {lane: batch_summary(v) for lane, v in lanes.items()}
                          for p, lanes in batches.items()}
        res["statuses"] = codes
        print(f"s3 rates: {json.dumps({k: round(v, 6) for k, v in res['rates_mib_s'].items()})}")
        print(f"s3 codec batches: {json.dumps(res['batches'])}")
        print(f"s3 statuses: {json.dumps(codes)}")
        res["layers"] = layer_latencies()
        print(f"s3 layer latencies (count, mean_s, p99_s as a bucket bound): "
              f"{json.dumps(res['layers'])}")
        part[0] = "profile"
        await profile_s3(dev, clients, other, rng)
    finally:
        for c in clients + other:
            await c.close()
        await stop_s3_cluster([x for i, x in enumerate(nodes) if i not in down])
    return res


LAYER_FAMILIES = ("api_s3_request_duration", "table_get_request_duration",
                  "table_put_request_duration", "table_range_request_duration")


def layer_latencies() -> dict:
    """Per label set of the S3 API's and the tables' request-duration
    histograms (the S3 method; the table), over the phase so far:
    count, mean seconds and p99 (the upper bound of its bucket)."""
    out: dict = {}
    for (name, labels), (cnt, total, _b) in sorted(registry.durations.items()):
        if name in LAYER_FAMILIES and cnt:
            label = ",".join(v for _k, v in labels)
            out.setdefault(name, {})[label] = [cnt, round(total / cnt, 6),
                                               registry.quantile(name, labels, 0.99)]
    return out


async def profile_s3(dev, clients, other, rng) -> None:
    """Where the host's time goes: 16 more 4 MiB PUTs from 8 clients and
    their GETs through the other endpoint, under cProfile.  Outside the
    timed parts; its launches count with the phase."""
    more = [(f"profiled/{i:02d}", rng.integers(0, 256, BIG_BLOCKS * BLOCK,
                                               dtype=np.uint8).tobytes())
            for i in range(N_PROFILED)]

    async def share(c: int):
        for k, b in more[c::S3_CLIENTS]:
            await clients[c].put_object(S3_BUCKET, k, b)
        return [(b, await other[c].get_object(S3_BUCKET, k)) for k, b in more[c::S3_CLIENTS]]

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    got = await asyncio.gather(*[share(c) for c in range(S3_CLIENTS)])
    prof.disable()
    wall = time.perf_counter() - t0
    require(all(a == b for pairs in got for a, b in pairs), "profiled GET differs")
    print_profile(prof, f"s3 host profile ({N_PROFILED} PUTs + {N_PROFILED} GETs of "
                        f"{BIG_BLOCKS * BLOCK} B, wall_s={wall:.6f}")


def run_s3(dev) -> dict:
    root = Path(tempfile.mkdtemp(prefix="s3-", dir=SCRATCH))
    try:
        return asyncio.run(asyncio.wait_for(drive_s3(dev, root), S3_TIMEOUT_S))
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- phase 9: the daemons --------------------------------------------------------

D_ENDPOINTS = (0, 1)  # S3 on daemons 0 and 1; K2V on daemon 0, the website on daemon 1
N_K2V = 256
K2V_PK = "smoke-room"
SITE_PAGES = {"index.html": 2, "about.html": 2}  # whole blocks of each page, plus a tail
DAEMON_UP_S = 180
DAEMON_STOP_S = 60  # each daemon exits 0 within this after SIGTERM
DAEMONS_TIMEOUT_S = 900  # a stuck part fails the phase instead of the call
SCRUB_FLIPS = 3
# The config's defaults but for two.  The durability scanner rescans
# every 2 s instead of every 60 s, so that the repair part can wait for
# `cluster durability` to report no missing pieces.  And, as in phase 8,
# the request p99 target and the loop-lag limit of the shedding ladder
# are raised: at the defaults (1 s, 0.5 s) the ladder of S3 daemon 0
# climbed to "shed-write" on a latency burn of 16.8-34.3 with a loop-lag
# p99 of 0 ms (4 MiB PUTs from 8 clients take about a second each), and
# the restarted daemon's to "repair-slow" on a loop-lag p99 of 512 ms
# (an H100 host).  The limits are raised, not the ladder switched off.
DAEMON_EXTRA = {"durability": {"interval_secs": 2.0, "tranquility": 0}, **S3_EXTRA}
REPAIR_S = 180
LOG_DIR = os.environ.get("SMOKE_DAEMON_LOGS")  # where the daemons' logs go on a failure
LAUNCH_FAMILY = "cuda_kernel_launches_total"
WRAPPERS = {"k1": "gf_bitmatmul_cuda", "k2": "blake3_batch", "k3": "encode_hash_tensor"}


class CountingK2V(K2VClient):
    """The port's K2V client, tallying the status of every response."""

    def __init__(self, endpoint: str, bucket: str, key_id: str, secret: str,
                 statuses: Counter):
        super().__init__(endpoint, bucket, key_id, secret)
        self.statuses = statuses

    async def _req(self, *a, **kw):
        st, h, data = await super()._req(*a, **kw)
        self.statuses[f"k2v {st}"] += 1
        return st, h, data


class Fleet:
    """Phase 9's daemons and what their `/metrics` say.  Counts are summed
    over every daemon process, those of a process that has ended (a
    stopped daemon's) included: `retire` keeps its last scrape."""

    def __init__(self, daemons: list[Daemon]):
        self.daemons = daemons
        self.last: dict[int, str] = {}  # daemon index -> its last exposition
        self.retired: Counter = Counter()

    async def scrape(self, sess) -> None:
        for d in self.daemons:
            if d.proc is None or d.proc.poll() is not None:
                continue
            async with sess.get(d.url(d.admin_port) + "/metrics",
                                headers={"Authorization": f"Bearer {METRICS_TOKEN}"}) as r:
                require(r.status == 200, f"daemon {d.index} /metrics: {r.status}")
                self.last[d.index] = await r.text()

    @staticmethod
    def counts(text: str) -> Counter:
        c = Counter()
        for lbl, v in metric_samples(text, LAUNCH_FAMILY):
            c[("launch", lbl["kernel"])] += v
        for lbl, v in metric_samples(text, "tpu_codec_dispatch_total"):
            c[("dispatch", lbl["kernel"], lbl["platform"])] += v
        for _lbl, v in metric_samples(text, "block_corrupted_count"):
            c[("corrupted",)] += v
        for _lbl, v in metric_samples(text, "tpu_mesh_engaged_total"):
            c[("mesh",)] += v
        return c

    def totals(self, index: int | None = None) -> Counter:
        """Counts of daemon `index` (its current process), or of all."""
        if index is not None:
            return self.counts(self.last.get(index, ""))
        out = Counter(self.retired)
        for text in self.last.values():
            out.update(self.counts(text))
        return out

    def retire(self, d: Daemon) -> None:
        self.retired.update(self.counts(self.last.pop(d.index, "")))

    @staticmethod
    def launches(totals: Counter) -> dict:
        return {k: int(totals[("launch", w)]) for k, w in WRAPPERS.items()}


class DaemonPart:
    """Wall time and the daemons' K1/K2/K3 launches (summed over every
    daemon, read from their `/metrics` before and after) of one part of
    phase 9, printed beside phase 8's wall for the same part."""

    def __init__(self, name: str, results: dict, fleet: Fleet, sess, phase8: dict):
        self.name, self.results, self.fleet, self.sess = name, results, fleet, sess
        self.phase8 = phase8

    async def __aenter__(self):
        await self.fleet.scrape(self.sess)
        self.before = Fleet.launches(self.fleet.totals())
        self.t0 = time.perf_counter()
        return self

    async def __aexit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        wall = time.perf_counter() - self.t0
        await self.fleet.scrape(self.sess)
        after = Fleet.launches(self.fleet.totals())
        row = {"wall_s": wall, **{f"{k}_launches": after[k] - self.before[k] for k in WRAPPERS}}
        self.results[self.name] = row
        p8 = (self.phase8.get(self.name) or {}).get("wall_s")
        print(f"daemons {self.name}: wall_s={wall:.6f} (phase 8: "
              f"{'-' if p8 is None else f'{p8:.6f}'}) K1={row['k1_launches']} "
              f"K2={row['k2_launches']} K3={row['k3_launches']}")
        return False


def daemon_pieces(d: Daemon, h: bytes) -> dict[int, bytes]:
    """The piece files of block `h` in daemon `d`'s data directory, by
    rank (`<data>/<h[:2]>/<h[2:4]>/<hash>.p<rank>`)."""
    hx = h.hex()
    folder = d.dir / "data" / hx[:2] / hx[2:4]
    return {int(p.name.rsplit(".p", 1)[1]): p.read_bytes()
            for p in folder.glob(f"{hx}.p*") if p.name.rsplit(".p", 1)[1].isdigit()}


def daemon_piece_files(d: Daemon) -> dict[str, bytes]:
    """Every piece file in daemon `d`'s data directory: relative path ->
    bytes."""
    data = d.dir / "data"
    return {str(p.relative_to(data)): p.read_bytes() for p in data.glob("*/*/*.p*")
            if p.name.rsplit(".p", 1)[1].isdigit()}


def repair_report(victim: Daemon, before: dict[str, bytes]) -> None:
    """What a failed repair left: the piece files missing or different on
    the restarted daemon, and its repair workers' status."""
    now = daemon_piece_files(victim)
    missing = [p for p in before if p not in now]
    differ = [p for p in before if p in now and now[p] != before[p]]
    print(f"repair report: {len(before)} piece files before, {len(now)} now, "
          f"{len(missing)} missing {missing[:3]}, {len(differ)} different", file=sys.stderr)
    for p in differ[:3]:
        print(f"  {p}: header before {before[p][:44].hex()} after {now[p][:44].hex()}, "
              f"payload equal {before[p][44:] == now[p][44:]}", file=sys.stderr)
    workers = json.loads(cli(victim.config, "--json", "worker", "list"))
    print(f"repair report: workers {json.dumps([w for w in workers if 'repair' in w['name']])}",
          file=sys.stderr)


def histogram_means(texts: list[str], family: str) -> dict:
    """Per label set of a duration histogram, summed over expositions:
    [count, mean seconds]."""
    sums, counts = Counter(), Counter()
    for text in texts:
        for lbl, v in metric_samples(text, family + "_sum"):
            sums[",".join(lbl.values())] += v
        for lbl, v in metric_samples(text, family + "_count"):
            counts[",".join(lbl.values())] += v
    return {k: [int(counts[k]), round(sums[k] / counts[k], 6)] for k in sorted(counts)
            if counts[k]}


def histogram_p99(text: str, family: str) -> float | None:
    """The upper bound of the bucket that holds the 99th percentile of a
    histogram (its label sets merged), from one exposition."""
    buckets = Counter()
    for lbl, v in metric_samples(text, family + "_bucket"):
        buckets[float(lbl["le"])] += v
    total = buckets[float("inf")]
    if not total:
        return None
    return next(le for le in sorted(buckets) if buckets[le] >= 0.99 * total)


async def admin_json(sess, d: Daemon, path: str):
    async with sess.get(d.url(d.admin_port) + path,
                        headers={"Authorization": f"Bearer {ADMIN_TOKEN}"}) as r:
        require(r.status == 200, f"daemon {d.index} {path}: {r.status}")
        return await r.json()


async def poll(what: str, cond, timeout: float, every: float = 0.5):
    """Await `cond()` until it returns a true value, which is returned;
    fails the phase after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        got = await cond()
        if got:
            return got
        require(time.monotonic() < deadline, f"{what}: not reached in {timeout} s")
        await asyncio.sleep(every)


async def drive_daemons(dev, root: Path, phase8: dict) -> dict:
    """Phase 9's main path: 11 daemons of this package, each a process of
    its own (`python -m garage_tpu_torch.cli server`) with its EcCodec on
    the card, configured by CLI processes and driven over HTTP with phase
    8's data and clients."""
    cpu = dev.type != "cuda"
    big, small = s3_objects(np.random.default_rng(SEED + 8))  # phase 8's, byte for byte
    krng = np.random.default_rng(SEED + 9)
    node_keys = [krng.bytes(32) for _ in range(N_NODES)]
    k2v_items = [(f"item-{i:04d}", krng.bytes(int(krng.integers(1, 2048))))
                 for i in range(N_K2V)]
    pages = {name: krng.bytes(n * BLOCK + 4321) for name, n in SITE_PAGES.items()}
    ports = free_ports(2 * N_NODES + 4)
    ids = [node_id_of(k).hex() for k in node_keys]
    addr = [f"{ids[i]}@127.0.0.1:{ports[2 * i]}" for i in range(N_NODES)]
    daemons = [Daemon(
        root, i, ports[2 * i], ports[2 * i + 1], mode=f"ec:{K}:{M}", block_size=BLOCK,
        cpu=cpu, node_key=node_keys[i], extra=DAEMON_EXTRA,
        peers=[a for j, a in enumerate(addr) if j != i],
        s3_port=ports[2 * N_NODES + i] if i in D_ENDPOINTS else None,
        k2v_port=ports[2 * N_NODES + 2] if i == 0 else None,
        web_port=ports[2 * N_NODES + 3] if i == 1 else None) for i in range(N_NODES)]
    fleet = Fleet(daemons)
    res: dict = {}
    statuses: Counter = Counter()
    closing: list = []
    CLI_WALLS.clear()
    t0 = time.perf_counter()
    try:
        for d in daemons:
            d.start()
        for d in daemons:
            await asyncio.to_thread(d.wait_up, DAEMON_UP_S)
        res["boot_s"] = time.perf_counter() - t0
        require([d.node_id for d in daemons] == ids, "a daemon's node id is not its seeded key's")
        if not cpu:
            free, total = torch.cuda.mem_get_info(dev)
            res["card_memory_gib"] = {"used": (total - free) / 2**30, "total": total / 2**30,
                                      "this_process": torch.cuda.memory_reserved(dev) / 2**30}
        print(f"daemons: {N_NODES} processes up in {res['boot_s']:.6f} s (to the last up line); "
              f"nproc={os.cpu_count()} affinity={len(os.sched_getaffinity(0))}; "
              f"card memory (GiB) {json.dumps(res.get('card_memory_gib'))}")

        async with aiohttp.ClientSession() as sess:
            async def meshed(d):  # every peer up and the layout applied, as `d` sees it
                st = await admin_json(sess, d, "/v1/status")
                return st["layoutVersion"] >= 1 and sum(n["isUp"] for n in st["nodes"]) == N_NODES

            t1 = time.perf_counter()
            key_id, secret = await asyncio.to_thread(configure, daemons, S3_BUCKET, True)
            for d in daemons:
                await poll(f"daemon {d.index} in the mesh", lambda d=d: meshed(d), 120)
            res["setup"] = {"wall_s": time.perf_counter() - t1}
            walls = [w for _c, w in CLI_WALLS]
            res["cli"] = {"calls": len(walls), "mean_s": sum(walls) / len(walls),
                          "max_s": max(walls)}
            print(f"daemons setup: wall_s={res['setup']['wall_s']:.6f}; CLI processes "
                  f"{json.dumps(res['cli'])}: " + ", ".join(f"{c} {w:.3f}" for c, w in CLI_WALLS))

            eps = [daemons[i].url(daemons[i].s3_port) for i in D_ENDPOINTS]
            clients = [CountingClient(eps[c % 2], key_id, secret, statuses)
                       for c in range(S3_CLIENTS)]
            other = [CountingClient(eps[(c + 1) % 2], key_id, secret, statuses)
                     for c in range(S3_CLIENTS)]
            k2v = [CountingK2V(daemons[0].url(daemons[0].k2v_port), S3_BUCKET, key_id, secret,
                               statuses) for _ in range(S3_CLIENTS)]
            closing += clients + other + k2v
            big_keys = [f"big/{i:03d}" for i in range(N_BIG)]
            small_keys = [f"small/{i:04d}" for i in range(N_SMALL)]
            etags: dict[str, str] = {}

            def part(name):
                return DaemonPart(name, res, fleet, sess, phase8)

            async def put_share(c: int, items):
                for k, body in items[c::S3_CLIENTS]:
                    etags[k] = await clients[c].put_object(S3_BUCKET, k, body)

            async with part("put"):
                await asyncio.gather(*[put_share(c, list(zip(big_keys, big)))
                                       for c in range(S3_CLIENTS)])
            async with part("put_small"):
                await asyncio.gather(*[put_share(c, list(zip(small_keys, small)))
                                       for c in range(S3_CLIENTS)])
            bad = [k for k, b in zip(big_keys + small_keys, big + small)
                   if etags[k] != hashlib.md5(b).hexdigest()]
            require(not bad, f"PUT: ETags of {bad[:4]} are not the MD5 of the body")
            require(cpu or res["put"]["k3_launches"] > 0, "the daemons' PUTs never launched K3")
            require(res["put_small"]["k3_launches"] == 0, "the inline PUTs reached the codec")

            async def get_share(c: int, ks, via):
                return [(k, await via[c].get_object(S3_BUCKET, k)) for k in ks[c::S3_CLIENTS]]

            async with part("get"):
                got = await asyncio.gather(*[get_share(c, big_keys, other)
                                             for c in range(S3_CLIENTS)])
                lo = BLOCK - 100
                ranged = await other[1].get_object(S3_BUCKET, big_keys[0],
                                                   range_=f"bytes={lo}-{BLOCK + 99}")
            body_of = dict(zip(big_keys, big))
            bad = [k for kb in got for k, b in kb if b != body_of[k]]
            require(not bad, f"GET: {bad[:4]} differ from what was PUT")
            require(ranged == big[0][lo:BLOCK + 100], "ranged GET across a block boundary differs")
            async with part("get_small"):
                got = await asyncio.gather(*[get_share(c, small_keys, other)
                                             for c in range(S3_CLIENTS)])
            body_of = dict(zip(small_keys, small))
            require(all(b == body_of[k] for kb in got for k, b in kb), "GET: inline objects differ")

            async with part("k2v"):
                await asyncio.gather(*[k2v[c].insert_batch(
                    [(K2V_PK, sk, v, None) for sk, v in k2v_items[c::S3_CLIENTS]])
                    for c in range(S3_CLIENTS)])
                batch = await k2v[0].read_batch([{"partitionKey": K2V_PK}])
                sk0 = k2v_items[0][0]
                _vals, tok = await k2v[1].read_item(K2V_PK, sk0)
                poller = asyncio.create_task(k2v[2].poll_item(K2V_PK, sk0, tok, timeout=30))
                await asyncio.sleep(0.2)
                await k2v[3].insert_item(K2V_PK, sk0, b"polled", token=tok)
                polled = await poller
            items = batch[0]["items"]
            require([(i["sk"], [base64.b64decode(v) for v in i["v"]]) for i in items]
                    == [(sk, [v]) for sk, v in k2v_items],
                    f"K2V ReadBatch: {len(items)} items, not the {N_K2V} inserted")
            require(polled is not None and polled[0] == [b"polled"], f"K2V poll: {polled}")
            print(f"daemons k2v: {N_K2V} items inserted by {S3_CLIENTS} clients, read back as "
                  f"one batch; one poll answered by a write")

            for name, body in pages.items():
                await clients[0].put_object(S3_BUCKET, name, body, "text/html")
            site = daemons[1].url(daemons[1].web_port)

            async def web_get(path):
                async with sess.get(site + path, headers={"Host": f"{S3_BUCKET}.{WEB_ROOT}"}) as r:
                    statuses[f"web {r.status}"] += 1
                    return r.status, await r.read()

            async with part("website"):
                page = await web_get("/")
            require(page == (200, pages["index.html"]), f"website GET: status {page[0]}")

            # one daemon stopped, chosen by rank: the lowest data rank that
            # serves no endpoint (every block has the same rank order)
            hashes = [blake2sum(b[j * BLOCK:(j + 1) * BLOCK]) for b in big
                      for j in range(BIG_BLOCKS)]
            holder = {r: d.index for d in daemons for r in daemon_pieces(d, hashes[0])}
            require(sorted(holder) == list(range(K + M)), f"block 0's ranks on disk: {holder}")
            for h in hashes[:64]:
                require({r: d.index for d in daemons for r in daemon_pieces(d, h)} == holder,
                        "the blocks do not share one rank order")
            victim_rank = next(r for r in range(K) if holder[r] not in D_ENDPOINTS)
            victim = daemons[holder[victim_rank]]
            await fleet.scrape(sess)
            fleet.retire(victim)
            code = await asyncio.to_thread(victim.stop, DAEMON_STOP_S)
            require(code == 0, f"daemon {victim.index} exited {code} on SIGTERM")
            print(f"daemons: daemon {victim.index} (rank {victim_rank}) stopped by SIGTERM, "
                  f"exit code {code}")
            async with part("degraded_get"):
                got = await asyncio.gather(*[get_share(c, big_keys, clients)
                                             for c in range(S3_CLIENTS)])
            body_of = dict(zip(big_keys, big))
            bad = [k for kb in got for k, b in kb if b != body_of[k]]
            require(not bad, f"degraded GET: {bad[:4]} differ from what was PUT")
            require(cpu or res["degraded_get"]["k1_launches"] > 0,
                    "the daemons' degraded GETs never launched K1")
            async with part("website_degraded"):
                page = await web_get("/")
                about = await web_get("/about.html")  # never read before: no cached block
            require(page == (200, pages["index.html"]) and about == (200, pages["about.html"]),
                    f"degraded website GETs: statuses {page[0]}, {about[0]}")
            require(cpu or res["website_degraded"]["k1_launches"] > 0,
                    "the degraded website GET never launched K1")

            # repair: the stopped daemon comes back with its data dir wiped.
            # Its pieces of the blocks written here are checked; it may also
            # hold pieces of deleted blocks (the canary's probe objects)
            # waiting for the block GC, which no repair rebuilds
            ours = {h.hex() for h in hashes} | {
                blake2sum(b[i:i + BLOCK]).hex() for b in pages.values()
                for i in range(0, len(b), BLOCK)}
            before = {p: b for p, b in daemon_piece_files(victim).items()
                      if Path(p).name.split(".")[0] in ours}
            shutil.rmtree(victim.dir / "data")
            victim.start()
            await asyncio.to_thread(victim.wait_up, DAEMON_UP_S)
            await asyncio.to_thread(cli, daemons[0].config, "node", "connect", addr[victim.index])
            for d in daemons:
                await poll(f"daemon {d.index} sees the restarted daemon",
                           lambda d=d: meshed(d), 120)

            async def rebuilt():
                now = await asyncio.to_thread(daemon_piece_files, victim)
                return all(now.get(p) == b for p, b in before.items())

            async with part("repair"):
                await asyncio.to_thread(cli, victim.config, "repair", "blocks")
                try:
                    await poll("repair: the wiped daemon's pieces", rebuilt, REPAIR_S)
                except SmokeFailure:
                    await asyncio.to_thread(repair_report, victim, before)
                    raise
            require(len(before) == N_BIG * BIG_BLOCKS + sum(
                -(-len(b) // BLOCK) for b in pages.values()),
                f"repair: the stopped daemon held {len(before)} pieces of this phase's blocks")
            require(cpu or res["repair"]["k1_launches"] > 0, "the repair never launched K1")
            print(f"daemons repair: daemon {victim.index} restarted with its data dir wiped; "
                  f"{len(before)} piece files rebuilt byte-identical through `repair blocks`")

            async def no_missing():
                r = await admin_json(sess, daemons[0], "/v1/cluster/durability")
                agg = r["cluster"]["aggregate"]
                done = (r["cluster"]["nodesReporting"] == N_NODES and agg["blocksTotal"]
                        and agg["missingPieces"] == 0 and agg["healthyFraction"] == 1.0)
                return agg if done else None

            t1 = time.perf_counter()
            agg = await poll("cluster durability: no missing pieces", no_missing, 180, 1.0)
            res["durability_converged"] = {"wall_s": time.perf_counter() - t1}
            out = await asyncio.to_thread(cli, daemons[0].config, "cluster", "durability")
            require("100.0% healthy" in out and " 0 pieces" in out, f"cluster durability: {out}")
            conv = res["durability_converged"]["wall_s"]
            print(f"daemons durability: no missing pieces {conv:.6f} s after the repair "
                  f"(digests gossip every 10 s): {json.dumps(agg)}; "
                  f"`cluster durability`: " + " | ".join(out.splitlines()[:5]))

            sample = [big[i][j * BLOCK:(j + 1) * BLOCK] for i, j in zip(
                range(0, N_BIG, N_BIG // N_SAMPLED), [n % BIG_BLOCKS for n in range(N_SAMPLED)])]

            def pieces_of(block):
                h = blake2sum(block)
                return pieces_in_rank_order(
                    h, {r: b for d in daemons for r, b in daemon_pieces(d, h).items()})

            checked = check_pieces(dev, pieces_of, sample)
            print(f"daemons pieces: {len(sample)} sampled blocks, {checked} piece files from the "
                  f"daemons' data dirs against the plain versions on {dev}")

            # scrub: one flipped byte in each of 3 piece files of one daemon
            scrubbed = next(d for d in reversed(daemons) if d is not victim)
            rank = next(r for r, i in holder.items() if i == scrubbed.index)
            flipped = [scrubbed.dir / "data" / h.hex()[:2] / h.hex()[2:4] / f"{h.hex()}.p{rank}"
                       for h in hashes[:SCRUB_FLIPS]]
            for p in flipped:
                raw = bytearray(p.read_bytes())
                raw[44 + 777] ^= 0xFF
                p.write_bytes(bytes(raw))

            async def corruptions():
                await fleet.scrape(sess)
                return fleet.totals(scrubbed.index)[("corrupted",)] >= SCRUB_FLIPS

            k2_of = lambda: fleet.totals(scrubbed.index)[("launch", WRAPPERS["k2"])]  # noqa: E731
            async with part("scrub"):
                k2_before = k2_of()
                await asyncio.to_thread(cli, scrubbed.config, "repair", "scrub",
                                        "set-tranquility", "0")
                await asyncio.to_thread(cli, scrubbed.config, "repair", "scrub", "start")
                await poll("scrub: the flipped bytes", corruptions, 180)
            workers = json.loads(await asyncio.to_thread(cli, scrubbed.config, "--json",
                                                         "worker", "list"))
            found = [w["info"]["corruptions"] for w in workers if w["name"] == "scrub"]
            require(found == [SCRUB_FLIPS]
                    and fleet.totals(scrubbed.index)[("corrupted",)] == SCRUB_FLIPS,
                    f"scrub: corruptions {found}, want [{SCRUB_FLIPS}]")
            res["scrub"]["k2_launches_scrubbed"] = int(k2_of() - k2_before)
            require(cpu or res["scrub"]["k2_launches_scrubbed"] > 0,
                    "the scrubbed daemon never launched K2")
            print(f"daemons scrub: daemon {scrubbed.index}, {SCRUB_FLIPS} flipped bytes, "
                  f"{found[0]} corruptions found, {res['scrub']['k2_launches_scrubbed']} K2 "
                  f"launches in that daemon")

            await fleet.scrape(sess)
            totals = fleet.totals()
            platforms = {k[2] for k, v in totals.items() if k[0] == "dispatch" and v}
            want = "host" if cpu else "cuda"  # a CPU node codes with the native host codec
            require(platforms == {want},
                    f"the daemons' codec dispatches ran on {sorted(platforms)}, not {want} only")
            res["launches"] = Fleet.launches(totals)
            res["mesh_engaged"] = int(totals[("mesh",)])  # K6's dispatches
            res["dispatches"] = {f"{k[1]}/{k[2]}": int(v) for k, v in sorted(totals.items())
                                 if k[0] == "dispatch" and v}
            texts = list(fleet.last.values())
            res["layers"] = {f: histogram_means(texts, f) for f in
                             ("api_s3_request_duration", "table_put_request_duration")}
            res["loop_lag_p99_s"] = {i: histogram_p99(t, "event_loop_lag_seconds")
                                     for i, t in sorted(fleet.last.items())}
            res["ladder_level"] = {
                i: max((v for _l, v in metric_samples(t, "overload_ladder_level")), default=None)
                for i, t in sorted(fleet.last.items())}
            mib = 1 << 20
            put_bytes = N_BIG * BIG_BLOCKS * BLOCK
            res["rates_mib_s"] = {
                "put": put_bytes / mib / res["put"]["wall_s"],
                "put_small_objects_per_s": N_SMALL / res["put_small"]["wall_s"],
                "get": put_bytes / mib / res["get"]["wall_s"],
                "degraded_get": put_bytes / mib / res["degraded_get"]["wall_s"],
            }
            p8 = phase8.get("rates_mib_s", {})
            print("daemons rates (phase 8 beside): " + ", ".join(
                f"{k} {v:.6f} ({p8.get(k, float('nan')):.6f})"
                for k, v in res["rates_mib_s"].items()))
            print(f"daemons launches (summed over every daemon process): "
                  f"{json.dumps(res['launches'])}; dispatches {json.dumps(res['dispatches'])}")
            print(f"daemons layer latencies ([count, mean_s], summed over the daemons): "
                  f"{json.dumps(res['layers'])}")
            print(f"daemons loop lag p99 (s, a bucket bound): {json.dumps(res['loop_lag_p99_s'])};"
                  f" shedding ladder level: {json.dumps(res['ladder_level'])}")
        codes = {str(k): n for k, n in sorted(statuses.items(), key=str)}
        print(f"daemons statuses: {json.dumps(codes)}")
        require(all(200 <= int(str(k).split()[-1]) < 300 for k in statuses),
                f"response statuses {codes}: want 2xx only")
        res["statuses"] = codes
        t1 = time.perf_counter()
        codes = await asyncio.to_thread(stop_daemons, daemons, DAEMON_STOP_S)
        res["stop_s"] = time.perf_counter() - t1
        print(f"daemons stop: exit codes {codes} after SIGTERM, {res['stop_s']:.6f} s")
        require(codes == [0] * N_NODES, f"daemons' exit codes after SIGTERM: {codes}")
        res["fleet"] = {"daemons": daemons, "key": (key_id, secret)}
    except BaseException:
        for d in daemons:  # what each daemon said last, for the failure's reader
            print(f"--- daemon {d.index} log tail:\n{d.tail(15)}", file=sys.stderr)
            if LOG_DIR and d.log.exists():
                Path(LOG_DIR).mkdir(parents=True, exist_ok=True)
                shutil.copy(d.log, Path(LOG_DIR) / f"daemon{d.index}.log")
        raise
    finally:
        for c in closing:
            await c.close()
        kill_all(daemons)
    return res


def run_daemons(dev, root: Path, phase8: dict) -> dict:
    return asyncio.run(asyncio.wait_for(drive_daemons(dev, root, phase8), DAEMONS_TIMEOUT_S))


# --- phase 10: the metadata engines -------------------------------------------------

ENGINE_OF = ("sqlite", "native", "log")  # daemon i: ENGINE_OF[i % 3] (S3 daemon 0 sqlite, 1 native)
N_NEW = 16  # new 4 MiB objects PUT on the new engines
META_REPLICAS = 3  # copies of each metadata row at EC(8,3)
ENGINES_TIMEOUT_S = 600  # a stuck part fails the phase instead of the call
FIGURE_ROWS, FIGURE_VALUE = 20_000, 100  # the per-engine figure: rows, value bytes
FIGURE_TX = (1, 64)  # rows per transaction
BINDING_LINE = re.compile(r"native metadata engine: \S+ through the (\w+) binding")


def meta_db(d: Daemon) -> str:
    return str(d.dir / "meta" / "db")  # what `Garage` opens: <metadata_dir>/db


def db_rows(path: str, engine: str) -> dict[str, list]:
    """Every row of every non-empty tree of a closed db."""
    db = open_db(path, engine=engine)
    try:
        trees = {name: list(db.open_tree(name).iter_range()) for name in db.list_trees()}
        return {name: rows for name, rows in sorted(trees.items()) if rows}
    finally:
        db.close()


def new_object_rows(d: Daemon, engine: str, keys: list[str]) -> set[str]:
    """The keys among `keys` whose object row, with a complete version,
    daemon `d`'s closed db holds."""
    db = open_db(meta_db(d), engine=engine)
    try:
        schema, want, found = ObjectTable(), {k.encode(): k for k in keys}, set()
        for k, v in db.open_tree(ObjectTable.table_name).iter_range():
            if k[32:] in want and schema.decode_entry(unpack(v)).last_visible() is not None:
                found.add(want[k[32:]])
        return found
    finally:
        db.close()


def engine_figures(root: Path) -> dict:
    """On this host, through the `Db` interface, with fsync on: inserts
    per second of FIGURE_ROWS rows in transactions of 1 and of 64, and
    the seconds of one full range scan, for each durable engine."""
    out = {}
    keys = [b"row%08d" % i for i in range(FIGURE_ROWS)]
    value = b"v" * FIGURE_VALUE
    for engine in ("sqlite", "log", "native"):
        fig = {}
        for tx in FIGURE_TX:
            db = open_db(str(root / f"figure-{engine}-{tx}"), engine=engine, fsync=True)
            try:
                tree = db.open_tree("figure")
                t0 = time.perf_counter()
                for i in range(0, FIGURE_ROWS, tx):
                    db.transaction(lambda t, ks=keys[i:i + tx]: [t.insert(tree, k, value) for k in ks]
                                   and None)
                fig[f"tx{tx}_inserts_per_s"] = FIGURE_ROWS / (time.perf_counter() - t0)
                t0 = time.perf_counter()
                n = sum(1 for _ in tree.iter_range())
                fig[f"tx{tx}_scan_s"] = time.perf_counter() - t0
                require(n == FIGURE_ROWS, f"figure {engine}: the scan read {n} rows")
            finally:
                db.close()
        out[engine] = fig
    return out


async def drive_engines(dev, fleet: dict) -> dict:
    """Phase 10's main path: phase 9's stopped daemons, their sqlite
    metadata converted by `convert-db` to the log and native engines,
    booted again on the card and driven over HTTP."""
    cpu = dev.type != "cuda"
    daemons: list[Daemon] = fleet["daemons"]
    key_id, secret = fleet["key"]
    engine = {d.index: ENGINE_OF[d.index % len(ENGINE_OF)] for d in daemons}
    moved = [d for d in daemons if engine[d.index] != "sqlite"]
    big, small = s3_objects(np.random.default_rng(SEED + 8))  # phases 8 and 9's objects
    new = [np.random.default_rng(SEED + 10).integers(0, 256, BIG_BLOCKS * BLOCK, dtype=np.uint8)
           .tobytes() for _ in range(N_NEW)]
    big_keys = [f"big/{i:03d}" for i in range(N_BIG)]
    small_keys = [f"small/{i:04d}" for i in range(N_SMALL)]
    new_keys = [f"engines/{i:03d}" for i in range(N_NEW)]
    fleet_metrics = Fleet(daemons)
    res: dict = {"engines": {str(i): e for i, e in engine.items()}}
    statuses: Counter = Counter()
    closing: list = []

    def wall(name, t0):
        res[name] = {"wall_s": time.perf_counter() - t0}
        print(f"engines {name}: wall_s={res[name]['wall_s']:.6f}")

    try:
        t0 = time.perf_counter()
        before = {d.index: await asyncio.to_thread(db_rows, meta_db(d), "sqlite") for d in moved}
        await asyncio.to_thread(cli_many, [
            (d.config, "convert-db", "--input", meta_db(d), "--input-engine", "sqlite",
             "--output", meta_db(d), "--output-engine", engine[d.index]) for d in moved])
        for d in moved:
            after = await asyncio.to_thread(db_rows, meta_db(d), engine[d.index])
            require(after == before[d.index],
                    f"convert-db: daemon {d.index}'s {engine[d.index]} rows differ from its sqlite "
                    f"rows (trees {sorted(after)} vs {sorted(before[d.index])})")
        wall("convert", t0)
        rows = {d.index: sum(len(r) for r in before[d.index].values()) for d in moved}
        print(f"engines convert: {len(moved)} daemons' sqlite metadata by `convert-db` processes "
              f"run side by side, rows identical after: "
              + ", ".join(f"daemon {i} -> {engine[i]} {n} rows" for i, n in rows.items()))

        t0 = time.perf_counter()
        for d in daemons:
            d.engine = engine[d.index]
            d.start()
        for d in daemons:
            await asyncio.to_thread(d.wait_up, DAEMON_UP_S)
        async with aiohttp.ClientSession() as sess:
            async def meshed(d):
                st = await admin_json(sess, d, "/v1/status")
                return (st["layoutVersion"] >= 1
                        and sum(n["isUp"] for n in st["nodes"]) == N_NODES)

            for d in daemons:
                await poll(f"daemon {d.index} in the mesh on its new engine",
                           lambda d=d: meshed(d), 120)
            wall("boot", t0)
            bindings = set()
            for d in daemons:
                if engine[d.index] == "native":
                    with open(d.log, "rb") as f:
                        f.seek(d._log_from)
                        bindings.update(BINDING_LINE.findall(f.read().decode(errors="replace")))
            require(len(bindings) == 1, f"native daemons' bindings: {sorted(bindings)}")
            res["native_binding"] = bindings.pop()
            print(f"engines boot: {N_NODES} daemons up on sqlite, log and native "
                  f"({json.dumps(res['engines'])}); the native engine's binding in the daemons: "
                  f"{res['native_binding']}, in this process: {_native.kv_binding()}")

            eps = [daemons[i].url(daemons[i].s3_port) for i in D_ENDPOINTS]
            clients = {e: [CountingClient(ep, key_id, secret, statuses) for _ in range(S3_CLIENTS)]
                       for e, ep in zip(D_ENDPOINTS, eps)}
            closing += [c for cs in clients.values() for c in cs]

            async def get_share(cs, c, ks):
                return [(k, await cs[c].get_object(S3_BUCKET, k)) for k in ks[c::S3_CLIENTS]]

            async def get_all(keys, bodies):
                bad = []
                for e, cs in clients.items():
                    got = await asyncio.gather(*[get_share(cs, c, keys)
                                                 for c in range(S3_CLIENTS)])
                    body_of = dict(zip(keys, bodies))
                    bad += [(e, k) for kb in got for k, b in kb if b != body_of[k]]
                return bad

            t0 = time.perf_counter()
            bad = await get_all(big_keys + small_keys, big + small)
            wall("read", t0)
            require(not bad, f"GET on the new engines: {bad[:4]} differ from phase 9's PUTs")
            print(f"engines read: {N_BIG} objects of 4 MiB and {N_SMALL} of 1 KiB from phase 9, "
                  f"byte-identical through both S3 endpoints (daemons {list(D_ENDPOINTS)}: "
                  f"{engine[D_ENDPOINTS[0]]}, {engine[D_ENDPOINTS[1]]})")

            await fleet_metrics.scrape(sess)
            k3_before = Fleet.launches(fleet_metrics.totals())["k3"]
            etags: dict[str, str] = {}
            writers = clients[D_ENDPOINTS[0]]

            async def put_share(c):
                for k, body in list(zip(new_keys, new))[c::S3_CLIENTS]:
                    etags[k] = await writers[c].put_object(S3_BUCKET, k, body)

            t0 = time.perf_counter()
            await asyncio.gather(*[put_share(c) for c in range(S3_CLIENTS)])
            wall("write", t0)
            await fleet_metrics.scrape(sess)
            res["write"]["k3_launches"] = Fleet.launches(fleet_metrics.totals())["k3"] - k3_before
            require(all(etags[k] == hashlib.md5(b).hexdigest() for k, b in zip(new_keys, new)),
                    "PUT on the new engines: an ETag is not the MD5 of its body")
            require(cpu or res["write"]["k3_launches"] > 0, "the new PUTs never launched K3")
            t0 = time.perf_counter()
            bad = await get_all(new_keys, new)
            wall("read_new", t0)
            require(not bad, f"the new objects read back differ: {bad[:4]}")
            print(f"engines write: {N_NEW} objects of 4 MiB PUT and read back through both "
                  f"endpoints; K3 launches {res['write']['k3_launches']}")

        t0 = time.perf_counter()
        codes = await asyncio.to_thread(stop_daemons, daemons, DAEMON_STOP_S)
        wall("stop", t0)
        require(codes == [0] * N_NODES, f"daemons' exit codes after SIGTERM: {codes}")
        t0 = time.perf_counter()
        holders: dict[str, list[int]] = {k: [] for k in new_keys}
        for d in daemons:
            for k in await asyncio.to_thread(new_object_rows, d, engine[d.index], new_keys):
                holders[k].append(d.index)
        wall("reopen", t0)
        counts = Counter(len(v) for v in holders.values())
        on = {e: sorted({i for v in holders.values() for i in v if engine[i] == e})
              for e in ("log", "native")}
        require(all(len(v) == META_REPLICAS for v in holders.values()),
                f"after SIGTERM: a new object's row is not on its {META_REPLICAS} replicas: {holders}")
        require(on["log"] and on["native"],
                f"after SIGTERM: no log or no native db holds a new object's row: {on}")
        res["new_rows_replicas"] = {str(n): c for n, c in sorted(counts.items())}
        print(f"engines restart: exit codes {codes} after SIGTERM; reopened in this process, "
              f"every new object's row is on its replicas (replicas per row: "
              f"{json.dumps(res['new_rows_replicas'])}), log dbs of daemons {on['log']} and "
              f"native dbs of daemons {on['native']} among them")
    except BaseException:
        for d in daemons:
            print(f"--- daemon {d.index} log tail:\n{d.tail(15)}", file=sys.stderr)
        raise
    finally:
        for c in closing:
            await c.close()
        kill_all(daemons)
    codes = {str(k): n for k, n in sorted(statuses.items(), key=str)}
    require(all(200 <= int(k) < 300 for k in statuses), f"response statuses {codes}: want 2xx")
    res["statuses"] = codes
    return res


def run_engines(dev, root: Path, fleet: dict) -> dict:
    res = asyncio.run(asyncio.wait_for(drive_engines(dev, fleet), ENGINES_TIMEOUT_S))
    t0 = time.perf_counter()
    res["figures"] = engine_figures(root)
    res["figures_wall_s"] = time.perf_counter() - t0
    return res


# --- phase 11: the host codec -----------------------------------------------------

HOST_REPS = 3  # timed passes over the codec's blocks per backend
HOST_CODEC_BLOCKS = 16
HOST_LOST = (0, 3, 9)  # two data ranks and one parity: a real decode


def host_ms(fn, blocks: int) -> float:
    """Wall milliseconds per block of `fn()` over HOST_REPS calls, after
    one warm-up call (each call ends with its device->host copy)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        fn()
    return (time.perf_counter() - t0) * 1e3 / (HOST_REPS * blocks)


def run_host_codec(dev, gen, card: str, k3_ms: float) -> dict:
    """Phase 11: the native host codec (`_native/gf8.cpp`, what a CPU
    codec or `[block] batch_impl = "host"` runs) held byte for byte
    against K1 on the card and against its plain version: EC(8,3) encode
    of 64 blocks of 1 MiB, one 2-D call a block; EC(16,4) encode; a
    reconstruct with 3 erasures.  Then `EcCodec(8, 3)` on the card with
    impl="host" and impl="auto" on 16 blocks of 1 MiB: the same pieces,
    piece hashes and decodes, the host calls launching no kernel and the
    "auto" ones launching K3 and K1.  The host codec's ms per block
    beside the card's."""
    t0 = time.perf_counter()
    keep3 = [i for i in range(K + M) if i not in (0, 3, 6)]
    cases = (  # (name, B, S, GF(2^8) matrix)
        ("ec83_encode", 64, BLOCK // K, gf.cauchy_parity_matrix(K, M)),
        ("ec164_encode", 16, BLOCK // 16, gf.cauchy_parity_matrix(16, 4)),
        ("ec83_lose3", 16, BLOCK // K, gf.reconstruction_matrix(K, M, keep3, [0, 3, 6])),
    )
    out = {"mismatches": 0}
    for name, b, s, mat in cases:
        q = mat.shape[1]
        x = rand_u8((b, q, s), gen, dev)
        bm = torch.from_numpy(gf.bitmatrix_of(mat)).to(dev)
        on_card = gf_bitmatmul_cuda(bm, x).cpu().numpy()
        plain = gf_bitmatmul(bm, x).cpu().numpy()
        xs = x.cpu().numpy()
        t = time.perf_counter()
        host = np.stack([_native.gf8_apply(mat, xs[i]) for i in range(b)])
        ms = (time.perf_counter() - t) * 1e3 / b
        mism = int((host != on_card).sum()) + int((host != plain).sum())
        out["mismatches"] += mism
        out[name] = {"gf8_apply_ms_per_block": ms}
        print(f"host codec {name}: B={b} q={q} r={mat.shape[0]} S={s} gf8_apply vs K1 and "
              f"gf_bitmatmul: mismatches={mism}; gf8_apply_ms_per_block={ms:.6f} on {card}")
        require(mism == 0, f"host codec {name}: {mism} bytes differ from K1 or its plain version")

    rng = np.random.default_rng(SEED + 11)
    blocks = [rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
              for _ in range(HOST_CODEC_BLOCKS)]
    codec = EcCodec(K, M, device=dev)
    wrappers = (gf_bitmatmul_cuda, blake3_batch, encode_hash_tensor)
    launched = [w.launches for w in wrappers]
    host = codec.encode_batch_hashed(blocks, "host")
    items = [({i: p for i, p in enumerate(pieces) if i not in HOST_LOST}, BLOCK)
             for pieces, _h in host]
    host_plain = codec.decode_batch(items, "host")
    require([w.launches for w in wrappers] == launched,
            "host codec: impl=\"host\" launched a kernel")
    auto = codec.encode_batch_hashed(blocks, "auto")
    auto_plain = codec.decode_batch(items, "auto")
    require(encode_hash_tensor.launches > launched[2] and gf_bitmatmul_cuda.launches > launched[0],
            "host codec: impl=\"auto\" on the card launched no K3 or no K1")
    same = sum(h == a for h, a in zip(host, auto))
    require(all(h is not None for _p, h in host), "host codec: a block without piece hashes")
    require(same == HOST_CODEC_BLOCKS,
            f"host codec: {HOST_CODEC_BLOCKS - same} blocks' pieces or hashes differ from the card's")
    require(host_plain == auto_plain == blocks, "host codec: a degraded decode differs")
    figures = {
        "encode_batch_hashed_ms_per_block": {
            "host": host_ms(lambda: codec.encode_batch_hashed(blocks, "host"), len(blocks)),
            "card": host_ms(lambda: codec.encode_batch_hashed(blocks, "auto"), len(blocks)),
            "k3_kernel": k3_ms / 64,
        },
        "decode_batch_ms_per_block": {
            "host": host_ms(lambda: codec.decode_batch(items, "host"), len(items)),
            "card": host_ms(lambda: codec.decode_batch(items, "auto"), len(items)),
        },
    }
    out.update(figures)
    out["wall_s"] = time.perf_counter() - t0
    print(f"host codec: EcCodec({K},{M}) on {dev}, {HOST_CODEC_BLOCKS} blocks x {BLOCK} B, "
          f"impl=host equals impl=auto (pieces, hashes, decodes losing {list(HOST_LOST)}); "
          f"{json.dumps(figures)}; phase wall_s={out['wall_s']:.6f} on {card}")
    return out


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
    stack_frames = {}
    for src, log in _build.build_logs.items():
        kernel = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or "stack frame" in line:
                print(f"ptxas {src} {kernel}: {line.strip()}")
                if src == "blake3" and "stack frame" in line:
                    stack_frames[kernel] = int(line.split("bytes stack frame")[0].split()[-1])
    print(f"ptxas K2 stack frames (bytes): {json.dumps(stack_frames)}")
    t0 = time.perf_counter()
    lib = _native.build()
    print(f"build: host library (GF(2^8) codec, BLAKE3, kvlog) {lib.name} "
          f"wall_s={time.perf_counter() - t0:.3f}")
    ops = sass_int_ops(_build._target("blake3"), "blake3_small_kernel")
    print(f"sass blake3_small_kernel (one compression in its loop): "
          f"{ops if ops is None else json.dumps(ops)} "
          f"counted: alu_only={BLAKE3_ALU_ONLY_OPS} adds={BLAKE3_ADD_OPS}")
    ops = sass_int_ops(_build._target("blake3"), "blake3_warp_kernel")
    if ops is not None:
        per = per_compression(ops)
        print(f"sass blake3_warp_kernel (whole kernel): {json.dumps(ops)}; per compression "
              f"({per['bodies']} bodies): "
              f"{json.dumps({k: round(v, 2) for k, v in per.items() if k != 'bodies'})}")
    for width in (4, 8):
        ops = sass_int_ops(_build._target("gf_bitplane"), f"gf_bitplane_kernelILi{width}E")
        print(f"sass gf_bitplane_kernel<{width}> (whole kernel): "
              f"{ops if ops is None else json.dumps(ops)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k1 = check_k1(dev, gen)
    k2 = check_k2(dev, gen, sm_count, clock_mhz * 1e6)
    composites = time_composites(dev, gen, sm_count, clock_mhz * 1e6)

    gf_bitmatmul_cuda.launches = 0
    blake3_batch.launches = 0
    slice_res = run_slice(dev, gen)
    launches = {"gf": gf_bitmatmul_cuda.launches, "blake3": blake3_batch.launches}
    require(launches["gf"] > 0, "the slice never launched K1")
    require(launches["blake3"] > 0, "the slice never launched K2")

    if count >= MESH_N:
        mesh, layout = make_mesh(MESH_N), f"{MESH_N} cards"
    else:
        mesh, layout = make_mesh(devices=[dev] * MESH_N), f"{MESH_N} entries on {dev}, one stream each"
    print(f"mesh phase: {mesh} ({layout})")
    mesh_run = drive_mesh(dev, mesh)
    fanout = time_mesh(dev, mesh, mesh_run)

    SCRATCH.mkdir(exist_ok=True)
    gf_bitmatmul_cuda.launches = 0
    blake3_batch.launches = 0
    store = run_block_store(dev)
    store_launches = {"gf": gf_bitmatmul_cuda.launches, "blake3": blake3_batch.launches}
    require(store_launches["gf"] > 0, "the block store never launched K1")
    require(store_launches["blake3"] > 0, "the block store never launched K2")
    print(f"block store: {N_NODES} nodes EC({K},{M}), {N_BLOCKS} blocks x {BLOCK} B, "
          f"launches K1 {store_launches['gf']} K2 {store_launches['blake3']}; "
          f"wall_s {json.dumps({k: round(v['wall_s'], 6) for k, v in store.items()})} "
          f"on {card}")

    gf_bitmatmul_cuda.launches = 0
    blake3_batch.launches = 0
    encode_hash_tensor.launches = 0
    mesh0 = registry.counter_family_sum("tpu_mesh_engaged_total")  # K6's dispatches
    s3 = run_s3(dev)
    s3_launches = {"gf": gf_bitmatmul_cuda.launches, "blake3": blake3_batch.launches,
                   "k3": encode_hash_tensor.launches, "k6": int(registry.counter_family_sum("tpu_mesh_engaged_total") - mesh0)}
    require(s3_launches["k3"] > 0, "the S3 cluster never launched K3")
    require(s3_launches["gf"] > 0, "the S3 cluster never launched K1")
    require(s3_launches["blake3"] > 0, "the S3 cluster never launched K2")
    parts = {k: v for k, v in s3.items() if "wall_s" in v}
    print(f"s3: {N_NODES} nodes EC({K},{M}), launches K1 {s3_launches['gf']} "
          f"K2 {s3_launches['blake3']} K3 {s3_launches['k3']}; wall_s "
          f"{json.dumps({k: round(v['wall_s'], 6) for k, v in parts.items()})}; kernel_s "
          f"{json.dumps({k: round(v['kernel_s'], 6) for k, v in parts.items()})} on {card}")

    root = Path(tempfile.mkdtemp(prefix="daemons-", dir=SCRATCH))
    try:
        daemons = run_daemons(dev, root, s3)
        d_launches = daemons["launches"]
        for k, what in (("k3", "K3"), ("k1", "K1"), ("k2", "K2")):
            require(d_launches[k] > 0, f"the daemons never launched {what}")
        walls = {k: round(v["wall_s"], 6) for k, v in daemons.items()
                 if isinstance(v, dict) and "wall_s" in v}
        print(f"daemons: {N_NODES} processes EC({K},{M}), launches K1 {d_launches['k1']} "
              f"K2 {d_launches['k2']} K3 {d_launches['k3']}; wall_s {json.dumps(walls)} on {card}")

        t0 = time.perf_counter()
        engines = run_engines(dev, root, daemons["fleet"])
        walls = {k: v["wall_s"] for k, v in engines.items() if isinstance(v, dict) and "wall_s" in v}
        print(f"engines: phase wall_s={time.perf_counter() - t0:.6f} (figures "
              f"{engines['figures_wall_s']:.6f}); parts wall_s {json.dumps(walls)}; native binding "
              f"{engines['native_binding']}; statuses {json.dumps(engines['statuses'])} on {card}")
        print(f"engines figure (this host, through the Db interface, fsync on, "
              f"{FIGURE_ROWS} rows of {FIGURE_VALUE} B): {json.dumps(engines['figures'])} on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    host_codec = run_host_codec(dev, gen, card, composites["K3"]["ms"])

    main_k1 = k1["ec83_encode"]
    main_k2 = k2[(64 * (K + M), 131072)]
    kernels = [
        {
            "name": "gf_bitplane", "route": "cuda",
            "source": "garage_tpu_torch/csrc/gf_bitplane.cu",
            "replaces": "garage_tpu/ops/ec_tpu.py:116",
            "launches": launches["gf"],
            "launches_block_store": store_launches["gf"],
            "launches_s3": s3_launches["gf"], "launches_daemons": d_launches["k1"],
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
            "launches_block_store": store_launches["blake3"],
            "launches_s3": s3_launches["blake3"], "k3_launches_s3": s3_launches["k3"],
            "launches_daemons": d_launches["k2"], "k3_launches_daemons": d_launches["k3"],
            "k3_launches_engines": engines["write"]["k3_launches"],
            "mismatches": sum(r["mismatches"] for r in k2.values())
            + slice_res["hash_mismatches"],
            "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
            "ms": main_k2["ms"], "graph_ms": main_k2["graph_ms"],
            "replaced_design_ms": main_k2["old_ms"],
            "replaced_design_graph_ms": main_k2["old_graph_ms"],
            "plain_ms": main_k2["plain_ms"],
            "bound_ms": main_k2["bound_ms"], "bound_by": main_k2["bound_by"],
            "library_ms": None, "stack_frame_bytes": stack_frames,
            "k3_ms": composites["K3"]["ms"], "k3_over_k1_plus_k2":
                composites["K3"]["ms"] / composites["K3_split"]["k1_plus_k2"]["ms"],
            "k5_ms": composites["K5"]["ms"], "k5_graph_ms": composites["K5"]["graph_ms"],
            "k5_bound_ms": composites["K5"]["bound_ms"],
        },
        {
            "name": "mesh_fanout", "route": "cuda (K1 per entry)",
            "source": "garage_tpu_torch/ops/ec_cuda.py",
            "replaces": "garage_tpu/ops/ec_tpu.py:228",
            "launches": mesh_run["launches"]["gf"], "launches_s3": s3_launches["k6"],
            "launches_daemons": daemons["mesh_engaged"],
            "mismatches": mesh_run["mismatches"] + fanout["mismatches"],
            "max_abs_err": fanout["max_abs_err"],
            "ms": fanout["ms"], "plain_ms": fanout["plain_ms"],
            "bound_ms": fanout["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
        },
    ]
    print(json.dumps({"host_codec": {"source": "garage_tpu_torch/_native/gf8.cpp",
                                     "tpu_kernel": False, "card": card, **host_codec}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
