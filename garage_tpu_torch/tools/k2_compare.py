#!/usr/bin/env python3
"""Compare kernel K2 (csrc/blake3.cu) with its variants and with the design
it replaced, on one CUDA card.

    python -m garage_tpu_torch.tools.k2_compare

Each variant is the kernel source with named constants or pieces of text
replaced: the first design's chunk loop with the next block in flight
("two_buffers", the base of most variants), chunks per lane (kPer), two
chunks per lane compressed side by side ("ilp2"), warps per thread block
(kWarps), the register cap (kMinWarps), the adds left to the compiler
(IADD3 on the ALU pipe), rotates by 16 and 8 as byte permutes ("prmt"),
one round in the code ("rolled"), fewer warps per SM ("occ8", "occ12").  The
"probe_" variants time a part of the kernel and hash wrongly on purpose
(their mismatches are printed, not failed): the chunk loop without its
loads, and its loads without the compressions.  "block_per_row" is the
design K2 replaced (tools/blake3_block_per_row.cu, one thread block per
row), built from its own source.  All are built together, one nvcc each,
into build/k2-variants/, checked against `blake3_batch_ref` at every shape
(0 mismatches, else the tool exits non-zero) and timed at chip_smoke.py's
K2 shapes and at 1 MiB rows:

  eager_ms  CUDA events around 50 launches (each zeroes the arrival
            counters it needs, then runs the kernel)
  graph_ms  CUDA events around one replay of a CUDA graph that holds 50
            such launches: the card's time per launch, without the host

Prints the card line from nvidia-smi, each build's ptxas lines and SASS
opcode counts, one line per (variant, shape), the SM clock and power
under load, and a JSON object with every number; each build's full SASS
is written beside it as build/k2-variants/<variant>.sass.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

from garage_tpu_torch.ops import _build
from garage_tpu_torch.ops.hash_cuda import blake3_batch_ref
from garage_tpu_torch.tools.sass import sass_int_ops, sass_text
from garage_tpu_torch.tools.timing import graph_ms, time_ms

SOURCE = _build.CSRC / "blake3.cu"
OUT_DIR = _build.BUILD_DIR.parent / "k2-variants"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, at the 700 W limit
INT32_LANES_PER_SM = 64  # per pipe: the ALU pipe, and the IMAD pipe
# int32 instructions of one compression, counted in csrc/blake3.cu: the
# XORs and rotates (LOP3, SHF/PRMT) run only on the ALU pipe; the adds
# may also issue on the IMAD pipe
BLAKE3_ALU_ONLY_OPS = 7 * 8 * 8 + 8
BLAKE3_ADD_OPS = 7 * 8 * 4
# chip_smoke.py's K2 shapes (rows, bytes per row), then 1 MiB rows
SHAPES = [(64 * 11, 131072), (4096, 64), (4096, 1024), (2048, 4096), (64, 1 << 20)]

ONE_BUFFER = """\
  uint32_t m[16];
  set_iv(cv);
#pragma unroll 1
  for (int b = 0; b < 16; ++b) {
    load_block(p + 64 * b, m);
    compress(cv, m, chunk, (b == 0 ? kChunkStart : 0u) | (b == 15 ? kChunkEnd : 0u), one);
  }
"""
# the first design's chunk loop: block b + 1 in flight while b is compressed
TWO_BUFFERS = """\
  uint32_t ma[16], mb[16];
  set_iv(cv);
  load_block(p, ma);
#pragma unroll 1
  for (int b = 0; b < 16; b += 2) {
    load_block(p + 64 * (b + 1), mb);
    compress(cv, ma, chunk, b == 0 ? kChunkStart : 0u, one);
    load_block(p + 64 * (b + 2 < 16 ? b + 2 : 15), ma);
    compress(cv, mb, chunk, b == 14 ? kChunkEnd : 0u, one);
  }
"""
SEVEN_ROUNDS = "".join(f"  ROUND({', '.join(map(str, r))})\n" for r in (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8),
    (3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1),
    (10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6),
    (12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4),
    (9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7),
    (11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13)))
PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

# one substitution each: (text in the source, replacement)
SUBS = {
    "per2": ("constexpr int kPer = 1;", "constexpr int kPer = 2;"),
    "warps4": ("constexpr int kWarps = 1;", "constexpr int kWarps = 4;"),
    "minwarps32": ("constexpr int kMinWarps = 24;", "constexpr int kMinWarps = 32;"),
    "minwarps12": ("constexpr int kMinWarps = 24;", "constexpr int kMinWarps = 12;"),
    # the one-thread-per-row kernel with the adds left to the compiler
    # (`one` a compile-time 1 that ptxas folds)
    "small_plain_adds": ("    compress(cv, m, 0ull, flags, one);\n  }\n  store_digest(out + row * 32, cv);",
                         "    compress(cv, m, 0ull, flags, 1u);\n  }\n  store_digest(out + row * 32, cv);"),
    # the adds left to the compiler: IADD3 (ALU pipe) or IMAD.IADD, its choice
    "iadd3": ('asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(y), "r"(one), "r"(x));',
              "r = x + y;"),
    "two_buffers": (ONE_BUFFER, TWO_BUFFERS),
    # one round in the code, looped 7 times, the message permuted by moves:
    # a compression's code is 7x smaller
    "rolled": (SEVEN_ROUNDS, """\
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
#pragma unroll 1
  for (int r = 0; r < 7; ++r) {
    {
      const uint32_t* m = w;
      ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    }
    uint32_t t[16];
""" + "".join(f"    t[{i}] = w[{p}];\n" for i, p in enumerate(PERMUTATION)) + """\
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = t[i];
  }
"""),
    # two chunks per lane compressed side by side: two independent
    # dependency chains in one basic block for ptxas to interleave
    "ilp2": ("""\
  uint32_t cv[8];
  chunk_cv(p, chunk0, one, cv);
  if (kPer == 2) {
    uint32_t right[8];
    chunk_cv(p + 1024, chunk0 + 1, one, right);
    parent(cv, right, lpr == 1 ? kRoot : 0u, cv, one);
  }
""", """\
  uint32_t cv[8], right[8], ma[16], mb[16];
  set_iv(cv);
  set_iv(right);
#pragma unroll 1
  for (int b = 0; b < 16; ++b) {
    load_block(p + 64 * b, ma);
    load_block(p + 1024 + 64 * b, mb);
    const uint32_t f = (b == 0 ? kChunkStart : 0u) | (b == 15 ? kChunkEnd : 0u);
    compress(cv, ma, chunk0, f, one);
    compress(right, mb, chunk0 + 1, f, one);
  }
  parent(cv, right, lpr == 1 ? kRoot : 0u, cv, one);
"""),
    # rotates by 16 and 8 as byte permutes of one register (PRMT reads one
    # source; the funnel shift names its source twice)
    "prmt": ("""\
__device__ __forceinline__ uint32_t rotr(uint32_t v, int n) {
  return __funnelshift_r(v, v, n);
}""", """\
__device__ __forceinline__ uint32_t rotr(uint32_t v, int n) {
  if (n == 16) return __byte_perm(v, 0, 0x1032);
  if (n == 8) return __byte_perm(v, 0, 0x0321);
  return __funnelshift_r(v, v, n);
}"""),
    # fewer resident warps per SM (shared memory the kernel never reads
    # caps the blocks an SM holds): is the issue rate per sub-partition
    # higher with fewer warps interleaved?
    "occ8": ("""\
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);""", """\
  __shared__ uint32_t pad[6400];
  if (threadIdx.x == 1000) pad[one] = 1;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);"""),
    "occ12": ("""\
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);""", """\
  __shared__ uint32_t pad[4400];
  if (threadIdx.x == 1000) pad[one] = 1;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);"""),
    # probes (their digests are wrong on purpose): the chunk loop without
    # its loads (compute alone), and its loads without the compressions
    "probe_noload": (TWO_BUFFERS, """\
  uint32_t ma[16], mb[16];
  (void)mb;
  set_iv(cv);
  load_block(p, ma);
#pragma unroll 1
  for (int b = 0; b < 16; b += 2) {
    compress(cv, ma, chunk, b == 0 ? kChunkStart : 0u, one);
    compress(cv, ma, chunk, b == 14 ? kChunkEnd : 0u, one);
  }
"""),
    "probe_loads_only": (TWO_BUFFERS, """\
  uint32_t ma[16], mb[16];
  set_iv(cv);
  load_block(p, ma);
#pragma unroll 1
  for (int b = 0; b < 16; b += 2) {
    load_block(p + 64 * (b + 1), mb);
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] ^= ma[i] ^ ma[8 + i];
    load_block(p + 64 * (b + 2 < 16 ? b + 2 : 15), ma);
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] ^= mb[i] ^ mb[8 + i];
  }
"""),
}
# name -> the substitutions it makes, in order
VARIANTS = {
    "base": [],
    "base_iadd3": ["iadd3"],
    "base_prmt": ["prmt"],
    "small_plain_adds": ["small_plain_adds"],
    "two_buffers": ["two_buffers"],
    "per2": ["two_buffers", "per2"],
    "warps4": ["two_buffers", "warps4"],
    "minwarps32": ["two_buffers", "minwarps32"],
    "iadd3": ["two_buffers", "iadd3"],
    "rolled": ["two_buffers", "rolled"],
    "prmt": ["two_buffers", "prmt"],
    "occ8": ["two_buffers", "occ8"],
    "occ12": ["two_buffers", "occ12"],
    "ilp2": ["per2", "ilp2"],
    "ilp2_regs": ["per2", "ilp2", "minwarps12"],
    "probe_noload": ["two_buffers", "probe_noload"],
    "probe_noload_occ8": ["two_buffers", "probe_noload", "occ8"],
    "probe_loads_only": ["two_buffers", "probe_loads_only"],
}
OLD = "block_per_row"


def blake3_bound_ms(n: int, length: int, sm_count: int, clock_hz: float) -> tuple[float, str]:
    """The least time the card could take to hash n rows of `length`
    bytes, and what bounds it: every compression's int32 operations on
    the ALU and IMAD pipes of all SMs at the SM clock, or the bytes read
    and written at HBM rate, whichever is longer."""
    chunks = max(1, length // 1024)
    comps = n * (length // 64 + (chunks - 1 if chunks > 1 else 0))
    # lane-cycles per compression on one SM: the ALU pipe carries at least
    # the ALU-only ops, and both pipes together carry every op
    lane_cycles = max(BLAKE3_ALU_ONLY_OPS / INT32_LANES_PER_SM,
                      (BLAKE3_ALU_ONLY_OPS + BLAKE3_ADD_OPS) / (2 * INT32_LANES_PER_SM))
    ops_ms = comps * lane_cycles / (sm_count * clock_hz) * 1e3
    bytes_ms = (n * length + n * 32) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES["blake3"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build(names) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Build the variants `names` of csrc/blake3.cu: {name: (library,
    path of the .so)}.  Prints each build's ptxas register and stack
    lines."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name in names:
        src = text
        for sub in VARIANTS[name]:
            old, new = SUBS[sub]
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in {SOURCE.name}")
            src = src.replace(old, new)
        path = OUT_DIR / f"{name}.cu"
        path.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT_DIR / f"{name}.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}")
        so = OUT_DIR / f"{name}.so"
        libs[name] = (_bind(so), str(so))
    return libs


def launch(lib, x: torch.Tensor, out: torch.Tensor, scratch: torch.Tensor) -> None:
    """One launch of a variant on contiguous rows x (n, L), as the
    wrapper makes it (the entry zeroes the arrival counters itself)."""
    code = lib.blake3_rows(
        x.device.index, x.data_ptr(), 1, x.stride(0), x.stride(0), x.data_ptr(), 0,
        x.stride(0), x.stride(0), x.shape[0], x.shape[1], scratch.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "blake3_rows")


def old_k2(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """The replaced design on contiguous rows x (n, L) into out (n, 32),
    allocated here when not given, as the replaced wrapper did; not
    counted as a launch of `blake3_batch`."""
    if out is None:
        out = torch.empty((x.shape[0], 32), dtype=torch.uint8, device=x.device)
    code = _build.lib("blake3_block_per_row").blake3_rows(
        x.device.index, x.data_ptr(), x.shape[1], x.shape[0], out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "blake3_rows (block per row)")
    return out


def clock_under_load(fn, seconds: float = 2.0) -> list[tuple[float, float]]:
    """(SM clock MHz, power W) samples from nvidia-smi every 100 ms while
    fn() runs back to back for `seconds`."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        text, _ = proc.communicate()
    return [tuple(float(v) for v in line.split(",")) for line in text.splitlines()
            if line.count(",") == 1]


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_compare: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = lambda q: subprocess.run(  # noqa: E731
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    card = smi("name,power.limit")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    print(card)
    names = list(VARIANTS) if len(sys.argv) < 2 else sys.argv[1].split(",")
    libs = build(names)
    _build.build_all([f"blake3_{OLD}"])
    sources = {name: so for name, (_lib, so) in libs.items()}
    sources[OLD] = str(_build._target(f"blake3_{OLD}"))
    for name, so in sources.items():
        text = sass_text(so)
        if text is not None:
            (OUT_DIR / f"{name}.sass").write_text(text)
        if name != OLD:
            print(f"sass {name} blake3_warp_kernel: "
                  f"{json.dumps(sass_int_ops(so, 'blake3_warp_kernel'))}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results, bad, clocks = [], 0, {}
    for n, length in SHAPES:
        x = torch.randint(0, 256, (n, length), dtype=torch.uint8, device=dev, generator=gen)
        want = blake3_batch_ref(x)
        bound, by = blake3_bound_ms(n, length, sm_count, clock_hz)
        out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
        words = max([1] + [lib.blake3_scratch_words(length) for lib, _so in libs.values()])
        scratch = torch.empty(n * words, dtype=torch.int32, device=dev)
        calls = {name: (lambda lib=lib: launch(lib, x, out, scratch))
                 for name, (lib, _so) in libs.items()}
        calls[OLD] = lambda: old_k2(x, out)
        for name, fn in calls.items():
            out.zero_()
            fn()
            torch.cuda.synchronize()
            mism = int((out != want).sum())
            bad += mism != 0 and not name.startswith("probe_")
            row = {"variant": name, "rows": n, "len": length, "mismatches": mism,
                   "bound_ms": bound, "bound_by": by,
                   "eager_ms": time_ms(fn, 50), "graph_ms": graph_ms(fn, 50)}
            results.append(row)
            print(f"rows={n:5d} L={length:8d} {name:14s} mismatches={mism} "
                  f"eager_ms={row['eager_ms']:.6f} graph_ms={row['graph_ms']:.6f} "
                  f"bound_ms={bound:.6f} ({by}) eager_share={bound / row['eager_ms']:.4f} "
                  f"graph_share={bound / row['graph_ms']:.4f}")
        if (n, length) == SHAPES[0]:
            for name in ("base", OLD):
                samples = clock_under_load(calls[name])
                late = sorted(samples[len(samples) // 2:])
                mid = late[len(late) // 2] if late else (float("nan"), float("nan"))
                clocks[name] = samples
                print(f"under load rows={n} L={length} {name}: sm_clock_mhz={mid[0]:.0f} "
                      f"power_w={mid[1]:.2f} (median of the last half of {len(samples)} "
                      f"samples)")
    print(json.dumps({"card": card, "results": results, "clocks": clocks}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
