#!/usr/bin/env python3
"""The port's two kernels compiled for the host and run under g++'s
sanitizers: racecheck, synccheck and memcheck's kind of check without a
card or compute-sanitizer.

    python3 -m garage_tpu_torch.tools.cuda_on_host          # both builds
    python3 -m garage_tpu_torch.tools.cuda_on_host --asan   # ASan + UBSan
    python3 -m garage_tpu_torch.tools.cuda_on_host --tsan   # ThreadSanitizer

`csrc/gf_bitplane.cu` (K1) and `csrc/blake3.cu` (K2) are compiled by g++
as they stand, with two exact-text substitutions (K1's `extern
__shared__` table buffer becomes the block's shared buffer, K2's one line
of PTX, the add on the IMAD pipe, becomes the same add in C++; a source
that no longer holds the text fails the build) and each `<<<...>>>`
launch turned into a call of `cuda_on_host_launch`, against
`tools/cuda_on_host.h` in the place of <cuda_runtime.h>: every CUDA thread
a host thread, each block's threads at once and several blocks
overlapping, shared memory a heap buffer of the launch's exact size,
__syncthreads, __syncwarp and the shuffles barriers of the live threads.

  asan   AddressSanitizer + UBSan: an access outside any buffer (every
         input, output, scratch and shared-memory buffer is a malloc of
         its exact size) or a misaligned vector load or store fails
  tsan   ThreadSanitizer: two threads of a block touching one shared
         word (or one scratch word across blocks) without a barrier or an
         atomic between them fail; K2's hand-over of subtree CVs runs
         through its atomicAdd and fences

In both, a shuffle or __syncwarp that names a lane which has exited, or a
__syncthreads after threads of its block exited, is a synchronisation
error.  Each build runs in a child with the runtime preloaded and drives
the kernels' C entry points (`gf_bitplane_apply`, `blake3_rows`) on every
light case of `tools/verify.py`'s case list that launches a kernel: the
same shapes, strides, offsets and views, each output against the numpy
LUT oracle or the host BLAKE3 library, outputs and scratch first filled
with a poison byte.  It prints one line per case and a `launches:` line
per kernel, and exits 1 on any report, error or mismatch.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .. import _native
from ..ops import _build, gf
from . import verify

HEADER = Path(__file__).resolve().parent / "cuda_on_host.h"
OUT_DIR = _build.BUILD_DIR.parent / "cuda-on-host"
KERNEL_SOURCES = ("gf_bitplane", "blake3")
# exact source text -> its host form, by kernel source
SUBSTITUTIONS = {
    "gf_bitplane": [("  extern __shared__ __align__(16) uint8_t smem[];",
                     "  uint8_t* smem = cuda_on_host_shared();")],
    "blake3": [('  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(y), "r"(one), "r"(x));',
                "  r = y * one + x;")],
}
LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<([^\n]*?)>>>\(")
BASE_FLAGS = ["-std=c++17", "-g", "-O1", "-fno-omit-frame-pointer", "-pthread", "-shared",
              "-fPIC"]
# mode -> (compiler flags, runtime library, runtime options)
MODES = {
    "asan": (["-fsanitize=address,undefined", "-fno-sanitize-recover=all"], "libasan.so",
             {"ASAN_OPTIONS": "detect_leaks=0",
              "UBSAN_OPTIONS": "halt_on_error=1 print_stacktrace=1"}),
    "tsan": (["-fsanitize=thread"], "libtsan.so",
             {"TSAN_OPTIONS": "halt_on_error=1 exitcode=66 report_thread_leaks=0"}),
}
CHILD_TIMEOUT_S = 600
POISON = 0xA5
# cores the child's threads may run on: the sanitizers find what they find
# from the order of events, not from how many cores run them, and a test
# suite beside the child keeps the rest
CHILD_CORES = 2


class TranslationError(RuntimeError):
    """A kernel source no longer holds the text a substitution names."""


def translate(name: str, text: str) -> str:
    """The host form of kernel source `name`."""
    for old, new in SUBSTITUTIONS.get(name, []):
        if text.count(old) != 1:
            raise TranslationError(f"csrc/{name}.cu: expected the line {old!r} once")
        text = text.replace(old, new)
    text, launches = LAUNCH.subn(r"cuda_on_host_launch(\1, \2, ", text)
    if launches == 0:
        raise TranslationError(f"csrc/{name}.cu: no kernel launch found")
    return text


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise _build.KernelBuildError("g++ not found on PATH")
    return gxx


def build(mode: str, texts: dict[str, str] | None = None, tag: str = "") -> dict[str, Path]:
    """Translate and compile both kernel sources for `mode` (a source's
    text may be given in `texts`; `tag` names such a build); their
    paths."""
    flags = MODES[mode][0]
    inc = OUT_DIR / "include"
    inc.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(HEADER, inc / "cuda_runtime.h")
    out = {}
    for name in KERNEL_SOURCES:
        text = (texts or {}).get(name) or _build.source(name).read_text()
        src = OUT_DIR / f"{name}-{mode}{tag}.cpp"
        src.write_text(translate(name, text))
        lib = OUT_DIR / f"{name}-{mode}{tag}.so"
        proc = subprocess.run([_gxx(), *BASE_FLAGS, *flags, f"-I{inc}", "-o", str(lib), str(src)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise _build.KernelBuildError(f"g++ ({mode}) failed for {name}:\n{proc.stderr}")
        out[name] = lib
    return out


def runtime(mode: str) -> str:
    name = MODES[mode][1]
    path = subprocess.run([_gxx(), f"-print-file-name={name}"], capture_output=True, text=True,
                          check=True).stdout.strip()
    if not os.path.isabs(path):
        raise _build.KernelBuildError(f"g++ has no {name}")
    return path


def run_mode(mode: str, cases: list[str] | None = None, texts: dict[str, str] | None = None,
             tag: str = "") -> dict:
    """Build `mode` (from `texts` where given), run the child under its
    runtime on `cases` (names; all that launch a kernel when None);
    returns {"rc", "wall_s", "launches", "output"}."""
    t0 = time.perf_counter()
    libs = build(mode, texts, tag)
    _native.build()  # the host library the oracle uses, built outside the child
    env = dict(os.environ, **MODES[mode][2], LD_PRELOAD=runtime(mode))
    repo = str(HEADER.parents[2])
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "garage_tpu_torch.tools.cuda_on_host", "--child", mode,
             str(libs["gf_bitplane"]), str(libs["blake3"]), ",".join(cases or [])],
            env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        rc, text = proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, text = None, f"timed out after {CHILD_TIMEOUT_S} s: {e}"
    found = re.findall(r"^launches: (\{.*\})$", text, re.M)
    return {"rc": rc, "wall_s": time.perf_counter() - t0,
            "launches": json.loads(found[-1]) if found else {}, "output": text}


def clean(res: dict) -> bool:
    """A run passed: exit code 0 and a launch of each of the four kernels."""
    return res["rc"] == 0 and all(res["launches"].get(k, 0) > 0 for k in verify.KERNELS)


# --- the child ---------------------------------------------------------------------


class _Buffers:
    """malloc'd buffers of exact sizes (the preloaded sanitizer's malloc,
    so an access past either end is caught), freed together."""

    def __init__(self):
        self._libc = ctypes.CDLL(None)
        self._libc.malloc.restype = ctypes.c_void_p
        self._libc.malloc.argtypes = [ctypes.c_size_t]
        self._libc.free.argtypes = [ctypes.c_void_p]
        self._ptrs: list[int] = []

    def new(self, nbytes: int, fill: int = POISON):
        ptr = self._libc.malloc(max(nbytes, 1))
        self._ptrs.append(ptr)
        arr = np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(ptr))
        arr[:] = fill
        return ptr, arr

    def free(self) -> None:
        for ptr in self._ptrs:
            self._libc.free(ptr)
        self._ptrs.clear()


def _k1_launches(case, rng):
    """(coding matrix, data, input layout, output layout) of each K1
    launch of a "k1" or "repair" case; a layout is (alloc bytes, base
    offset, batch stride, row stride)."""
    if case.kind == "k1":
        data = rng.integers(0, 256, (case.b, case.k, case.s), dtype=np.uint8)
        (x_off, xb, xr), (o_off, ob, orow) = case.k1_strides()
        rows = case.k + case.m if case.strided_out else case.m
        yield (gf.cauchy_parity_matrix(case.k, case.m), data, (case.b * xb, x_off, xb, xr),
               (case.b * rows * orow, o_off, ob, orow))
        return
    full = verify.coded_pieces(rng, case.b, case.k, case.m, case.s)
    s = case.s
    for lost in verify.lost_patterns(case.k, case.m):
        present = [i for i in range(case.k + case.m) if i not in lost][: case.k]
        yield (gf.reconstruction_matrix(case.k, case.m, present, lost), full[:, present],
               (case.b * case.k * s, 0, case.k * s, s),
               (case.b * len(lost) * s, 0, len(lost) * s, s))


def _run_k1(lib, bufs: _Buffers, coding, data, x_layout, o_layout) -> bool:
    b, q, s = data.shape
    r = coding.shape[0]
    bm = np.ascontiguousarray(gf.bitmatrix_of(coding))
    bm_ptr, bm_arr = bufs.new(bm.size)
    bm_arr[:] = bm.reshape(-1)
    (x_alloc, x_off, xb, xr), (o_alloc, o_off, ob, orow) = x_layout, o_layout
    x_ptr, x_arr = bufs.new(x_alloc)
    for i in range(b):
        for j in range(q):
            at = x_off + i * xb + j * xr
            x_arr[at:at + s] = data[i, j]
    o_ptr, o_arr = bufs.new(o_alloc)
    code = lib.gf_bitplane_apply(0, bm_ptr, r, q, x_ptr + x_off, xb, xr, o_ptr + o_off, ob, orow,
                                 b, s, None)
    want = gf.apply_matrix_ref(coding, data)
    got = np.stack([np.stack([o_arr[o_off + i * ob + j * orow:o_off + i * ob + j * orow + s]
                              for j in range(r)]) for i in range(b)])
    return code == 0 and np.array_equal(got, want)


def _run_k2(lib, bufs: _Buffers, case, rng) -> bool:
    s = case.s
    if case.kind == "k2":
        rows = rng.integers(0, 256, (case.b, s), dtype="uint8")
        x_ptr, x_arr = bufs.new(rows.size)
        x_arr[:] = rows.reshape(-1)
        args = (x_ptr, 1, s, s, x_ptr, 0, 0, 0, case.b)
    else:  # two sources: views of one (b, k+m+1, s) buffer with a spare piece
        pieces = rng.integers(0, 256, (case.b, case.k + case.m + 1, s), dtype="uint8")
        x_ptr, x_arr = bufs.new(pieces.size)
        x_arr[:] = pieces.reshape(-1)
        st = ((case.k + case.m + 1) * s, s)
        args = (x_ptr, case.k, *st, x_ptr + (case.k + 1) * s, case.m, *st, case.b)
        rows = np.delete(pieces, case.k, axis=1).reshape(-1, s)
    n = rows.shape[0]
    words = lib.blake3_scratch_words(s)
    scratch = bufs.new(n * words * 4)[0] if words else None
    o_ptr, o_arr = bufs.new(n * 32)
    code = lib.blake3_rows(0, *args, s, scratch, o_ptr, None)
    return code == 0 and np.array_equal(o_arr.reshape(n, 32), _native.blake3_batch(rows))


def checked_cases(names: list[str] | None = None) -> list:
    """The light cases of `verify.CASES` that launch a kernel (those named)."""
    return [c for c in verify.CASES
            if not c.heavy and c.kind in ("k1", "repair", "k2", "pieces")
            and (not names or c.name in names)]


def child(mode: str, k1_so: str, k2_so: str, names: str = "") -> int:
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:CHILD_CORES])
    k1 = _build._bind("gf_bitplane", Path(k1_so))
    k2 = _build._bind("blake3", Path(k2_so))
    errors = [ctypes.CDLL(so).cuda_on_host_sync_errors for so in (k1_so, k2_so)]
    for f in errors:
        f.argtypes, f.restype = [], ctypes.c_longlong
    launches = dict.fromkeys(verify.KERNELS, 0)
    fails = 0
    bufs = _Buffers()
    for case in checked_cases([n for n in names.split(",") if n]):
        rng = np.random.default_rng([verify.SEED, verify.CASES.index(case)])
        t0 = time.perf_counter()
        if case.kind in ("k1", "repair"):
            ok = True
            for coding, data, x_layout, o_layout in _k1_launches(case, rng):
                ok &= _run_k1(k1, bufs, coding, data, x_layout, o_layout)
                launches[verify.K1_KERNELS[verify.k1_width(coding.shape[0])]] += 1
        else:
            ok = _run_k2(k2, bufs, case, rng)
            launches[verify.k2_kernel(case.s)] += 1
        bufs.free()
        fails += 0 if ok else 1
        print(f"{mode} case {case.name}: {'OK' if ok else 'MISMATCH'} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
    sync = sum(f() for f in errors)
    print(f"launches: {json.dumps(launches)}")
    print(f"{mode}: synchronisation errors {sync}, mismatches {fails}", flush=True)
    return 1 if fails or sync else 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"] and len(argv) == 5:
        return child(*argv[1:])
    modes = [a.lstrip("-") for a in argv] or list(MODES)
    if any(m not in MODES for m in modes):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    failed = False
    for mode in modes:
        res = run_mode(mode)
        ok = clean(res)
        print(res["output"], end="")
        print(f"cuda_on_host {mode}: {'PASS' if ok else 'FAIL'} rc={res['rc']} "
              f"wall_s={res['wall_s']:.3f}")
        failed |= not ok
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
