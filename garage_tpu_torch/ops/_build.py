"""Build and bind the hand-written CUDA kernels (`garage_tpu_torch/csrc`).

Each `csrc/<name>.cu` (and the tools' yardstick sources in `SOURCES`)
has a plain C interface and compiles on its own, at first use, into
`build/kernels/<name>-<digest>.so` at the repository root (gitignored),
with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

and is loaded with `ctypes`.  The digest covers the source and the
flags, so an edited kernel is rebuilt and a built one is reused (a miss
or a hit of `tpu_compile_cache_{miss,hit}_total{cache}`, with the label
`BUILD_CACHES` gives the source; a build's seconds are a compile event
under that label); the
compiler's output (ptxas registers and stack frames) is kept beside it
as `<name>-<digest>.log` and read into `build_logs` either way.
`build_all()` starts one nvcc per source, all together.  A failed build
raises `KernelBuildError` with the compiler's output: nothing falls back
to the plain versions.

Every C entry takes its pointers and the CUDA stream as `void*` and
returns `cudaGetLastError()` after its launches; `check()` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..utils.metrics import registry
from . import telemetry

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int

# C signatures of the entry points, by source
SIGNATURES = {
    "gf_bitplane": {
        # (device, bitmat, r, q, x, x_batch_stride, x_row_stride,
        #  out, out_batch_stride, out_row_stride, batch, S, stream)
        "gf_bitplane_apply": [I32, P, I32, I32, P, I64, I64, P, I64, I64,
                              I64, I64, P],
    },
    "blake3": {
        # (device, x0, q0, x0_batch_stride, x0_row_stride,
        #  x1, q1, x1_batch_stride, x1_row_stride, batch, row_len,
        #  scratch, out, stream)
        "blake3_rows": [I32, P, I64, I64, I64, P, I64, I64, I64, I64, I64,
                        P, P, P],
        # (row_len) -> 32-bit scratch words per row
        "blake3_scratch_words": [I64],
    },
    # the design K2 replaced (one thread block per row), kept as the
    # yardstick `tools/k2_compare.py` and chip_smoke.py time it against
    "blake3_block_per_row": {
        # (device, x, row_len, n_rows, out, stream)
        "blake3_rows": [I32, P, I64, I64, P, P],
    },
}
# source of each library: csrc/<name>.cu unless named here
SOURCES = {
    "blake3_block_per_row": CSRC.parent / "tools" / "blake3_block_per_row.cu",
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel entry returned a CUDA error."""


_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


# the `cache` label of each source's build events and build-cache lookups:
# the reference's name for the jit cache of the same function, which is
# no dispatch's kernel name and is in the label set the reference's
# dashboard lint allows (`script/dashboard_lint.py`, `_COMPILE_CACHES`)
BUILD_CACHES = {
    "gf_bitplane": "ec_apply",
    "blake3": "blake3_hasher",
    "blake3_block_per_row": "blake3_hasher",
}


def source(name: str) -> Path:
    return SOURCES.get(name, CSRC / f"{name}.cu")


def _target(name: str) -> Path:
    src = source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(names=None) -> dict[str, float]:
    """Build (or reuse) and load every kernel source; one nvcc process
    per source, all started together.  Returns build seconds by source
    (0.0 for a library already built with these flags)."""
    names = list(names or SIGNATURES)
    with _lock:
        todo = [n for n in names if n not in _libs]
        secs = {n: 0.0 for n in names}
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = _target(n)
            telemetry.record_cache_event(BUILD_CACHES[n], out.exists())
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(n))]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), tmp, out)
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc failed for {source(n).name}:\n{log}")
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            secs[n] = time.perf_counter() - t0
            telemetry.compile_event(BUILD_CACHES[n], secs[n])
        for n in todo:
            log = _target(n).with_suffix(".log")
            build_logs[n] = log.read_text() if log.exists() else ""
            _libs[n] = _bind(n, _target(n))
        return secs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source `name`, built at first use."""
    found = _libs.get(name)
    if found is None:
        build_all([name])
        found = _libs[name]
    return found


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code}")


def _launch_key(wrapper) -> tuple:
    return ("cuda_kernel_launches_total", (("kernel", wrapper.__name__),))


def count_launch(wrapper) -> None:
    """Add one to the process's `cuda_kernel_launches_total{kernel=
    <wrapper>}` counter, the one count of a wrapper's launches, which a
    node's `/metrics` exposes (the launches of a node in another process
    are read there).  The batcher's encode and decode lanes launch from
    two worker threads at once, so the increments are taken under a lock
    to keep the counts exact."""
    name, labels = _launch_key(wrapper)
    with _count_lock:
        registry.incr(name, labels)


def launch_count(wrapper) -> int:
    """How many times `wrapper` has launched its kernel in this process."""
    return int(registry.counters.get(_launch_key(wrapper), 0))
