"""Build and bind the hand-written CUDA kernels (`garage_tpu_torch/csrc`).

Each `csrc/<name>.cu` has a plain C interface and compiles on its own,
at first use, into `build/kernels/<name>-<digest>.so` at the repository
root (gitignored), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

and is loaded with `ctypes`.  The digest covers the source and the
flags, so an edited kernel is rebuilt and a built one is reused.
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
        # (device, x, row_len, n_rows, out, stream)
        "blake3_rows": [I32, P, I64, I64, P, P],
    },
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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
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
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), tmp, out)
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[n] = log
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc failed for {n}.cu:\n{log}")
            os.replace(tmp, out)
            secs[n] = time.perf_counter() - t0
            telemetry.compile_event(n, secs[n])
        for n in todo:
            _libs[n] = _bind(n, _target(n))
        return secs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built at first use."""
    found = _libs.get(name)
    if found is None:
        build_all([name])
        found = _libs[name]
    return found


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code}")


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches`.  The batcher's encode and decode
    lanes launch from two worker threads at once, so the increment is
    taken under a lock to keep the count exact."""
    with _count_lock:
        wrapper.launches += 1
