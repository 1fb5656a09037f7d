"""Host BLAKE3 in C++, loaded with ctypes.

The block store hashes single pieces on the host: every GET verifies
each piece it reads against the hash in the piece's header, and the
scrub hashes the piece lengths the batched device hasher does not take.
This directory holds a copy of the reference's `blake3.cpp` and
`parallel.h`, and nothing else of its native code.

g++ builds `blake3.cpp` at first use into `build/native/` at the
repository root (gitignored), as ops/_build.py does for the CUDA
kernels.  The file name carries a digest of the sources, the flags and
the host's ISA fingerprint: `-march=native` binaries are host-specific,
so a library built on another machine is rebuilt; a host without a
fingerprint gets a portable build without `-march=native`.

A failed build raises `NativeBuildError`.  There is no pure-Python
path: the block store never runs at the oracle's speed without saying
so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["NativeBuildError", "build", "blake3", "blake3_batch"]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ["blake3.cpp", "parallel.h"]
FLAGS = ["-O3", "-pthread", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the host BLAKE3 source."""


def _host_tag() -> str | None:
    """Fingerprint of this host's ISA (machine + CPU flags), or None
    when the host exposes none."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), None)
    except OSError:
        flags = None
    if flags is None:
        return None
    return hashlib.sha256((platform.machine() + flags).encode()).hexdigest()[:16]


def _flags() -> list[str]:
    return (["-march=native"] if _host_tag() is not None else []) + FLAGS


def _target() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(_flags()).encode())
    h.update((_host_tag() or "portable").encode())
    return BUILD_DIR / f"libblake3-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build (or reuse) the library; returns its path."""
    out = _target()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, *_flags(), "-o", str(tmp), str(_DIR / "blake3.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ failed for blake3.cpp:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.blake3_hash.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
            lib.blake3_hash.restype = None
            lib.blake3_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_char_p,
            ]
            lib.blake3_batch.restype = None
            _lib = lib
        return _lib


def blake3(data: bytes) -> bytes:
    """BLAKE3-256 of `data`."""
    out = ctypes.create_string_buffer(32)
    _load().blake3_hash(bytes(data), len(data), out)
    return out.raw


def blake3_batch(x: np.ndarray) -> np.ndarray:
    """x (n, each_len) uint8 -> (n, 32) uint8 digests, one per row."""
    if x.ndim != 2:
        raise ValueError(f"blake3_batch wants (n, each_len) rows, got shape {x.shape}")
    n, each = x.shape
    x_c = np.ascontiguousarray(x, dtype=np.uint8)
    out = np.zeros((n, 32), dtype=np.uint8)
    _load().blake3_batch(
        x_c.ctypes.data_as(ctypes.c_char_p), n, each, out.ctypes.data_as(ctypes.c_char_p),
    )
    return out
