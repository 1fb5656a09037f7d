"""Host code in C++: the GF(2^8) codec, BLAKE3 and the native metadata engine.

A codec that runs on the host (a CPU `EcCodec`, or `[block] batch_impl
= "host"`) codes with `gf8.cpp`'s split-nibble SIMD tables and hashes
its pieces with `blake3.cpp`.  The block store hashes single pieces on
the host too: every GET verifies each piece it reads against the hash
in the piece's header, and the scrub hashes the piece lengths the
batched device hasher does not take.  `db_engine = "native"` keeps the
metadata in `kvlog.cpp`'s ordered maps behind a write-ahead log.  This
directory holds copies of the reference's `gf8.cpp`, `blake3.cpp`,
`kvlog.cpp`, `kvpy.cpp` and `parallel.h`.

g++ builds two targets at first use into `build/native/` at the
repository root (gitignored), as ops/_build.py does for the CUDA
kernels:

  libgarage_native-<digest>.so  gf8.cpp + blake3.cpp + kvlog.cpp, loaded
                                with ctypes
  garage_kv-<digest>.so         kvpy.cpp + kvlog.cpp, a CPython extension
                                (the native engine's binding: ~100 ns a
                                call against ctypes' ~3 us)

A file name carries a digest of the sources, the flags and the host's
ISA fingerprint: `-march=native` binaries are host-specific, so a
library built on another machine is rebuilt; a host without a
fingerprint gets a portable build without `-march=native`.  The
extension's digest also carries the interpreter's ABI tag.  The native
engine takes the extension, or the ctypes library when this
interpreter has no `Python.h` to build the extension against
(`kv_binding()` says which).

A failed build raises `NativeBuildError`.  There is no pure-Python
path: the host codec, the block store and the native engine never run
at the oracle's speed without saying so.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import platform
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "NativeBuildError", "available", "build", "build_kv", "blake3", "blake3_batch",
    "gf8_apply", "kv_binding", "kv_module", "lib",
]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ["gf8.cpp", "blake3.cpp", "kvlog.cpp", "parallel.h"]  # the ctypes library
KV_SOURCES = ["kvpy.cpp", "kvlog.cpp"]  # the extension module
FLAGS = ["-O3", "-pthread", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_kv_mod = None
_kv_tried = False


class NativeBuildError(RuntimeError):
    """g++ is missing or refused a source of this directory."""


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


def _python_include() -> str | None:
    inc = sysconfig.get_paths().get("include")
    if inc is None or not os.path.exists(os.path.join(inc, "Python.h")):
        return None
    return inc


def _target(stem: str, sources: list[str], flags: list[str], tag: str = "") -> Path:
    h = hashlib.sha256()
    for name in sources:
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(flags).encode())
    h.update(((_host_tag() or "portable") + tag).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _compile(out: Path, sources: list[str], flags: list[str]) -> Path:
    """Build `out` from `sources` (the .cpp files among them) unless it
    exists; a concurrent builder's result is replaced atomically."""
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cpp = [str(_DIR / s) for s in sources if s.endswith(".cpp")]
    proc = subprocess.run([gxx, *flags, "-o", str(tmp), *cpp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ failed for {' + '.join(sources)}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Build (or reuse) the ctypes library; returns its path."""
    return _compile(_target("libgarage_native", SOURCES, _flags()), SOURCES, _flags())


def build_kv() -> Path | None:
    """Build (or reuse) the extension module; returns its path, or None
    when this interpreter has no `Python.h`."""
    inc = _python_include()
    if inc is None:
        return None
    flags = _flags() + [f"-I{inc}"]
    tag = ":" + str(sysconfig.get_config_var("SOABI"))
    return _compile(_target("garage_kv", KV_SOURCES, flags, tag), KV_SOURCES, flags)


def _declare(l: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    l.gf8_apply.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_char_p, c.c_char_p, c.c_size_t]
    l.gf8_apply.restype = None
    l.blake3_hash.argtypes = [c.c_char_p, c.c_size_t, c.c_char_p]
    l.blake3_hash.restype = None
    l.blake3_batch.argtypes = [c.c_char_p, c.c_size_t, c.c_size_t, c.c_char_p]
    l.blake3_batch.restype = None
    l.kv_open.argtypes = [c.c_char_p, c.c_int]
    l.kv_open.restype = c.c_void_p
    l.kv_close.argtypes = [c.c_void_p]
    l.kv_commit.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    l.kv_get.argtypes = [
        c.c_void_p, c.c_char_p, c.c_size_t, c.c_char_p, c.c_size_t,
        c.POINTER(c.c_void_p), c.POINTER(c.c_size_t),
    ]
    l.kv_tree_len.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    l.kv_tree_len.restype = c.c_uint64
    l.kv_tree_names.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    l.kv_tree_names.restype = c.c_size_t
    l.kv_iter_chunk.argtypes = [
        c.c_void_p, c.c_char_p, c.c_size_t,
        c.c_char_p, c.c_size_t, c.c_int,
        c.c_char_p, c.c_size_t, c.c_int, c.c_int,
        c.c_uint32, c.c_char_p, c.c_size_t, c.POINTER(c.c_int),
    ]
    l.kv_iter_chunk.restype = c.c_size_t
    l.kv_compact_now.argtypes = [c.c_void_p]
    l.kv_sync_barrier.argtypes = [c.c_void_p]
    for name in ("kv_log_bytes", "kv_live_bytes", "kv_sync_failures"):
        getattr(l, name).argtypes = [c.c_void_p]
        getattr(l, name).restype = c.c_uint64
    return l


def lib() -> ctypes.CDLL:
    """The ctypes library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


def available() -> bool:
    """True once the library is built: a failed build raises
    `NativeBuildError`, it never answers False."""
    return lib() is not None


def kv_module():
    """The `garage_kv` extension module, built on first use; None when
    this interpreter has no `Python.h` (the native engine then binds
    through `lib()`)."""
    global _kv_mod, _kv_tried
    with _lock:
        if not _kv_tried:
            so = build_kv()
            if so is not None:
                spec = importlib.util.spec_from_file_location("garage_kv", so)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _kv_mod = mod
            _kv_tried = True
        return _kv_mod


def kv_binding() -> str:
    """Which binding the native engine takes here: "extension" or "ctypes"."""
    return "extension" if kv_module() is not None else "ctypes"


def gf8_apply(mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """out (r, s) = mat (r, q) @ shards (q, s) over GF(2^8), uint8."""
    if mat.ndim != 2 or shards.ndim != 2 or mat.shape[1] != shards.shape[0]:
        raise ValueError(f"gf8_apply wants (r, q) @ (q, s), got {mat.shape} @ {shards.shape}")
    r, q = mat.shape
    s = shards.shape[1]
    mat_c = np.ascontiguousarray(mat, dtype=np.uint8)
    sh_c = np.ascontiguousarray(shards, dtype=np.uint8)
    out = np.empty((r, s), dtype=np.uint8)
    lib().gf8_apply(
        mat_c.ctypes.data_as(ctypes.c_char_p), r, q,
        sh_c.ctypes.data_as(ctypes.c_char_p), out.ctypes.data_as(ctypes.c_char_p), s,
    )
    return out


def blake3(data: bytes) -> bytes:
    """BLAKE3-256 of `data`."""
    out = ctypes.create_string_buffer(32)
    lib().blake3_hash(bytes(data), len(data), out)
    return out.raw


def blake3_batch(x: np.ndarray) -> np.ndarray:
    """x (n, each_len) uint8 -> (n, 32) uint8 digests, one per row."""
    if x.ndim != 2:
        raise ValueError(f"blake3_batch wants (n, each_len) rows, got shape {x.shape}")
    n, each = x.shape
    x_c = np.ascontiguousarray(x, dtype=np.uint8)
    out = np.zeros((n, 32), dtype=np.uint8)
    lib().blake3_batch(
        x_c.ctypes.data_as(ctypes.c_char_p), n, each, out.ctypes.data_as(ctypes.c_char_p),
    )
    return out
