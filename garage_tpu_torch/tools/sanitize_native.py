#!/usr/bin/env python3
"""Sanitizer job for the port's native host code: ASan, UBSan and TSan
over `_native/gf8.cpp`, `_native/blake3.cpp` and `_native/kvlog.cpp`
(the host codec, host BLAKE3 and the native metadata engine with its
group-commit flusher thread).

    python3 -m garage_tpu_torch.tools.sanitize_native --asan
    python3 -m garage_tpu_torch.tools.sanitize_native --ubsan
    python3 -m garage_tpu_torch.tools.sanitize_native --tsan
    python3 -m garage_tpu_torch.tools.sanitize_native --all

Each mode compiles the three sources with g++ and that sanitizer into
`build/sanitize/libgarage_native_<mode>.so` at the repository root
(gitignored), with `-march=native` where the port's own build takes it
(`_native._flags`), so the SIMD paths are the ones instrumented.  It then
runs a child Python process with the sanitizer's runtime preloaded
(`LD_PRELOAD`; the interpreter itself is not instrumented), which
imports no torch and binds that build itself: the port's loader
(`_native.lib()`) has no variable that points it at another library.
The child

  - holds `gf8_apply` against `ops/gf.py::apply_matrix_ref` (the numpy
    LUT oracle) at edge shapes and at widths that split across threads,
    and `blake3` / `blake3_batch` against `ops/blake3_ref.py` at every
    chunk and block boundary;
  - drives the kvlog engine through `NativeDb(path,
    binding=_CtypesBinding(lib))`: a seeded sequence of inserts and
    removes against a dict, a compaction, a reopen over a torn tail of
    garbage (the frame parser), and group commit (the flusher thread
    racing commits, barriers and compactions) with a reopen; under TSan
    with 20,000 commits, a barrier every 500 and a compaction every
    2,000.

Any sanitizer report ends the child with a non-zero code, and the mode
fails.  `--all` runs tsan, asan and ubsan, each in a process of its own
so the preloaded runtimes never mix, prints one summary table (mode,
PASS or FAIL, seconds, log under build/sanitize/) and exits 1 if any mode
failed.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from .. import _native

OUT_DIR = _native.BUILD_DIR.parent / "sanitize"
SOURCES = ["gf8.cpp", "blake3.cpp", "kvlog.cpp"]
BASE_FLAGS = ["-g", "-O1", "-pthread", "-fno-omit-frame-pointer", "-shared", "-fPIC",
              "-std=c++17"]
# mode -> (compiler flags, runtime library, runtime options)
MODES = {
    "asan": (["-fsanitize=address", "-fno-sanitize-recover=all"], "libasan.so",
             # the interpreter is not instrumented: its leaks are not ours
             {"ASAN_OPTIONS": "detect_leaks=0"}),
    "ubsan": (["-fsanitize=undefined", "-fno-sanitize-recover=all"], "libubsan.so",
              {"UBSAN_OPTIONS": "halt_on_error=1 print_stacktrace=1"}),
    "tsan": (["-fsanitize=thread"], "libtsan.so",
             {"TSAN_OPTIONS": "halt_on_error=1 exitcode=66 report_thread_leaks=0"}),
}
ALL_ORDER = ("tsan", "asan", "ubsan")
MODE_TIMEOUT_S = 600


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise _native.NativeBuildError("g++ not found on PATH")
    return gxx


def build(mode: str) -> Path:
    """Compile the sanitized library of `mode`; returns its path."""
    flags, _runtime, _opts = MODES[mode]
    march = [f for f in _native._flags() if f.startswith("-march")]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / f"libgarage_native_{mode}.so"
    cmd = [_gxx(), *BASE_FLAGS, *march, *flags, "-o", str(out),
           *(str(_native._DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise _native.NativeBuildError(f"g++ ({mode}) failed:\n{proc.stderr}")
    return out


def runtime(mode: str) -> str:
    """Path of the sanitizer's runtime library, as g++ resolves it."""
    name = MODES[mode][1]
    path = subprocess.run([_gxx(), f"-print-file-name={name}"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if not os.path.isabs(path):
        raise _native.NativeBuildError(f"g++ has no {name}")
    return path


def run_mode(mode: str) -> int:
    """Build `mode`'s library and run the child under its runtime; the
    child's exit code."""
    so = build(mode)
    env = dict(os.environ, **MODES[mode][2], LD_PRELOAD=runtime(mode))
    repo = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    print(f"{mode}: built {so}", flush=True)
    return subprocess.run(
        [sys.executable, "-m", "garage_tpu_torch.tools.sanitize_native", "--child", mode,
         str(so)], env=env, timeout=MODE_TIMEOUT_S,
    ).returncode


def run_all() -> int:
    """Every mode in a process of its own; a summary table; 1 if any failed."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    rows, failed = [], False
    for mode in ALL_ORDER:
        log = OUT_DIR / f"{mode}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            try:
                rc = subprocess.run(
                    [sys.executable, "-m", "garage_tpu_torch.tools.sanitize_native",
                     f"--{mode}"], stdout=f, stderr=subprocess.STDOUT,
                    timeout=MODE_TIMEOUT_S + 300,
                ).returncode
            except subprocess.TimeoutExpired:
                rc = -1
        status = "PASS" if rc == 0 else "FAIL"
        failed |= rc != 0
        rows.append(f"{mode}\t{status}\t{time.perf_counter() - t0:.1f}s\t{log}")
    print("\n=== sanitize-native summary ===")
    print("MODE\tRESULT\tTIME\tLOG")
    print("\n".join(rows))
    if failed:
        print("one or more sanitizer modes FAILED: see the logs above")
    return 1 if failed else 0


# --- the child: runs under the preloaded sanitizer runtime -----------------------


class CheckFailed(RuntimeError):
    """A result of the sanitized library differs from its oracle or model."""


def _require(cond: bool, what) -> None:
    if not cond:
        raise CheckFailed(str(what))


def _oracle_checks(rng) -> None:
    import numpy as np

    from ..ops import gf
    from ..ops.blake3_ref import blake3 as py_blake3

    # edge shapes, and widths gf8.cpp splits across threads
    for r, q, s in [(1, 1, 1), (3, 8, 7), (4, 16, 4096), (3, 8, 65536), (8, 8, 1),
                    (3, 8, 1 << 20), (12, 12, 33)]:
        mat = rng.integers(0, 256, (r, q), dtype=np.uint8)
        shards = rng.integers(0, 256, (q, s), dtype=np.uint8)
        got = _native.gf8_apply(mat, shards)
        _require(np.array_equal(got, gf.apply_matrix_ref(mat, shards)), ("gf8_apply", r, q, s))
    for n in [0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 4096, 16384, 100000]:
        d = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        _require(_native.blake3(d) == py_blake3(d), ("blake3", n))
    for rows, length in [(17, 3072), (64, 4096)]:  # the second splits across threads
        batch = rng.integers(0, 256, (rows, length), dtype=np.uint8)
        got = _native.blake3_batch(batch)
        for i in range(rows):
            _require(bytes(got[i]) == py_blake3(bytes(batch[i])), ("blake3_batch", rows, length, i))
    print("gf8_apply and blake3 agree with the oracles", flush=True)


def _kvlog_model(binding, tmp: str) -> None:
    """Seeded inserts and removes against a dict, a compaction, then a
    reopen over a torn tail of garbage."""
    import random

    from ..db.native_engine import NativeDb

    path = os.path.join(tmp, "model.log")
    db = NativeDb(path, fsync=False, binding=binding)
    t = db.open_tree("t")
    model: dict[bytes, bytes] = {}
    r = random.Random(7)
    for _ in range(4000):
        k = bytes([r.randrange(64)]) * r.randrange(1, 40)
        if r.random() < 0.7:
            v = r.randbytes(r.randrange(0, 300))
            t.insert(k, v)
            model[k] = v
        else:
            t.remove(k)
            model.pop(k, None)
    _require(dict(t.iter_range()) == model, "kvlog rows differ from the model")
    _require(len(t) == len(model), "kvlog length differs from the model")
    db.kv.compact(db.h)
    _require(dict(t.iter_range()) == model, "kvlog rows differ after a compaction")
    db.close()
    with open(path, "ab") as f:
        f.write(r.randbytes(37))
    db2 = NativeDb(path, fsync=False, binding=binding)
    _require(dict(db2.open_tree("t").iter_range()) == model, "kvlog rows differ after a torn tail")
    db2.close()
    print("kvlog model sequence, compaction and torn-tail reopen clean", flush=True)


def _group_commit(binding, tmp: str, mode: str) -> None:
    """The flusher thread races this thread's commits, barriers and
    compactions; then a reopen."""
    import random

    from ..db.native_engine import NativeDb

    n, keys, barrier_every, compact_every = (
        (20000, 1024, 500, 2000) if mode == "tsan" else (2000, 256, 1000, 1000))
    r = random.Random(11)
    path = os.path.join(tmp, "group.log")
    db = NativeDb(path, fsync="group", binding=binding)
    t = db.open_tree("g")
    for i in range(n):
        t.insert(b"gk%05d" % (i % keys), r.randbytes(64))
        if i % barrier_every == barrier_every - 1:
            db.sync_barrier()
        if i % compact_every == compact_every - 1:
            db.kv.compact(db.h)
    db.sync_barrier()
    _require(db.kv.sync_failures(db.h) == 0, "group commit: a sync failed")
    _require(len(t) == keys, "group commit: rows lost")
    db.close()
    db2 = NativeDb(path, fsync="group", binding=binding)
    _require(len(db2.open_tree("g")) == keys, "group commit: rows lost on reopen")
    db2.close()
    print(f"{mode}: kvlog group-commit smoke clean", flush=True)


def child(mode: str, so: str) -> int:
    import ctypes
    import tempfile

    import numpy as np

    from ..db.native_engine import _CtypesBinding

    # the tool's own build replaces the loader's cached library, so the
    # wrappers (`_native.gf8_apply`, ...) call into the sanitized code
    with _native._lock:
        _native._lib = _native._declare(ctypes.CDLL(so))
    binding = _CtypesBinding(_native.lib())
    tmp = tempfile.mkdtemp(prefix=f"sanitize-{mode}-", dir=OUT_DIR)
    try:
        _oracle_checks(np.random.default_rng(0))
        _kvlog_model(binding, tmp)
        _group_commit(binding, tmp, mode)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _require("torch" not in sys.modules, "the sanitized child imported torch")
    print(f"{mode}: sanitized native library clean ({so})", flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"] and len(argv) == 3:
        return child(argv[1], argv[2])
    if argv == ["--all"]:
        return run_all()
    if len(argv) == 1 and argv[0].lstrip("-") in MODES:
        return run_mode(argv[0].lstrip("-"))
    print(__doc__.split("\n\n")[1], file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
