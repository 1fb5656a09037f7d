#!/usr/bin/env python3
"""Memory and synchronisation checks of the port's two hand-written
kernels, K1 (csrc/gf_bitplane.cu) and K2 (csrc/blake3.cu), on every path
the main path takes.

    python3 -m garage_tpu_torch.tools.sanitize_cuda

Both checks run `tools/verify.py`'s case list (`verify.CASES`, each case
held against the oracles) in child processes on card 0, with the kernels
as `ops/_build.py` builds them and no CUDA graph.

1. compute-sanitizer, found as `_build._nvcc` finds nvcc, under each of
   its four tools:

     memcheck   every pointer and stride the wrappers pass: out-of-bounds
                and misaligned global accesses; every case
     racecheck  K1's shared-memory tables (built in two loops, each
                ending in a barrier); the light cases
     synccheck  K2's `__shfl_sync` and `__syncwarp` after early returns,
                K1's barriers; every case
     initcheck  reads of global memory never written: K2's scratch and
                arrival counters, every `out=` buffer; the light cases

   Each child runs with `PYTORCH_NO_CUDA_MEMORY_CACHING=1` (every tensor
   a `cudaMalloc` of its own, so memcheck knows where it ends: the caching
   allocator cuts tensors out of larger segments, where a read past the
   end returns a neighbour's bytes without a fault), restricted to the
   port's kernels by the tool's kernel-name filter, with a non-zero
   `--error-exitcode`.  First, the canary (tools/sanitizer_canary.cu)
   reads one byte past the end of a tensor of odd length under memcheck
   with the same environment and filter: memcheck must report an invalid
   `__global__` read, or no run can be trusted.  A card the tool cannot
   attach to ("Device not supported") is reported as such and the four
   runs are not made.

2. The guard-page allocator (tools/guard_alloc.cu, installed with
   `torch.cuda.memory.CUDAPluggableAllocator`), which needs no tool: every
   tensor of the child, scratch and outputs included, is laid against a
   granule that is never mapped, after its end in one run (poison byte
   0xA5) and before its start in another (0x5A); fresh memory holds the
   poison, and the mapped bytes outside each tensor must still hold it
   when it is freed.  An access past either end faults; a write into the
   padding is counted; an output that read memory nobody wrote differs
   from the oracle.  Its canary reads the first guard byte after, then
   before, a tensor, and the card must fault.

racecheck's and synccheck's kind of check where the card has no tool is
tools/cuda_on_host.py, which needs no card.

Every child must report launches (the change of each wrapper's
`cuda_kernel_launches_total`, given to the kernel the case's shape
selects) of K1's two table widths and K2's two kernels, and every case
must be bit-exact.  A report, a fault outside the canary, a violation, a
timeout, a missing summary, a mismatch or a kernel with no launch fails
the run, and this script exits 1.  The children run side by side on
the card.  It prints one `sanitizer:` line per run.
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
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

from ..ops import _build

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# the tools that run the light cases only (shared-memory and
# initialisation tracking cost the most per access)
LIGHT_TOOLS = ("racecheck", "initcheck")
ERROR_EXITCODE = 86
# the tool's kernel-name filter (a substring of the mangled name; the
# option may repeat), and the substrings it keeps: no other kernel is
# checked
KERNEL_FILTER_OPTION = "--kernel-name"
KERNEL_FILTERS = ("gf_bitplane_kernel", "blake3_small_kernel", "blake3_warp_kernel",
                  "sanitizer_canary_kernel")
UNSUPPORTED = "Device not supported"
TOOL_TIMEOUT_S = {"memcheck": 300, "racecheck": 300, "synccheck": 300, "initcheck": 300}
CANARY_TIMEOUT_S = 120
GUARD_TIMEOUT_S = 300
# (mode, poison byte): the guard after the end, then before the start
GUARD_RUNS = (("after", 0xA5), ("before", 0x5A))
TOOLS_DIR = Path(__file__).resolve().parent
OUT_DIR = _build.BUILD_DIR.parent / "sanitize-cuda"
CANARY_LEN = 4097  # odd: no allocation granularity hides the byte past the end


class SanitizerFailure(RuntimeError):
    """A check reported, faulted, timed out, printed no summary, or saw no launch."""


def compute_sanitizer() -> str:
    """compute-sanitizer, found as `_build._nvcc` finds nvcc: PATH, then
    CUDA_HOME (or CUDA_PATH), then /usr/local/cuda."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "compute-sanitizer"
    if cand.exists():
        return str(cand)
    raise SanitizerFailure("compute-sanitizer not found (PATH, CUDA_HOME, /usr/local/cuda)")


def sanitizer_env(base: dict | None = None) -> dict:
    """A child's environment: the caching allocator off, and this
    checkout first on the import path."""
    env = dict(os.environ if base is None else base)
    env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    repo = str(TOOLS_DIR.parents[1])
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def child_command(child_args: list[str]) -> list[str]:
    return [sys.executable, "-m", "garage_tpu_torch.tools.sanitize_cuda", *child_args]


def sanitizer_command(tool: str, child_args: list[str], exe: str | None = None) -> list[str]:
    """compute-sanitizer `tool` over the child `child_args`, restricted
    to the port's kernels, exiting ERROR_EXITCODE on any report."""
    if tool not in TOOLS:
        raise ValueError(f"unknown tool {tool!r}")
    filters = []
    for name in KERNEL_FILTERS:
        filters += [KERNEL_FILTER_OPTION, f"kns={name}"]
    return [exe or compute_sanitizer(), "--tool", tool, "--error-exitcode",
            str(ERROR_EXITCODE), *filters, *child_command(child_args)]


# --- reading a run --------------------------------------------------------------

_ERROR_SUMMARY = re.compile(r"ERROR SUMMARY: (\d+) errors?")
_RACE_SUMMARY = re.compile(r"RACECHECK SUMMARY: \d+ hazards? displayed \((\d+) errors?, "
                           r"(\d+) warnings?\)")
_LAUNCHES = re.compile(r"^launches: (\{.*\})$", re.M)
_GUARD = re.compile(r"^guard: (\{.*\})$", re.M)
_FAULT = "an illegal memory access was encountered"


@dataclass
class ToolRun:
    tool: str
    rc: int | None  # None: timed out
    output: str
    wall_s: float
    errors: int | None = None  # None: no summary
    launches: dict = field(default_factory=dict)

    def __post_init__(self):
        self.errors = parse_errors(self.output)
        found = _LAUNCHES.findall(self.output)
        self.launches = json.loads(found[-1]) if found else {}

    @property
    def unsupported(self) -> bool:
        """compute-sanitizer could not attach to the card."""
        return UNSUPPORTED in self.output


def parse_errors(text: str) -> int | None:
    """Errors compute-sanitizer reported in `text`: the sum of its
    summary lines (racecheck's errors and warnings both count), or None
    when there is no summary."""
    found = None
    for m in _ERROR_SUMMARY.finditer(text):
        found = (found or 0) + int(m.group(1))
    for m in _RACE_SUMMARY.finditer(text):
        found = (found or 0) + int(m.group(1)) + int(m.group(2))
    return found


def _tail(run: ToolRun, n: int = 4000) -> str:
    return run.output[-n:]


def check_launches(run: ToolRun, kernels) -> None:
    missing = [k for k in kernels if run.launches.get(k, 0) <= 0]
    if missing:
        raise SanitizerFailure(f"{run.tool}: no launch of {missing} in the child "
                               f"(launches {run.launches})")


def check_tool_run(run: ToolRun, kernels) -> None:
    """Raise SanitizerFailure unless `run` ended clean: exit code 0, a
    summary with 0 errors, and launches of every kernel in `kernels`."""
    if run.rc is None:
        raise SanitizerFailure(f"{run.tool}: timed out after {run.wall_s:.0f} s")
    if run.errors is None:
        raise SanitizerFailure(f"{run.tool}: no summary in its output (rc {run.rc}):\n"
                               f"{_tail(run)}")
    if run.errors or run.rc != 0:
        raise SanitizerFailure(f"{run.tool}: {run.errors} errors, rc {run.rc}:\n{_tail(run)}")
    check_launches(run, kernels)


def check_canary_run(run: ToolRun) -> None:
    """Raise SanitizerFailure unless memcheck caught the canary's read
    one byte past the end of its tensor."""
    if run.rc is None:
        raise SanitizerFailure(f"canary: timed out after {run.wall_s:.0f} s")
    if run.rc == 0 or not run.errors or "Invalid __global__ read" not in run.output:
        raise SanitizerFailure(
            "canary: memcheck did not report the read past the end of the tensor "
            f"(rc {run.rc}, errors {run.errors}): the caching allocator is on or the "
            f"kernel filter matches nothing, so no tool run can be trusted:\n{_tail(run)}")


def guard_stats(run: ToolRun) -> dict | None:
    found = _GUARD.findall(run.output)
    return json.loads(found[-1]) if found else None


def check_guard_run(run: ToolRun, kernels) -> dict:
    """Raise SanitizerFailure unless a guard-allocator child ended clean:
    exit code 0, its allocator used and never violated, no fault, and
    launches of every kernel in `kernels`.  Returns its stats."""
    if run.rc is None:
        raise SanitizerFailure(f"{run.tool}: timed out after {run.wall_s:.0f} s")
    stats = guard_stats(run)
    if run.rc != 0 or stats is None or _FAULT in run.output:
        raise SanitizerFailure(f"{run.tool}: rc {run.rc}:\n{_tail(run)}")
    if stats["violations"] or stats["failed_allocs"] or stats["allocs"] <= 0:
        raise SanitizerFailure(f"{run.tool}: guard allocator {stats}:\n{_tail(run)}")
    check_launches(run, kernels)
    return stats


def check_guard_canary(run: ToolRun) -> None:
    """Raise SanitizerFailure unless the canary's read of a guard byte
    faulted on the card."""
    if run.rc is None:
        raise SanitizerFailure(f"{run.tool}: timed out after {run.wall_s:.0f} s")
    stats = guard_stats(run)
    if _FAULT not in run.output or stats is None or stats["allocs"] <= 0:
        raise SanitizerFailure(f"{run.tool}: the read of a guard byte did not fault, so "
                               f"no guarded run can be trusted:\n{_tail(run)}")


# --- running the children ---------------------------------------------------------


def _run(name: str, cmd: list[str], timeout: float) -> ToolRun:
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, env=sanitizer_env(), capture_output=True, text=True,
                              timeout=timeout)
        rc, output = proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as e:
        rc = None
        output = "".join(x.decode() if isinstance(x, bytes) else (x or "")
                         for x in (e.stdout, e.stderr))
    return ToolRun(name, rc, output, time.perf_counter() - t0)


def build_tool_library(source: str) -> Path:
    """nvcc tools/<source> with the kernels' flags into build/sanitize-cuda/."""
    src = TOOLS_DIR / source
    out = OUT_DIR / (Path(source).stem + ".so")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise _build.KernelBuildError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    return out


def _line(run: ToolRun, what: str, card: str) -> str:
    return f"sanitizer: {run.tool} {what} wall_s={run.wall_s:.3f} on {card}"


def run_all(card: str, out=print) -> dict:
    """The compute-sanitizer runs (after their canary) and the guard-page
    runs (after theirs), the children started together; one `sanitizer:`
    line each.  Returns {run: {...}}, with "compute_sanitizer" saying
    whether the tool could attach to the card; raises SanitizerFailure
    on the first run that is not clean, once every child has ended."""
    from . import verify

    _build.build_all(["gf_bitplane", "blake3"])
    canary_so = build_tool_library("sanitizer_canary.cu")
    guard_so = build_tool_library("guard_alloc.cu")
    exe = compute_sanitizer()
    version = subprocess.run([exe, "--version"], capture_output=True, text=True).stdout
    version = next((ln for ln in version.splitlines() if ln.startswith("Version")), "?")
    res: dict = {"compute_sanitizer": {"path": exe, "version": version}}
    with ThreadPoolExecutor(max_workers=1 + 2 * len(GUARD_RUNS)) as pool:
        canary_run = pool.submit(_run, "memcheck canary", sanitizer_command(
            "memcheck", ["--canary", str(canary_so), str(CANARY_LEN)]), CANARY_TIMEOUT_S)
        guarded = {}
        for mode, poison in GUARD_RUNS:
            at = str(CANARY_LEN + (-CANARY_LEN) % 16 if mode == "after" else -1)
            guarded[mode] = (at, pool.submit(_run, f"guard-{mode} canary", child_command(
                ["--guard-canary", str(guard_so), mode, str(canary_so), at]),
                CANARY_TIMEOUT_S), pool.submit(_run, f"guard-{mode}", child_command(
                    ["--guard", str(guard_so), mode, str(poison)]), GUARD_TIMEOUT_S))

        canary = canary_run.result()
        if canary.unsupported:
            res["compute_sanitizer"]["supported"] = False
            out(_line(canary, f"{exe} ({version}): '{UNSUPPORTED}' on this card; its four "
                              f"tools cannot run here", card))
        else:
            check_canary_run(canary)
            res["compute_sanitizer"]["supported"] = True
            out(_line(canary, f"errors={canary.errors} rc={canary.rc} (the read past the "
                              f"end reported)", card))
            for tool in TOOLS:
                run = _run(tool, sanitizer_command(tool, ["--child", tool]),
                           TOOL_TIMEOUT_S[tool])
                check_tool_run(run, verify.KERNELS)
                out(_line(run, f"errors={run.errors} launches={json.dumps(run.launches)}",
                          card))
                res[tool] = {"errors": run.errors, "launches": run.launches,
                             "wall_s": run.wall_s}

        for mode, poison in GUARD_RUNS:
            at, canary_f, run_f = guarded[mode]
            run = canary_f.result()
            check_guard_canary(run)
            out(_line(run, f"read of x[{at}] faulted ({_FAULT})", card))
            run = run_f.result()
            stats = check_guard_run(run, verify.KERNELS)
            out(_line(run, f"poison=0x{poison:02X} violations={stats['violations']} "
                           f"allocs={stats['allocs']} launches={json.dumps(run.launches)}",
                      card))
            res[f"guard_{mode}"] = {"violations": stats["violations"], "poison": poison,
                                    "allocs": stats["allocs"], "launches": run.launches,
                                    "wall_s": run.wall_s}
    return res


def sanitized_field(res: dict) -> dict:
    """Each run's errors for the kernels line: None for a compute-sanitizer
    tool that could not run on this card."""
    field_ = {tool: res[tool]["errors"] if tool in res else None for tool in TOOLS}
    if not res["compute_sanitizer"]["supported"]:
        field_["compute_sanitizer"] = UNSUPPORTED
    for mode, _poison in GUARD_RUNS:
        field_[f"guard_{mode}"] = res[f"guard_{mode}"]["violations"]
    return field_


# --- the children ---------------------------------------------------------------


def _install_guard(guard_so: str, mode: str, poison: int) -> ctypes.CDLL:
    """Make the guard-page allocator the child's CUDA allocator, before
    any tensor is made on the card."""
    import torch

    lib = ctypes.CDLL(guard_so)
    lib.guard_configure.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.guard_configure.restype = None
    lib.guard_stats.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.guard_stats.restype = None
    lib.guard_configure(1 if mode == "before" else 0, poison)
    alloc = torch.cuda.memory.CUDAPluggableAllocator(guard_so, "guard_malloc", "guard_free")
    torch.cuda.memory.change_current_allocator(alloc)
    return lib


def _print_guard(lib: ctypes.CDLL) -> None:
    vals = (ctypes.c_longlong * 7)()
    lib.guard_stats(vals)
    keys = ("allocs", "frees", "violations", "failed_allocs", "bytes_live", "bytes_peak",
            "last_error")
    print(f"guard: {json.dumps(dict(zip(keys, list(vals))))}", flush=True)


def child(tool: str, guard: ctypes.CDLL | None = None) -> int:
    """The case list on card 0, as a checked run sees it."""
    import torch

    from . import verify

    if not torch.cuda.is_available():
        print("sanitize_cuda: needs a CUDA card", file=sys.stderr)
        return 1
    if guard is None and os.environ.get("PYTORCH_NO_CUDA_MEMORY_CACHING") != "1":
        print("sanitize_cuda: the caching allocator is on", file=sys.stderr)
        return 1
    cases = [c for c in verify.CASES if not (tool in LIGHT_TOOLS and c.heavy)]
    fails, launches = verify.run_cases(torch.device("cuda", 0), cases)
    print(f"launches: {json.dumps(launches)}")
    print(f"cases: {len(cases)} failures={fails}", flush=True)
    if guard is not None:
        import gc

        gc.collect()  # free what the cases made, so the allocator checks its padding
        _print_guard(guard)
    return 1 if fails else 0


def canary(so: str, at: int, guard: ctypes.CDLL | None = None) -> int:
    """One launch of the canary on a tensor of CANARY_LEN bytes, reading
    x[at]."""
    import torch

    lib = ctypes.CDLL(so)
    lib.sanitizer_canary.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.sanitizer_canary.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    x = torch.ones(CANARY_LEN, dtype=torch.uint8, device=dev)
    out = torch.zeros(1, dtype=torch.uint8, device=dev)
    if guard is not None:
        _print_guard(guard)
    code = lib.sanitizer_canary(x.data_ptr(), at, out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    print(f"canary: launch code {code}", flush=True)
    # the bad read stops the kernel and the context reports an error here:
    # the checker's report, or the fault's message, is the result
    try:
        torch.cuda.synchronize(dev)
    except RuntimeError as e:
        print(f"canary: synchronize raised {e}", flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"] and len(argv) == 2:
        return child(argv[1])
    if argv[:1] == ["--canary"] and len(argv) == 3:
        return canary(argv[1], int(argv[2]))
    if argv[:1] == ["--guard"] and len(argv) == 4:
        return child("guard", _install_guard(argv[1], argv[2], int(argv[3])))
    if argv[:1] == ["--guard-canary"] and len(argv) == 5:
        return canary(argv[3], int(argv[4]), _install_guard(argv[1], argv[2], 0xA5))
    import torch

    if not torch.cuda.is_available():
        print("sanitize_cuda: needs a CUDA card", file=sys.stderr)
        return 1
    from .. import _native

    _native.build()  # the host library the oracles use, built outside the checks
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    try:
        res = run_all(card)
    except SanitizerFailure as e:
        print(f"sanitizer: FAILED: {e}")
        return 1
    print(f"sanitizer: clean {json.dumps(sanitized_field(res))}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
