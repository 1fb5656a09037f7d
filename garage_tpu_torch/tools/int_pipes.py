#!/usr/bin/env python3
"""Throughput of the int32 instructions of BLAKE3 on one CUDA card.

    python -m garage_tpu_torch.tools.int_pipes

Builds tools/int_pipes.cu into build/int-pipes/, prints each kernel's
SASS opcode counts, then times each kind (one instruction repeated, or
two interleaved) over 8 blocks of 256 threads per SM with CUDA events,
and prints thread-instructions per SM per clock at the card's maximum SM
clock: 64 means one 16-lane pipe per SM sub-partition kept busy, 128 two
pipes issuing side by side.  The "2" kinds read two registers that change
every step (another chain's word), as BLAKE3's XORs and adds do; the
others read loop-invariant operands besides their own chain's word.
These rates are what kernel K2's bound (tools/k2_compare.py
`blake3_bound_ms`) must assume.  Prints the card
line from nvidia-smi and a JSON object with every number.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from garage_tpu_torch.ops import _build
from garage_tpu_torch.tools.sass import all_functions

SOURCE = Path(__file__).resolve().parent / "int_pipes.cu"
OUT = _build.BUILD_DIR.parent / "int-pipes" / "int_pipes.so"
# (name, instructions per chain step) in the order of int_pipes_run's kinds
KINDS = [("lop3", 2), ("shf", 2), ("prmt", 2), ("imad", 2), ("add", 4),
         ("lop3+imad", 2), ("shf+imad", 2), ("lop3+shf", 2), ("prmt+imad", 2),
         ("xor2+xor2", 2), ("add2+add2", 2), ("xor2+add2", 2)]
CHAINS, THREADS, BLOCKS_PER_SM, ITERS = 8, 256, 8, 4096


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("int_pipes: needs a CUDA card", file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(card)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT), str(SOURCE)],
                           capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    for name, counts in (all_functions(OUT) or {}).items():
        print(f"sass {name}: {json.dumps(counts)}")
    lib = ctypes.CDLL(str(OUT))
    lib.int_pipes_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.int_pipes_run.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for kind, (name, per_step) in enumerate(KINDS):
        def run():
            _build.check(lib.int_pipes_run(kind, blocks, ITERS, out.data_ptr(), stream),
                         "int_pipes_run")
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        instr = blocks * THREADS * ITERS * CHAINS * per_step
        rate = instr / (ms * 1e-3) / (sms * clock_hz)
        rows.append({"kind": name, "ms": ms, "thread_instr_per_sm_clock": rate})
        print(f"{name:10s} ms={ms:.6f} thread-instructions per SM per clock={rate:.2f}")
    print(json.dumps({"card": card, "clock_hz": clock_hz, "sms": sms, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
