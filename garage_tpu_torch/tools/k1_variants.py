#!/usr/bin/env python3
"""Compare variants of kernel K1 (csrc/gf_bitplane.cu) on one CUDA card.

    python -m garage_tpu_torch.tools.k1_variants

Each variant is the kernel source with one named constant or condition
replaced: the rows kept in flight (kAhead) or the register cap that
sets how many blocks an SM holds.  The "probe_" variants time parts of
the kernel instead: without the table reads, and with loads, XOR,
transposes and stores only.
All variants are built together, one nvcc each, into build/k1-variants/,
checked against `gf_bitmatmul` at every shape (0 mismatches, else the
tool exits non-zero; probes excepted) and timed at the shapes `chip_smoke.py` uses for K1:

  eager_ms  CUDA events around 50 calls of the entry, as chip_smoke.py
            times the kernel; at small shapes this is the host's call rate
  graph_ms  CUDA events around one replay of a CUDA graph that holds 50
            launches: the card's time per launch, without the host

Prints the card line from nvidia-smi, one line per (variant, shape) and
a JSON object with every number.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from garage_tpu_torch.ops import _build, gf
from garage_tpu_torch.ops.ec_cuda import gf_bitmatmul
from garage_tpu_torch.tools.timing import graph_ms, time_ms

SOURCE = _build.CSRC / "gf_bitplane.cu"
OUT_DIR = _build.BUILD_DIR.parent / "k1-variants"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, at the 700 W limit

LOOKUP = """\
      const E a = *reinterpret_cast<const E*>(tabs + __byte_perm(lo, base, 0x7650u + c));
      const E b = *reinterpret_cast<const E*>(tabs + __byte_perm(hi, base, 0x7650u + c));
"""

# name -> [(text in the source, replacement)].  A "probe_" variant computes
# something else on purpose, to time a part of the kernel: its mismatches
# are printed, not failed.
VARIANTS = {
    "base": [],
    "ahead4": [("constexpr int kAhead = 2;", "constexpr int kAhead = 4;")],
    "ahead8": [("constexpr int kAhead = 2;", "constexpr int kAhead = 8;")],
    "minblocks3": [("W == 4 ? 4 : 2;", "W == 4 ? 3 : 2;")],
    "w8_minblocks3": [("W == 4 ? 4 : 2;", "W == 4 ? 4 : 3;")],
    # the offsets are made and XORed in, but no table is read
    "probe_no_lds": [(LOOKUP, """\
      const uint32_t pa[2] = {__byte_perm(lo, base, 0x7650u + c), 0u};
      const uint32_t pb[2] = {__byte_perm(hi, base, 0x7650u + c), 0u};
      E a, b;
      set_basis(a, pa);
      set_basis(b, pb);
""")],
    # loads, XOR, transposes and stores only: the kernel's memory floor
    "probe_copy": [(LOOKUP, """\
      const uint32_t pa[2] = {ws[k], 0u};
      E a, b;
      set_basis(a, pa);
      set_zero(b);
""")],
}


def shapes() -> list[tuple[str, int, int, np.ndarray]]:
    """(name, B, S, (8r, 8q) bit-matrix): chip_smoke.py's K1 shapes."""
    rng = np.random.default_rng(0)
    enc = lambda k, m: gf.bitmatrix_of(gf.cauchy_parity_matrix(k, m))  # noqa: E731
    return [
        ("ec83_encode", 64, 131072, enc(8, 3)),
        ("ec164_encode", 64, 65536, enc(16, 4)),
        ("ec126_encode", 16, 65536, enc(12, 6)),
        ("ec2012_encode", 8, 65536, enc(20, 12)),
        ("q1_arbitrary", 64, 65536, rng.integers(0, 2, (40, 8), dtype=np.uint8)),
        ("ec83_ragged", 8, 4160, enc(8, 3)),
    ]


def build(names) -> dict[str, ctypes.CDLL]:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name]:
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
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {name}: {regs}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        lib.gf_bitplane_apply.argtypes = _build.SIGNATURES["gf_bitplane"]["gf_bitplane_apply"]
        lib.gf_bitplane_apply.restype = ctypes.c_int
        libs[name] = lib
    return libs


def apply(lib, bm: torch.Tensor, x: torch.Tensor, out: torch.Tensor) -> None:
    code = lib.gf_bitplane_apply(
        x.device.index, bm.data_ptr(), bm.shape[0] // 8, x.shape[1],
        x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(), out.stride(0), out.stride(1),
        x.shape[0], x.shape[2], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "gf_bitplane_apply")


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card)
    libs = build(list(VARIANTS))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results, bad = [], 0
    for shape, b, s, bm_np in shapes():
        bm = torch.from_numpy(bm_np).to(dev)
        r, q = bm.shape[0] // 8, bm.shape[1] // 8
        x = torch.randint(0, 256, (b, q, s), dtype=torch.uint8, device=dev, generator=gen)
        want = gf_bitmatmul(bm, x)
        bound = (b * q * s + b * r * s + bm.numel()) / HBM_BYTES_PER_S * 1e3
        for name, lib in libs.items():
            out = torch.empty((b, r, s), dtype=torch.uint8, device=dev)
            apply(lib, bm, x, out)
            torch.cuda.synchronize()
            mism = int((out != want).sum())
            bad += mism != 0 and not name.startswith("probe_")
            fn = lambda: apply(lib, bm, x, out)  # noqa: E731
            row = {"variant": name, "shape": shape, "mismatches": mism, "bound_ms": bound,
                   "eager_ms": time_ms(fn, 50), "graph_ms": graph_ms(fn, 50)}
            results.append(row)
            print(f"{shape:14s} {name:14s} mismatches={mism} eager_ms={row['eager_ms']:.6f} "
                  f"graph_ms={row['graph_ms']:.6f} bound_ms={bound:.6f} "
                  f"graph_share={bound / row['graph_ms']:.4f}")
    print(json.dumps({"card": card, "results": results}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
