#!/usr/bin/env python3
"""Bit-exactness of the port's coding and hashing against independent
oracles, on the card (the port's counterpart of script/tpu_verify.py).

    python3 -m garage_tpu_torch.tools.verify               # on CUDA card 0
    python3 -m garage_tpu_torch.tools.verify --device cpu  # the plain versions

The oracles share no code with the kernels or their plain versions: the
numpy GF(2^8) LUT codec (`ops/gf.py::apply_matrix` on (B, q, S) arrays,
which is `apply_matrix_ref`: table gathers, no bit-planes) and, for
BLAKE3, the host library (`_native.blake3_batch`, C++) on every row and
the pure-Python `ops/blake3_ref.py` on the last row of each case.  The
checks, one line each:

  encode    (k, m) in {(8,3), (4,2), (16,4)} x S in {128, 4096, 131072},
            B = 4, through K1 (`gf_bitmatmul_cuda`) and its plain version
            (`gf_bitmatmul`): 18 checks
  repair    every single-rank erasure of EC(8,3) (8 data, 3 parity) and
            [0, 1, 2], S = 16384, B = 2, through `EcCuda.reconstruct` (the
            path of degraded GETs and repair), against the original
            pieces: 12 checks
  pipeline  `ScrubRepairPipeline(8, 3, 131072)` parity: 1 check
  cases     every case of `CASES`, the shapes that reach each path of
            the two kernels (K1's table widths, vector and byte paths,
            strided output; K2's two kernels, rows sharing a warp with a
            part-empty last warp, rows of 32 and of 64 subtrees, two
            strided sources) and of K3, K5 and K6

then `ALL-OK`, or `FAILURES=n` and exit code 1.  Inputs are numpy arrays
from fixed seeds.  On the card the kernels launch as the main path
launches them; with `--device cpu` every wrapper runs its plain version.

`run_cases` runs `CASES` alone and returns each kernel's launches; it is
what tools/sanitize_cuda.py runs under compute-sanitizer.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import _native
from ..models.pipeline import ScrubRepairPipeline
from ..ops import _build, gf
from ..ops.blake3_ref import blake3 as py_blake3
from ..ops.ec_cuda import EcCuda, gf_bitmatmul, gf_bitmatmul_cuda, resolve_device
from ..ops.hash_cuda import blake3_batch, blake3_pieces
from ..ops.telemetry import runs_on_host
from ..parallel.mesh import make_mesh

SEED = 42
ENCODE_GEOMETRIES = [(8, 3), (4, 2), (16, 4)]
ENCODE_SIZES = (128, 4096, 131072)
ENCODE_BATCH = 4
IMPLS: dict[str, Callable] = {"kernel": gf_bitmatmul_cuda, "plain": gf_bitmatmul}
REPAIR_K, REPAIR_M, REPAIR_S, REPAIR_BATCH = 8, 3, 16384, 2
REPAIR_LOST = [[i] for i in range(REPAIR_K + REPAIR_M)] + [[0, 1, 2]]
PIPELINE_K, PIPELINE_M, PIPELINE_S, PIPELINE_BATCH = 8, 3, 131072, 2
MESH_ENTRIES = 4

# the kernels' names as compute-sanitizer and the PTX name them
K1_KERNELS = {4: "gf_bitplane_kernel<4>", 8: "gf_bitplane_kernel<8>"}
K2_SMALL, K2_WARP = "blake3_small_kernel", "blake3_warp_kernel"
KERNELS = (K1_KERNELS[4], K1_KERNELS[8], K2_SMALL, K2_WARP)


# --- the paths of the kernels, from the shapes -----------------------------------


def k1_width(r: int) -> int:
    """Bytes per table entry K1 takes for r output rows (csrc/gf_bitplane.cu:
    W = 4 for r <= 4, else 8)."""
    return 4 if r <= 4 else 8


def k2_kernel(length: int) -> str:
    return K2_SMALL if length <= 1024 else K2_WARP


def k2_lanes_per_row(length: int) -> int:
    """Lanes of a warp that hash one row in K2's warp kernel."""
    return min(length // 1024, 32)


def k2_subtrees(length: int) -> int:
    """Warps (32-chunk subtrees) per row in K2's warp kernel; above 1 the
    row's last warp reduces the others' CVs from scratch, above 32 in
    place, in groups of 32."""
    chunks = length // 1024
    return chunks // 32 if chunks > 32 else 1


def k2_part_empty_warp(rows: int, length: int) -> bool:
    """Rows share a warp and the last warp holds fewer rows than it could:
    its spare lanes hash a real row and store nothing."""
    if k2_kernel(length) != K2_WARP or k2_subtrees(length) > 1:
        return False
    per_warp = 32 // k2_lanes_per_row(length)
    return per_warp > 1 and rows % per_warp != 0


@dataclass(frozen=True)
class Case:
    """One shape that reaches a path.  kind: "k1" (the kernel on a GF
    coding matrix), "repair" (every EC(k, m) erasure through
    `EcCuda.reconstruct`), "k2" (`blake3_batch` on b rows of s bytes),
    "pieces" (`blake3_pieces` on two strided views), "k3"
    (`EcCuda.encode_and_hash`), "k5" (the pipeline's fwd, eager) and
    "k6" (`EcCuda.encode` over a 4-entry mesh on one device).  For the
    coding kinds k data shards and m output rows.  K1's input is a view
    of rows of `offset + s + row_pad` bytes starting at `offset` (a
    nonzero offset takes it off 16-byte alignment), its output a view of
    rows of `s + row_pad` bytes: with a row_pad that aligns the strides,
    a ragged S keeps the 16-byte path open up to its tail.
    `strided_out` writes the output into the parity half of one
    (b, k+m, s + row_pad) buffer.  `heavy` cases (1 MiB blocks) stay out
    of the racecheck and initcheck runs."""

    name: str
    kind: str
    b: int
    s: int
    k: int = 0
    m: int = 0
    offset: int = 0
    row_pad: int = 0
    strided_out: bool = False
    heavy: bool = False

    def k1_rows(self) -> list[int]:
        """The r of each K1 launch of this case (empty: no K1)."""
        if self.kind == "repair":
            return sorted({len(lost) for lost in lost_patterns(self.k, self.m)})
        return [self.m] if self.kind in ("k1", "k3", "k5", "k6") else []

    def hash_len(self) -> int | None:
        """The row length of this case's K2 launches (None: no K2)."""
        return self.s if self.kind in ("k2", "pieces", "k3", "k5") else None

    def k1_strides(self) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
        """(base offset, batch stride, row stride) in bytes of K1's input
        and output views."""
        row, out_row = self.offset + self.s + self.row_pad, self.s + self.row_pad
        out = ((self.k * out_row, (self.k + self.m) * out_row, out_row) if self.strided_out
               else (0, self.m * out_row, out_row))
        return (self.offset, self.k * row, row), out

    def k1_vec(self) -> bool:
        """K1's 16-byte path is open: every base and stride of its input
        and output views is a multiple of 16 (allocations are)."""
        x, out = self.k1_strides()
        return all(v % 16 == 0 for v in x + out)

    def k1_byte_path(self) -> bool:
        """Some columns go through K1's byte path: the view is not aligned
        or S leaves a ragged tail of fewer than 16 columns."""
        return not self.k1_vec() or self.s % 16 != 0


def lost_patterns(k: int, m: int) -> list[list[int]]:
    """Every single-rank erasure, then the first m ranks at once."""
    return [[i] for i in range(k + m)] + [list(range(m))]


CASES = [
    Case("k1_w4_vec", "k1", b=2, s=16384, k=8, m=3),
    Case("k1_w4_byte_tail", "k1", b=3, s=4099, k=8, m=3),
    Case("k1_w4_vec_ragged_tail", "k1", b=2, s=4099, k=8, m=3, row_pad=13),
    Case("k1_w4_misaligned_view", "k1", b=2, s=4096, k=8, m=3, offset=1),
    Case("k1_w4_strided_out", "k1", b=2, s=4096, k=8, m=3, strided_out=True),
    Case("k1_w4_ec16_4", "k1", b=2, s=4096, k=16, m=4),
    Case("k1_w8_one_group", "k1", b=2, s=4096, k=6, m=6),
    Case("k1_w8_two_groups_byte_tail", "k1", b=2, s=1000, k=12, m=12),
    Case("k1_w8_strided_out_misaligned", "k1", b=2, s=2051, k=4, m=6, offset=3,
         strided_out=True),
    Case("repair_every_erasure_ec8_3", "repair", b=2, s=4096, k=8, m=3),
    Case("k2_small_64", "k2", b=5, s=64),
    Case("k2_small_1024_two_blocks", "k2", b=130, s=1024),
    Case("k2_warp_lpr2_part_empty", "k2", b=17, s=2048),
    Case("k2_warp_lpr8_part_empty", "k2", b=5, s=8192),
    Case("k2_warp_one_subtree", "k2", b=3, s=32768),
    Case("k2_warp_2_subtrees", "k2", b=3, s=65536),
    Case("k2_warp_32_subtrees", "k2", b=2, s=1 << 20),
    Case("k2_warp_64_subtrees_in_place", "k2", b=1, s=2 << 20),
    Case("k2_pieces_two_sources", "pieces", b=3, s=4096, k=8, m=3),
    Case("k2_pieces_two_sources_subtrees", "pieces", b=2, s=65536, k=4, m=2),
    Case("k3_encode_hash_b1", "k3", b=1, s=131072, k=8, m=3, heavy=True),
    Case("k3_encode_hash_b3", "k3", b=3, s=131072, k=8, m=3, heavy=True),
    Case("k5_pipeline_eager", "k5", b=2, s=131072, k=8, m=3, heavy=True),
    Case("k6_mesh_4_entries", "k6", b=8, s=16384, k=8, m=3),
]


def digests_ok(got: np.ndarray, rows: np.ndarray) -> bool:
    """Every digest of (n, L) rows against the host library, the last
    row's against the pure-Python oracle too."""
    return (np.array_equal(got, _native.blake3_batch(np.ascontiguousarray(rows)))
            and bytes(got[-1]) == py_blake3(bytes(rows[-1])))


def _to(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


# --- the verify checks ----------------------------------------------------------


def encode_inputs(rng) -> list[tuple[int, int, int, np.ndarray]]:
    """(k, m, S, data (B, k, S)) for every encode check, drawn in order
    from `rng`."""
    return [(k, m, s, rng.integers(0, 256, (ENCODE_BATCH, k, s), dtype=np.uint8))
            for k, m in ENCODE_GEOMETRIES for s in ENCODE_SIZES]


def port_encode(k: int, m: int, data: np.ndarray, impl: str, dev) -> np.ndarray:
    bm = _to(gf.bitmatrix_of(gf.cauchy_parity_matrix(k, m)), dev)
    return IMPLS[impl](bm, _to(data, dev)).cpu().numpy()


def coded_pieces(rng, b: int, k: int, m: int, s: int) -> np.ndarray:
    """The (b, k+m, s) pieces of b EC(k, m) blocks of data drawn from
    `rng`, parity by the LUT oracle."""
    data = rng.integers(0, 256, (b, k, s), dtype=np.uint8)
    return np.concatenate([data, gf.apply_matrix(gf.cauchy_parity_matrix(k, m), data)], axis=1)


def port_repair(codec: EcCuda, full: np.ndarray, lost: list[int]) -> np.ndarray:
    """The lost pieces, rebuilt by `codec.reconstruct` from the first k
    survivors."""
    present = [i for i in range(full.shape[1]) if i not in lost][: codec.k]
    return codec.reconstruct(full[:, present], present, lost)


def verify(dev, out=print) -> int:
    """Every check on `dev`, one line each; returns the failures."""
    rng = np.random.default_rng(SEED)
    fails = 0

    def report(label: str, ok: bool) -> None:
        nonlocal fails
        out(f"{label}: {'OK' if ok else 'MISMATCH'}")
        fails += 0 if ok else 1

    for k, m, s, data in encode_inputs(rng):
        want = gf.apply_matrix(gf.cauchy_parity_matrix(k, m), data)
        for impl in IMPLS:
            report(f"encode k={k} m={m} s={s} impl={impl}",
                   np.array_equal(port_encode(k, m, data, impl, dev), want))
    full = coded_pieces(rng, REPAIR_BATCH, REPAIR_K, REPAIR_M, REPAIR_S)
    codec = EcCuda(REPAIR_K, REPAIR_M, device=dev)
    for lost in REPAIR_LOST:
        report(f"repair lost={lost}", np.array_equal(port_repair(codec, full, lost),
                                                     full[:, lost]))
    pipe = ScrubRepairPipeline(PIPELINE_K, PIPELINE_M, PIPELINE_S, device=dev)
    data = rng.integers(0, 256, (PIPELINE_BATCH, PIPELINE_K, PIPELINE_S), dtype=np.uint8)
    parity, _hashes, _stats = pipe.encode_and_hash_fn()(_to(data, dev))
    want = gf.apply_matrix(gf.cauchy_parity_matrix(PIPELINE_K, PIPELINE_M), data)
    report("pipeline parity", np.array_equal(parity.cpu().numpy(), want))
    for case in CASES:
        for label, ok in run_case(case, dev, np.random.default_rng([SEED, CASES.index(case)])):
            report(label, ok)
    out("ALL-OK" if fails == 0 else f"FAILURES={fails}")
    return fails


# --- the cases -----------------------------------------------------------------


def k1_views(c: Case, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's input and output views of a "k1" case (`Case.k1_strides`).
    The buffers are left unwritten: a kernel that read a byte outside its
    input view, or left one of its output unwritten, would show it."""
    buf = torch.empty((c.b, c.k, c.offset + c.s + c.row_pad), dtype=torch.uint8, device=dev)
    rows = c.k + c.m if c.strided_out else c.m
    obuf = torch.empty((c.b, rows, c.s + c.row_pad), dtype=torch.uint8, device=dev)
    return buf[:, :, c.offset:c.offset + c.s], obuf[:, rows - c.m:, :c.s]


def _k1_case(c: Case, dev, rng) -> list[tuple[str, bool]]:
    coding = gf.cauchy_parity_matrix(c.k, c.m)
    data = rng.integers(0, 256, (c.b, c.k, c.s), dtype=np.uint8)
    want = gf.apply_matrix(coding, data)
    x, out = k1_views(c, dev)
    x.copy_(_to(data, dev))
    # graft-lint: allow-recompile(each case is one exact shape that reaches one path of K1)
    got = gf_bitmatmul_cuda(_to(gf.bitmatrix_of(coding), dev), x, out=out)
    return [(f"case {c.name}", np.array_equal(got.cpu().numpy(), want))]


def _repair_case(c: Case, dev, rng) -> list[tuple[str, bool]]:
    full = coded_pieces(rng, c.b, c.k, c.m, c.s)
    codec = EcCuda(c.k, c.m, device=dev)
    return [(f"case {c.name} lost={lost}",
             np.array_equal(port_repair(codec, full, lost), full[:, lost]))
            for lost in lost_patterns(c.k, c.m)]


def _k2_case(c: Case, dev, rng) -> list[tuple[str, bool]]:
    rows = rng.integers(0, 256, (c.b, c.s), dtype=np.uint8)
    # graft-lint: allow-recompile(each case is one exact shape that reaches one path of K2)
    got = blake3_batch(_to(rows, dev)).cpu().numpy()
    return [(f"case {c.name}", digests_ok(got, rows))]


def _pieces_case(c: Case, dev, rng) -> list[tuple[str, bool]]:
    # data and parity as views of one buffer with a spare piece between them
    pieces = rng.integers(0, 256, (c.b, c.k + c.m + 1, c.s), dtype=np.uint8)
    buf = _to(pieces, dev)
    got = blake3_pieces(buf[:, : c.k], buf[:, c.k + 1:]).cpu().numpy()
    rows = np.delete(pieces, c.k, axis=1).reshape(-1, c.s)
    return [(f"case {c.name}", digests_ok(got.reshape(-1, 32), rows))]


def _coded_case(c: Case, dev, rng) -> list[tuple[str, bool]]:
    data = rng.integers(0, 256, (c.b, c.k, c.s), dtype=np.uint8)
    want = gf.apply_matrix(gf.cauchy_parity_matrix(c.k, c.m), data)
    if c.kind == "k6":
        mesh = make_mesh(devices=[resolve_device(dev)] * MESH_ENTRIES)
        parity = EcCuda(c.k, c.m, device=dev, mesh=mesh).encode(data)
        return [(f"case {c.name}", np.array_equal(parity, want))]
    if c.kind == "k3":
        parity, hashes = EcCuda(c.k, c.m, device=dev).encode_and_hash(data)
    else:  # k5
        pipe = ScrubRepairPipeline(c.k, c.m, c.s, device=dev)
        p, h, _stats = pipe.encode_and_hash_fn()(_to(data, dev))
        parity, hashes = p.cpu().numpy(), h.cpu().numpy()
    rows = np.concatenate([data, want], axis=1).reshape(-1, c.s)
    return [(f"case {c.name} parity", np.array_equal(parity, want)),
            (f"case {c.name} hashes", digests_ok(hashes.reshape(-1, 32), rows))]


RUNNERS = {"k1": _k1_case, "repair": _repair_case, "k2": _k2_case, "pieces": _pieces_case,
           "k3": _coded_case, "k5": _coded_case, "k6": _coded_case}


def run_case(case: Case, dev, rng) -> list[tuple[str, bool]]:
    """(label, bit-exact) for each check of `case` on `dev`."""
    return RUNNERS[case.kind](case, dev, rng)


def run_cases(dev, cases=None, out=print) -> tuple[int, dict[str, int]]:
    """Run `cases` (all of `CASES`) on `dev`, one line each; returns the
    failures and each kernel's launches, read as the change of its
    wrapper's `cuda_kernel_launches_total` around each case and given to
    the table width or K2 kernel the case's shape selects."""
    dev = resolve_device(dev)
    launches = dict.fromkeys(KERNELS, 0)
    fails = 0
    for case in CASES if cases is None else cases:
        g0, h0 = _build.launch_count(gf_bitmatmul_cuda), _build.launch_count(blake3_batch)
        checks = run_case(case, dev, np.random.default_rng([SEED, CASES.index(case)]))
        if not runs_on_host(dev):
            torch.cuda.synchronize(dev)
        g = _build.launch_count(gf_bitmatmul_cuda) - g0
        h = _build.launch_count(blake3_batch) - h0
        widths = {k1_width(r) for r in case.k1_rows()}
        if g and len(widths) != 1:
            raise ValueError(f"case {case.name}: K1 launches of several table widths")
        if g:
            launches[K1_KERNELS[widths.pop()]] += g
        if h:
            launches[k2_kernel(case.hash_len())] += h
        for label, ok in checks:
            out(f"{label}: {'OK' if ok else 'MISMATCH'}")
            fails += 0 if ok else 1
    return fails, launches


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: kernels on card 0) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if not runs_on_host(dev):
        print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    return 1 if verify(dev) else 0


if __name__ == "__main__":
    sys.exit(main())
