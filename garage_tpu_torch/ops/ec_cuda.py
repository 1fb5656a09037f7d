"""Erasure codec on the card: GF(2^8) coding of shard batches (port of
garage_tpu/ops/ec_tpu.py).

GF(2^8) multiplication by a constant is GF(2)-linear on the operand's
bits (gf.gf_const_bitmatrix), so an (r x q) GF coding matrix expands to
an (8r x 8q) 0/1 matrix M, and coding is

    out_bits[b, i, s] = ( M @ in_bits )[b, i, s]  mod 2

over bit-unpacked shards, batched over blocks.  Two versions compute it:

1. `gf_bitmatmul` — the plain PyTorch version (the reference's einsum
   body): unpack to bit-planes, one float32 batched matmul (exact: 0/1
   inputs, sums <= 8q < 2^24, whatever the TF32 setting), `& 1`,
   re-pack.  It runs for CPU tensors and is the yardstick on the card.

2. `gf_bitmatmul_cuda` — the wrapper of kernel K1 (csrc/gf_bitplane.cu),
   which folds M into 16-entry nibble tables in shared memory, one per
   input shard and nibble half, whose entries pack the products for up
   to 8 output rows, and streams the shards through them once.  It
   launches for a CUDA tensor and runs the plain version for a CPU
   tensor.

The matrix is an argument: encode, decode and every repair erasure
pattern share one kernel.  `EcCuda` is the batched host API the block
codec layer calls; `encode_hash_tensor` is the fused foreground dispatch
(coding kernel, then BLAKE3 of all k+m pieces where they lie, on one
stream);
`ec_apply_mesh` is the fan-out of K1 over a mesh's entries (K6, the
reference's `ec_apply_fn_mesh`), which `EcCuda` takes for large batches
when its mesh is wider than one entry.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..parallel.mesh import Mesh, make_mesh, resolve_device
from . import _build, gf, telemetry
from .bucketing import bucket_batch, mesh_rows, pad_to_bucket
from .hash_cuda import blake3_pieces

__all__ = [
    "resolve_device", "coding_state_from_numpy", "gf_bitmatmul",
    "gf_bitmatmul_cuda", "encode_hash_tensor", "ec_apply_mesh",
    "blake3_supported_len", "EcCuda",
]


def coding_state_from_numpy(parity_gf: np.ndarray, device) -> dict[str, torch.Tensor]:
    """An (r x q) GF(2^8) coding matrix as numpy (the reference's
    `gf.cauchy_parity_matrix` / `gf.reconstruction_matrix`) -> the
    port's device tensors: `coding` (r, q) and its bit-matrix expansion
    `bitmat` (8r, 8q), both uint8, on `device`."""
    coding = np.ascontiguousarray(parity_gf, dtype=np.uint8)
    return {
        "coding": torch.from_numpy(coding.copy()).to(device),
        "bitmat": torch.from_numpy(gf.bitmatrix_of(coding)).to(device),
    }


def _host_tensor(x: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a numpy uint8 batch (copied only when the array
    is read-only or not C-contiguous)."""
    return torch.from_numpy(np.require(x, np.uint8, ("C", "W")))


# --- K1: plain version and kernel wrapper ---------------------------------------


def gf_bitmatmul(bitmat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1.  bitmat: (8r, 8q) 0/1;  x: (B, q, S) uint8
    ->  (B, r, S) uint8, on x's device."""
    b, q, s = x.shape
    shifts = torch.arange(8, dtype=torch.int32, device=x.device)
    bits = (x.to(torch.int32)[:, :, None, :] >> shifts[None, None, :, None]) & 1
    bits = bits.reshape(b, q * 8, s).to(torch.float32)
    acc = torch.einsum("ij,bjs->bis", bitmat.to(torch.float32), bits)
    out_bits = acc.to(torch.int32) & 1
    r = bitmat.shape[0] // 8
    out = (out_bits.reshape(b, r, 8, s) << shifts[None, None, :, None]).sum(dim=2)
    return out.to(torch.uint8)


def gf_bitmatmul_cuda(
    bitmat: torch.Tensor, x: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """K1: out (B, r, S) = bitmat (8r, 8q) (x) x (B, q, S), uint8.

    `x` and `out` may be strided views (rows of contiguous bytes) of
    non-overlapping memory; `out` is allocated when not given.  A CUDA
    tensor launches the kernel on the current stream without
    synchronising (`_build.count_launch` counts the launches); a CPU
    tensor runs `gf_bitmatmul`."""
    if x.dim() != 3 or x.dtype != torch.uint8:
        raise ValueError(f"x must be (B, q, S) uint8, got {tuple(x.shape)} {x.dtype}")
    b, q, s = x.shape
    if (bitmat.dim() != 2 or bitmat.dtype != torch.uint8
            or bitmat.shape[1] != 8 * q or bitmat.shape[0] % 8):
        raise ValueError(
            f"bitmat must be (8r, {8 * q}) uint8, got {tuple(bitmat.shape)} {bitmat.dtype}"
        )
    r = bitmat.shape[0] // 8
    if out is None:
        out = torch.empty((b, r, s), dtype=torch.uint8, device=x.device)
    elif out.shape != (b, r, s) or out.dtype != torch.uint8:
        raise ValueError(f"out must be ({b}, {r}, {s}) uint8, got {tuple(out.shape)}")
    if not (bitmat.device == x.device == out.device):
        raise ValueError("bitmat, x and out must share a device")
    if telemetry.runs_on_host(x):
        out.copy_(gf_bitmatmul(bitmat, x))
        return out
    if x.stride(2) != 1 or out.stride(2) != 1 or not bitmat.is_contiguous():
        raise ValueError("the shard axis of x and out, and bitmat, must be contiguous")
    if b == 0 or s == 0 or r == 0:
        return out
    code = _build.lib("gf_bitplane").gf_bitplane_apply(
        x.device.index, bitmat.data_ptr(), r, q,
        x.data_ptr(), x.stride(0), x.stride(1),
        out.data_ptr(), out.stride(0), out.stride(1),
        b, s, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(code, "gf_bitplane_apply")
    _build.count_launch(gf_bitmatmul_cuda)
    return out


def encode_hash_tensor(
    bitmat: torch.Tensor, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused foreground dispatch (the reference's `body`): x (B, k, S)
    uint8 data shards -> (parity (B, m, S), hashes (B, k+m, 32)).

    K1 writes the parity into a contiguous tensor of its own, and K2
    hashes the data and parity pieces where they lie (`blake3_pieces`),
    in piece order — both on the current stream, with no host
    synchronisation between them and no copy of the data shards.
    `_build.count_launch` counts the dispatches that launched that pair
    on the card."""
    parity = gf_bitmatmul_cuda(bitmat, x)
    hashes = blake3_pieces(x, parity)
    if not telemetry.runs_on_host(x):
        _build.count_launch(encode_hash_tensor)
    return parity, hashes


def ec_apply_mesh(
    mesh: Mesh, bitmats: list[torch.Tensor], parts: list[torch.Tensor]
) -> list[torch.Tensor]:
    """K6, the fan-out of K1 over a mesh (the reference's
    `ec_apply_fn_mesh`): parts[i] (per, q, S) and bitmats[i] (8r, 8q) on
    mesh.devices[i] -> the entries' (per, r, S) outputs.  Each entry's
    launch runs under its own stream; the streams are not joined."""
    return mesh.map(lambda _dev, bm, x: gf_bitmatmul_cuda(bm, x), bitmats, parts)


def blake3_supported_len(s: int) -> bool:
    """Shard lengths the batched BLAKE3 kernel accepts (ops/hash_cuda.py):
    any multiple of 64 up to one chunk, or a power-of-two number of full
    1024-byte chunks."""
    if s <= 0 or s % 64:
        return False
    if s <= 1024:
        return True
    return s % 1024 == 0 and (s // 1024).bit_count() == 1


class EcCuda:
    """Batched EC(k, m) encode/reconstruct on one device, or fanned out
    over a mesh.

    Host API takes/returns numpy uint8 arrays shaped (B, shards, S); the
    block codec layer (block/codec/ec.py) handles bytes <-> array
    marshalling and dispatch batching.  The batch axis is padded to its
    power-of-two bucket and the pad rows' outputs sliced off.  Each
    dispatch copies its batch to the device, launches, waits for its
    kernels (`DispatchRecord.compute`'s end, the synchronisation point) and
    copies its result back, each step timed as a stage of its own.

    Mesh fan-out (the reference's `EcTpu._apply_mesh`): `encode` and
    `reconstruct` split a batch over the mesh's entries when the mesh
    is wider than one (`_mesh_width`: `GARAGE_EC_MESH=0` gives 1, then
    `n_devices` or an explicit `mesh` pins the width, else every visible
    card for a CUDA codec and 1 for a CPU codec).  An auto-detected mesh
    engages at a batch of at least 2n, a pinned one at n.  On a one-card
    host the auto width is 1 and nothing fans out.  `encode_and_hash`
    stays on one device, as in the reference.  Divergence: the
    reference retries a failed mesh dispatch on one device
    (`ec_tpu.py:385-394`); here it raises, so a broken fan-out is never
    hidden behind a slower path."""

    def __init__(self, k: int, m: int, device="cuda", n_devices: int | None = None,
                 mesh: Mesh | None = None):
        self.k, self.m = k, m
        self.device = resolve_device(device)
        self.platform = telemetry.resolved_platform(self.device)
        if mesh is not None:
            if n_devices not in (None, mesh.size):
                raise ValueError(f"n_devices={n_devices} but the mesh has {mesh.size} entries")
            if mesh.devices[0].type != self.device.type:
                raise ValueError(f"a {self.device.type} codec cannot fan out over {mesh}")
            n_devices = mesh.size
        self._n_dev = n_devices
        self._meshes: dict[int, Mesh] = {} if mesh is None else {mesh.size: mesh}
        self._enc_bitmat = coding_state_from_numpy(
            gf.cauchy_parity_matrix(k, m), self.device
        )["bitmat"]
        self._recon_cache: dict[tuple[tuple[int, ...], tuple[int, ...]], torch.Tensor] = {}
        # copies of the coding matrices on the other devices of a mesh,
        # by (None for encode or the reconstruction key, device)
        self._replicas: dict[tuple, torch.Tensor] = {}

    def _check(self, data: np.ndarray, what: str, exact: bool = True) -> None:
        ok = data.ndim == 3 and (
            data.shape[1] == self.k if exact else data.shape[1] >= self.k
        )
        if not ok or data.dtype != np.uint8:
            want = self.k if exact else f">={self.k}"
            raise ValueError(
                f"{what}: expected (B, {want}, S) uint8, got {data.shape} {data.dtype}"
            )

    def _mesh_width(self) -> int:
        if os.environ.get("GARAGE_EC_MESH", "1") == "0":
            return 1
        if self._n_dev is not None:
            return self._n_dev
        return 1 if telemetry.runs_on_host(self.device) else torch.cuda.device_count()

    def _bitmat(self, key, dev: torch.device) -> torch.Tensor:
        """The bit-matrix of coding matrix `key` (None: encode; else a
        reconstruction key) on `dev`, copied from this codec's device once
        per device."""
        base = self._enc_bitmat if key is None else self._recon_cache[key]
        if dev == base.device:
            return base
        copy = self._replicas.get((key, dev))
        if copy is None:
            copy = self._replicas[(key, dev)] = base.to(dev)
        return copy

    def _apply(self, key, x: np.ndarray, kernel: str, op: str) -> np.ndarray:
        """One K1 dispatch of the batch x for the codec's `op` (encode,
        decode or reconstruct, the label of its stages)."""
        b = x.shape[0]
        n = self._mesh_width()
        min_batch = 2 * n if self._n_dev is None else n
        with telemetry.dispatch(kernel, self.platform, b, x.nbytes, op) as rec:
            if n > 1 and b >= min_batch:
                out = self._apply_mesh(key, x, n, rec)
                telemetry.mesh_engaged(kernel, self.platform, n)
                return out
            bucket = bucket_batch(b)
            telemetry.record_cache_event("ec_dispatch_bucket", bucket == b)
            rec.pad(b, bucket)
            with rec.transfer("h2d", x.nbytes):
                xd = pad_to_bucket(_host_tensor(x).to(self.device), bucket)
            with rec.compute(nbytes=x.nbytes):
                out = gf_bitmatmul_cuda(self._bitmat(key, self.device), xd)
            with rec.transfer("d2h", b * out[0].numel()):
                return out[:b].cpu().numpy()

    def _apply_mesh(self, key, x: np.ndarray, n: int,
                    rec: telemetry.DispatchRecord) -> np.ndarray:
        """Shard the block batch over the n-entry mesh: size it with
        `mesh_rows`, split it into n equal slices, copy each slice's real
        rows to its entry's device and zero-pad it there, launch K1 there
        under the entry's stream, join the streams, gather to the host
        and slice the pad rows off."""
        mesh = self._meshes.get(n)
        if mesh is None:
            mesh = self._meshes[n] = make_mesh(n, device=self.device.type)
        b = x.shape[0]
        # placed on the current streams, which each entry's stream waits on
        bitmats = [self._bitmat(key, dev) for dev in mesh.devices]
        rows = mesh_rows(b, n)
        rec.pad(b, rows)
        with rec.transfer("h2d", x.nbytes):
            parts = mesh.scatter(_host_tensor(x), rows)
        with rec.compute(mesh.streams, x.nbytes):
            outs = ec_apply_mesh(mesh, bitmats, parts)
        with rec.transfer("d2h", b * outs[0][0].numel()):
            return mesh.gather(outs)[:b].numpy()

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(B, k, S) data shards -> (B, m, S) parity shards."""
        self._check(data, "encode")
        return self._apply(None, data, "ec_encode", "encode")

    def encode_and_hash(
        self, data: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """Foreground fused dispatch: (B, k, S) data shards ->
        (parity (B, m, S), BLAKE3 hashes (B, k+m, 32) or None).  Always
        on this codec's device.

        Hashes are None when the shard length is outside the batched
        BLAKE3 kernel's supported set — callers then hash host-side."""
        self._check(data, "encode_and_hash")
        b, _k, s = data.shape
        if not blake3_supported_len(s):
            return self.encode(data), None
        bucket = bucket_batch(b)
        telemetry.record_cache_event("ec_batch_bucket", bucket == b)
        with telemetry.dispatch("ec_encode_hash", self.platform, b, data.nbytes,
                                "encode") as rec:
            rec.pad(b, bucket)
            with rec.transfer("h2d", data.nbytes):
                x = pad_to_bucket(_host_tensor(data).to(self.device), bucket)
            with rec.compute(nbytes=data.nbytes):
                parity_d, hashes = encode_hash_tensor(self._enc_bitmat, x)
            with rec.transfer("d2h", b * (parity_d[0].numel() + hashes[0].numel())):
                parity = parity_d[:b].cpu().numpy()
                hashes_np = hashes[:b].cpu().numpy()
        return parity, hashes_np

    def reconstruct(
        self, shards: np.ndarray, present: list[int], want: list[int],
        op: str = "reconstruct",
    ) -> np.ndarray:
        """shards: (B, >=k, S) surviving shards ordered as `present`.
        Returns (B, len(want), S).  One kernel serves every erasure
        pattern; the pattern only changes the small matrix argument.
        `op` labels the dispatch's stages: "decode" for a degraded read's
        reconstruction."""
        self._check(shards, "reconstruct", exact=False)
        key = (tuple(present[: self.k]), tuple(want))
        telemetry.record_cache_event("ec_recon_matrix", key in self._recon_cache)
        if key not in self._recon_cache:
            rmat = gf.reconstruction_matrix(self.k, self.m, list(key[0]), list(want))
            self._recon_cache[key] = coding_state_from_numpy(rmat, self.device)["bitmat"]
        return self._apply(key, shards[:, : self.k, :], "ec_reconstruct", op)
