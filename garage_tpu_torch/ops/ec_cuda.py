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
(coding kernel, then BLAKE3 of all k+m pieces, on one stream).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, gf, telemetry
from .bucketing import bucket_batch, pad_to_bucket
from .hash_cuda import blake3_batch

__all__ = [
    "resolve_device", "coding_state_from_numpy", "gf_bitmatmul",
    "gf_bitmatmul_cuda", "encode_hash_tensor", "blake3_supported_len",
    "EcCuda",
]

def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on.  A CUDA device on a
    machine without CUDA raises: nothing quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


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
    synchronising (`gf_bitmatmul_cuda.launches` counts the launches); a
    CPU tensor runs `gf_bitmatmul`."""
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
    if x.device.type == "cpu":
        out.copy_(gf_bitmatmul(bitmat, x))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
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


gf_bitmatmul_cuda.launches = 0


def encode_hash_tensor(
    bitmat: torch.Tensor, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused foreground dispatch: x (B, k, S) uint8 data shards ->
    (shards (B, k+m, S) with parity in [:, k:], hashes (B, k+m, 32)).

    One buffer holds all k+m pieces: the data is copied into [:, :k], K1
    writes parity into [:, k:] through its batch stride, and K2 hashes
    the buffer viewed as (B*(k+m), S) — both on the current stream, with
    no host synchronisation between them."""
    b, k, s = x.shape
    n = k + bitmat.shape[0] // 8
    shards = torch.empty((b, n, s), dtype=torch.uint8, device=x.device)
    shards[:, :k].copy_(x)
    gf_bitmatmul_cuda(bitmat, shards[:, :k], out=shards[:, k:])
    hashes = blake3_batch(shards.view(b * n, s)).view(b, n, 32)
    return shards, hashes


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
    """Batched EC(k, m) encode/reconstruct on one device.

    Host API takes/returns numpy uint8 arrays shaped (B, shards, S); the
    block codec layer (block/codec/ec.py) handles bytes <-> array
    marshalling and dispatch batching.  The batch axis is padded to its
    power-of-two bucket and the pad rows' outputs sliced off.  Each
    dispatch ends in the device->host copy of its result, which is the
    synchronisation point."""

    def __init__(self, k: int, m: int, device="cuda"):
        self.k, self.m = k, m
        self.device = resolve_device(device)
        self.platform = telemetry.resolved_platform(self.device)
        self._enc_bitmat = coding_state_from_numpy(
            gf.cauchy_parity_matrix(k, m), self.device
        )["bitmat"]
        self._recon_cache: dict[tuple[tuple[int, ...], tuple[int, ...]], torch.Tensor] = {}

    def _check(self, data: np.ndarray, what: str, exact: bool = True) -> None:
        ok = data.ndim == 3 and (
            data.shape[1] == self.k if exact else data.shape[1] >= self.k
        )
        if not ok or data.dtype != np.uint8:
            want = self.k if exact else f">={self.k}"
            raise ValueError(
                f"{what}: expected (B, {want}, S) uint8, got {data.shape} {data.dtype}"
            )

    def _apply(self, bitmat: torch.Tensor, x: np.ndarray, kernel: str) -> np.ndarray:
        b = x.shape[0]
        bucket = bucket_batch(b)
        with telemetry.dispatch(kernel, self.platform, b, x.nbytes) as rec:
            rec.pad(b, bucket)
            with rec.transfer():
                xd = pad_to_bucket(_host_tensor(x).to(self.device), bucket)
            with rec.compute():
                out = gf_bitmatmul_cuda(bitmat, xd)
            with rec.transfer():
                return out[:b].cpu().numpy()

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(B, k, S) data shards -> (B, m, S) parity shards."""
        self._check(data, "encode")
        return self._apply(self._enc_bitmat, data, "ec_encode")

    def encode_and_hash(
        self, data: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """Foreground fused dispatch: (B, k, S) data shards ->
        (parity (B, m, S), BLAKE3 hashes (B, k+m, 32) or None).

        Hashes are None when the shard length is outside the batched
        BLAKE3 kernel's supported set — callers then hash host-side."""
        self._check(data, "encode_and_hash")
        b, _k, s = data.shape
        if not blake3_supported_len(s):
            return self.encode(data), None
        bucket = bucket_batch(b)
        with telemetry.dispatch("ec_encode_hash", self.platform, b, data.nbytes) as rec:
            rec.pad(b, bucket)
            with rec.transfer():
                x = pad_to_bucket(_host_tensor(data).to(self.device), bucket)
            with rec.compute():
                shards, hashes = encode_hash_tensor(self._enc_bitmat, x)
            with rec.transfer():
                parity = shards[:b, self.k:].cpu().numpy()
                hashes_np = hashes[:b].cpu().numpy()
        return parity, hashes_np

    def reconstruct(
        self, shards: np.ndarray, present: list[int], want: list[int]
    ) -> np.ndarray:
        """shards: (B, >=k, S) surviving shards ordered as `present`.
        Returns (B, len(want), S).  One kernel serves every erasure
        pattern; the pattern only changes the small matrix argument."""
        self._check(shards, "reconstruct", exact=False)
        key = (tuple(present[: self.k]), tuple(want))
        bitmat = self._recon_cache.get(key)
        if bitmat is None:
            rmat = gf.reconstruction_matrix(self.k, self.m, list(key[0]), list(want))
            bitmat = coding_state_from_numpy(rmat, self.device)["bitmat"]
            self._recon_cache[key] = bitmat
        return self._apply(bitmat, shards[:, : self.k, :], "ec_reconstruct")
