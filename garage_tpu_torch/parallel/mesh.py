"""Device mesh for the block-batch fan-out (port of
garage_tpu/parallel/mesh.py).

The reference lays a 1-D `jax.sharding.Mesh` ("blocks" axis) over the
visible devices and shard_maps the coding kernel over it: the block
batch is split across the devices, the coding matrix is replicated,
and only the scrub statistics are reduced across them.  Here a `Mesh`
is an ordered tuple of `torch.device` entries, each one shard of the
batch, with one CUDA stream per CUDA entry.  An entry list may repeat a
device: several shards on one card, each on its own stream, run the
same split, per-entry launches, reduction and gather as separate cards.
`Mesh.scatter` / `Mesh.map` / `Mesh.gather` stand in for the
reference's `block_sharding` and `replicated` placements.

Divergence from the reference: its `make_mesh` falls back to virtual
CPU devices when fewer accelerators are visible than asked for.  This
one raises: a mesh asked of the cards never runs on the CPU.  CPU
entries are made only when the caller asks for them (`device="cpu"`),
and then each entry runs the plain versions.
"""

from __future__ import annotations

import torch

from ..ops.bucketing import pad_to_bucket
from ..ops.telemetry import runs_on_host

__all__ = ["Mesh", "make_mesh", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on.  A CUDA device on a
    machine without CUDA raises: nothing quietly runs on the CPU."""
    dev = torch.device(device)
    if runs_on_host(dev):
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A 1-D mesh: `devices[i]` holds shard i of the block batch and
    launches its work on `streams[i]` (None for a CPU entry)."""

    def __init__(self, devices):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one entry")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"mesh entries mix device types: {devs}")
        self.devices = devs
        self.streams = tuple(
            torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devs
        )

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def scatter(self, x: torch.Tensor, rows: int) -> list[torch.Tensor]:
        """x's batch, zero-padded to `rows` blocks (a multiple of `size`),
        in `size` equal slices, slice i on devices[i]: the real rows of
        that slice are copied there under the entry's stream and the pad
        rows are zeros made there, so they never cross the host link."""
        if rows % self.size or rows < x.shape[0]:
            raise ValueError(f"{x.shape[0]} blocks do not pad to {rows} over {self.size} entries")
        per = rows // self.size
        return self.map(
            lambda dev, i: pad_to_bucket(x[i * per:(i + 1) * per].to(dev), per),
            range(self.size),
        )

    def map(self, fn, *per_entry) -> list:
        """`[fn(devices[i], *(a[i] for a in per_entry))]`, each call under
        entry i's stream.  Each stream first waits for the work already
        queued on its device's current stream (inputs and coding matrices
        placed there); `join` before that stream reads the results."""
        out = []
        for i, (dev, stream) in enumerate(zip(self.devices, self.streams)):
            args = [a[i] for a in per_entry]
            if stream is None:
                out.append(fn(dev, *args))
                continue
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                out.append(fn(dev, *args))
        return out

    def join(self, results=()) -> None:
        """Make each device's current stream wait for its entries'
        streams.  Each tensor in `results` (made on an entry's stream) is
        marked as used by its device's current stream, so the allocator
        does not hand its memory back to the entry's stream before the
        current stream has read it."""
        for dev, stream in zip(self.devices, self.streams):
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)
        for t in results:
            if not runs_on_host(t):
                t.record_stream(torch.cuda.current_stream(t.device))

    def gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Join, then copy the entries' results, in entry order, into one
        host tensor along the batch axis.  Each copy blocks until its
        part is on the host."""
        self.join(parts)
        rows = sum(p.shape[0] for p in parts)
        out = torch.empty((rows, *parts[0].shape[1:]), dtype=parts[0].dtype)
        at = 0
        for p in parts:
            out[at:at + p.shape[0]].copy_(p)
            at += p.shape[0]
        return out


def make_mesh(n: int | None = None, device="cuda", devices=None) -> Mesh:
    """A 1-D mesh.  With `devices`, one entry per item, in order (a
    device may repeat).  Otherwise `n` entries of `device`'s type: the
    first n visible cards (all of them when n is None), raising when
    fewer are visible; or, for `device="cpu"`, n CPU entries (1 when n
    is None), the counterpart of the reference's virtual CPU devices."""
    if devices is not None:
        devices = list(devices)
        if n is not None and n != len(devices):
            raise ValueError(f"n={n} but {len(devices)} devices given")
        return Mesh(devices)
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh(["cpu"] * (1 if n is None else n))
    if kind != "cuda":
        raise ValueError(f"unsupported device {device}")
    visible = torch.cuda.device_count()
    want = visible if n is None else n
    if want < 1 or visible < want:
        raise RuntimeError(
            f"a mesh of {want} CUDA cards was asked for and torch sees {visible}; "
            "pass devices=[...] to place several entries on one card"
        )
    return Mesh([torch.device("cuda", i) for i in range(want)])
