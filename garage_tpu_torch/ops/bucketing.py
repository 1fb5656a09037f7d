"""Batch-axis shape bucketing.

PyTorch does not recompile per shape, but the batch axis is still padded
to its power-of-two class before a dispatch: it bounds the shapes the
kernels and their buffers see at log2(max_batch) classes per shard size,
and it keeps the pad-waste telemetry (`tpu_codec_pad_waste`) meaning
what it means in the reference package.  Pad rows are zeros and their
outputs are sliced off (GF coding and BLAKE3 treat batch rows
independently — nothing leaks between requests).  A mesh dispatch also
pads the batch to a multiple of the mesh width (`mesh_rows`), so every
entry gets an equal slice.
"""

from __future__ import annotations

import torch


def bucket_batch(b: int) -> int:
    """Round a block-batch size up to its power-of-two shape class."""
    if b <= 1:
        return 1
    return 1 << (b - 1).bit_length()


def pad_to_bucket(x: torch.Tensor, b_padded: int) -> torch.Tensor:
    """Zero-pad the leading (batch) axis up to `b_padded` rows, on the
    tensor's own device.  The caller slices the pad rows' outputs off."""
    b = x.shape[0]
    if b == b_padded:
        return x
    out = x.new_zeros((b_padded, *x.shape[1:]))
    out[:b] = x
    return out



def mesh_rows(b: int, n: int) -> int:
    """Rows of a mesh dispatch of b blocks over n entries: the
    power-of-two bucket first, then up to a multiple of n (the
    reference's `pad_for_mesh` rule, in one place for both mesh paths).
    The pad rows are made on the entries' devices (`Mesh.scatter`), so
    the host neither builds nor copies them."""
    bucket = bucket_batch(b)
    return bucket + (-bucket) % n
