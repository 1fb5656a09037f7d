"""Batch-axis shape bucketing.

PyTorch does not recompile per shape, but the batch axis is still padded
to its power-of-two class before a dispatch: it bounds the shapes the
kernels and their buffers see at log2(max_batch) classes per shard size,
and it keeps the pad-waste telemetry (`tpu_codec_pad_waste`) meaning
what it means in the reference package.  Pad rows are zeros and their
outputs are sliced off (GF coding and BLAKE3 treat batch rows
independently — nothing leaks between requests).
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
