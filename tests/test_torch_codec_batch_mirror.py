"""The port's codec batcher and block codec held to the reference's own
tests on the CPU: tests/test_codec_batch.py (`CodecBatcher` coalescing,
linger, max-bytes cap, cancellation and error isolation, close; the
codec's fused `encode_batch_hashed` under both impls; the bucket
classes and the hasher's lengths; concurrent EC PUTs sharing
dispatches on a port cluster) runs on the port through `port_mirror`,
its `EcCodec(2, 1, tpu_enable=True)` bridged to a port CPU codec.
Every test of the file runs."""

import torch

from torch_mirror import (assert_mirror_whole, mirrored_tests, port_mirror, refusing_skips,
                          time_limit)

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

_limit = time_limit(120)  # a stuck test ends its worker instead of the suite

CODEC_BATCH_LEFT_OUT = ()  # every scenario runs on the port
codec_batch_mirror = port_mirror("test_codec_batch.py", CODEC_BATCH_LEFT_OUT)
globals().update(refusing_skips(mirrored_tests(codec_batch_mirror, "codec_batch")))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_codec_batch.py", codec_batch_mirror, CODEC_BATCH_LEFT_OUT, 12)
