"""The port's block store held to the reference's own tests on the CPU:
tests/test_block.py (the replica and EC codecs, batched against scalar
coding, the multi-drive data layout, reference counts, a 3-node
manager cluster's PUT/GET, RAM budget, streamed payloads, corruption,
resync, EC pieces, reconstruction, bulk reconstruction, piece GC and
scrub, file I/O off the event loop) runs on the port through
`port_mirror`.  Its `EcCodec(k, m, tpu_enable=...)` is the bridge: a
port CPU codec routed as the reference's is on its CPU platform.
Every test of the file runs."""

import torch

from torch_mirror import (assert_mirror_whole, mirrored_tests, port_mirror, refusing_skips,
                          time_limit)

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

_limit = time_limit(120)  # a stuck test ends its worker instead of the suite

BLOCK_LEFT_OUT = ()  # every scenario runs on the port
block_mirror = port_mirror("test_block.py", BLOCK_LEFT_OUT)
globals().update(refusing_skips(mirrored_tests(block_mirror, "block")))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_block.py", block_mirror, BLOCK_LEFT_OUT, 16)
