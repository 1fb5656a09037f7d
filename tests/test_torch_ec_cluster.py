"""The port's erasure-coded S3 cluster held to the reference's own tests
on the CPU: tests/test_ec_cluster.py (3 nodes at EC(2,1) through a
multipart upload, a GET with one node's shards deleted and the resync
heal; 21 nodes at EC(16,4) surviving the loss of 4 nodes' shards; the
refused shrink below k+m) run on port nodes through `port_mirror`.  The
nodes ask for the CPU, where the codec is the native host codec, as on
a reference node with `[tpu] enable = false`."""

import torch

from torch_mirror import TESTS, mirrored_tests, port_mirror, time_limit

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

# a test still running after 3 minutes ends its worker process, so that no
# scenario can hold the suite past its clock
_limit = time_limit(180)

EC_CLUSTER_LEFT_OUT = ()  # every scenario runs on the port
ec_cluster_mirror = port_mirror("test_ec_cluster.py", EC_CLUSTER_LEFT_OUT)
globals().update(mirrored_tests(ec_cluster_mirror, "ec_cluster"))


def test_mirror_holds_every_reference_scenario():
    src = (TESTS / "test_ec_cluster.py").read_text()
    want = {line.split("(")[0][4:] for line in src.splitlines() if line.startswith("def test_")}
    assert len(want) == 3
    got = {k for k in vars(ec_cluster_mirror) if k.startswith("test_")}
    assert got == want - set(EC_CLUSTER_LEFT_OUT)
    assert "garage_tpu." not in ec_cluster_mirror.mirror_source.replace("garage_tpu_torch.", "")
