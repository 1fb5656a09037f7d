"""The port's repair planner held to the reference's own tests on the
CPU: tests/test_repair_plan.py (urgency classes, a one-node wipe
repaired in a few coalesced rounds whose reconstructions fan out over
the mesh, the checkpoint resumed without a rescan, the bytes budget
and tranquility, peers behind an open breaker deferred, remote
holders nudged, the admin ops, a corrupt checkpoint, the replica-mode
refusal) runs on the port through `port_mirror`.  Its
`EcCodec(2, 1)` is the bridge: a port CPU codec whose automatic mesh
width is the reference's CPU device count (8 under tests/conftest.py),
so the planner's rounds fan out over 8 CPU mesh entries as the
reference's do over 8 virtual devices.

Left out: `test_bench_repair_artifact_floors`, which reads the
reference's committed BENCH_repair_10k.json and runs no code of
either package."""

import torch

from torch_mirror import (assert_mirror_whole, mirrored_tests, port_mirror, refusing_skips,
                          time_limit)

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

_limit = time_limit(150)  # a stuck test ends its worker instead of the suite

REPAIR_PLAN_LEFT_OUT = ("test_bench_repair_artifact_floors",)
repair_plan_mirror = port_mirror("test_repair_plan.py", REPAIR_PLAN_LEFT_OUT)
globals().update(refusing_skips(mirrored_tests(repair_plan_mirror, "repair_plan")))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_repair_plan.py", repair_plan_mirror, REPAIR_PLAN_LEFT_OUT, 10)
