"""The port's tenant, traffic and durability observatories
(garage_tpu_torch/rpc/tenant.py, rpc/traffic.py, block/durability.py)
held to the reference's own tests of them on the CPU: tests/test_tenant.py,
tests/test_traffic.py and tests/test_durability.py run whole on port
nodes through `port_mirror`, each node asking for the CPU, their live
scenarios included (the admin endpoints and digests of live nodes, the
resync error ages, the EC(2,1) convergence).  Each file's 11-node EC(8,3)
acceptance test keeps its `slow` mark, as on the reference, and passes
with `-m slow`.  No test is left out.

tests/test_torch_{tenant,traffic,durability}.py stay beside this file:
they feed the same inputs to both packages and compare the outputs,
which a mirror does not do."""

import torch

from torch_mirror import (assert_mirror_whole, mirrored_tests, port_mirror, refusing_skips,
                          time_limit)

torch.set_num_threads(1)  # one thread per suite worker

_limit = time_limit(150)  # a stuck test ends its worker instead of the suite

MIRRORS = {  # reference file -> (prefix, its test count)
    "test_tenant.py": ("tenant", 12),
    "test_traffic.py": ("traffic", 9),
    "test_durability.py": ("durability", 9),
}
mirrors = {ref: port_mirror(ref) for ref in MIRRORS}
for ref, (prefix, _n) in MIRRORS.items():
    globals().update(refusing_skips(mirrored_tests(mirrors[ref], prefix)))


def test_mirrors_hold_every_reference_scenario():
    for ref, (_prefix, n) in MIRRORS.items():
        assert_mirror_whole(ref, mirrors[ref], (), n)
