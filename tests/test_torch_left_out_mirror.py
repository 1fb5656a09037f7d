"""Reference tests that earlier mirrors left out, run on the port through
`port_mirror`, each node asking for the CPU; each in this file of its
own under its own time limit, so that a test that hangs ends this
file's worker and not the admin or CLI mirror's
(`torch_mirror.RUN_APART`):

  - tests/test_admin_ops.py::test_block_ops: `block-info`,
    `block-list-errors`, `block-retry-now` and `block-purge` on a
    one-node daemon right after a PUT.  It was red on the port 5 runs
    of 16 alone, the block's 0 -> 1 refcount checked by resync before
    the PUT's own write had landed (its error backed off 60 s);
    `INCREF_CHECK_TIMEOUTS` in block/resync.py now delays that check;
  - tests/test_flight.py::test_debug_profile_endpoint_captures_hot_function:
    a 2 s sampling profile of a live node;
  - tests/test_latency_xray.py::test_ec83_cluster_xray_acceptance: an
    11-node EC(8,3) cluster's latency X-ray.

The other tests of those files run in tests/test_torch_cli.py and
tests/test_torch_admin.py, whose whole-mirror checks count these three.
"""

import torch

from torch_mirror import RUN_APART, mirrored_tests, port_mirror, refusing_skips, time_limit

torch.set_num_threads(1)  # one thread per suite worker

_limit = time_limit(120)  # a stuck test ends its worker instead of the suite

PREFIXES = {"test_admin_ops.py": "admin_ops", "test_flight.py": "flight",
            "test_latency_xray.py": "latency_xray"}
for ref_file, prefix in PREFIXES.items():
    globals().update(refusing_skips(mirrored_tests(port_mirror(ref_file), prefix, apart=True)))


def test_every_test_run_apart_is_here():
    """Each test `RUN_APART` names runs here (a name its file lacks would
    run nowhere)."""
    assert set(RUN_APART) == set(PREFIXES)
    want = {f"test_{PREFIXES[f]}_{t.removeprefix('test_')}" for f, ts in RUN_APART.items()
            for t in ts}
    assert len(want) == 3 and want <= set(globals())
