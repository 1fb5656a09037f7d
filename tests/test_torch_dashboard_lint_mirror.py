"""The reference's Grafana dashboard held to a port node on the CPU:
tests/test_dashboard_lint.py (every family a panel names is exported by
a live port node's `/metrics` or `/metrics/cluster` or catalogued in
doc/monitoring.md; the extraction of the dashboard's and the doc's
families; the cardinality guard) runs through `port_mirror`, with the
reference's own `script/dashboard_lint.py`.  Every test of the file
runs."""

import torch

from torch_mirror import (assert_mirror_whole, mirrored_tests, port_mirror, refusing_skips,
                          time_limit)

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

_limit = time_limit(90)  # a stuck test ends its worker instead of the suite

DASHBOARD_LINT_LEFT_OUT = ()  # every scenario runs on the port
dashboard_lint_mirror = port_mirror("test_dashboard_lint.py", DASHBOARD_LINT_LEFT_OUT)
globals().update(refusing_skips(mirrored_tests(dashboard_lint_mirror, "dashboard_lint")))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_dashboard_lint.py", dashboard_lint_mirror,
                        DASHBOARD_LINT_LEFT_OUT, 5)
