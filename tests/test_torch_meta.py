"""The port's metadata plane held to the reference's own tests on the CPU:
tests/test_meta_replication.py (the metadata ring of
`table/replication.py`, the quorum arithmetic, the `[meta]` config and
`table/coalesce.py`'s `InsertCoalescer`) and tests/test_discovery.py
(`rpc/discovery.py`'s Consul and Kubernetes publishers against mock
REST servers, and the system's discovery loop), each run on the port's
modules through `port_mirror` (tests/test_torch_s3.py)."""

import torch

from test_torch_s3 import mirrored_tests, port_mirror
from torch_mirror import time_limit

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

# a test still running after 3 minutes ends its worker process, so that no
# scenario can hold the suite past its clock
_limit = time_limit(180)

globals().update(mirrored_tests(port_mirror("test_meta_replication.py"), "meta"))
globals().update(mirrored_tests(port_mirror("test_discovery.py"), "discovery"))
