"""The port's S3 read path held to the reference's own tests on the CPU:
tests/test_read_path.py (the hot-block cache, hedged fetches past slow
and dead ranks, batched decodes, order tags on the degraded path and the
streamed range GET through `api/s3/objects.py`) run on port nodes
through `port_mirror` (tests/test_torch_s3.py), whose configs ask for
the CPU."""

import torch

from test_torch_s3 import mirrored_tests, port_mirror
from torch_mirror import time_limit

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

# a test still running after 3 minutes ends its worker process, so that no
# scenario can hold the suite past its clock
_limit = time_limit(180)

globals().update(mirrored_tests(port_mirror("test_read_path.py"), "read_path"))
