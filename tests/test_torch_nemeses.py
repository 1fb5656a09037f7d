"""The port's S3 cluster held to the reference's nemeses on the CPU:
tests/test_chaos.py (partitions with acked writes surviving and minority
writes blocked, a layout change under load, EC PUTs mid-migration with
either set's death, a layout transition that completes and trims, clock
skew, multi-drive add/remove, a flaky peer, a disk read fault) and
tests/test_jepsen.py (history-checked register and set workloads under
combined nemeses, replicated and EC(2,1)) run on port nodes through
`port_mirror`, each node asking for the CPU.  Every test of both files
runs; `test_jepsen_combined_nemeses_duration`, a 60 s soak, keeps the
reference's `slow` mark and so stays out of the tier-1 run, as on the
reference."""

import torch

from torch_mirror import assert_mirror_whole, mirrored_tests, port_mirror, time_limit

torch.set_num_threads(1)  # one thread per suite worker

# a test still running after 4 minutes ends its worker process: the
# reference's combined-nemeses run can wait forever under six workers
_limit = time_limit(240)

CHAOS_LEFT_OUT = ()  # every scenario runs on the port
JEPSEN_LEFT_OUT = ()
chaos_mirror = port_mirror("test_chaos.py", CHAOS_LEFT_OUT)
globals().update(mirrored_tests(chaos_mirror, "chaos"))
jepsen_mirror = port_mirror("test_jepsen.py", JEPSEN_LEFT_OUT)
globals().update(mirrored_tests(jepsen_mirror, "jepsen"))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_chaos.py", chaos_mirror, CHAOS_LEFT_OUT, 12)
    assert_mirror_whole("test_jepsen.py", jepsen_mirror, JEPSEN_LEFT_OUT, 4)
