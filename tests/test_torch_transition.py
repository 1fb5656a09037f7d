"""The port's rebalance observatory held to the reference's own tests on
the CPU: tests/test_transition.py (clock-offset estimation, the skewed
timeline merge, the event bank's severities, `TransitionTracker` against
a real `LayoutManager`, the `[admin]` skew knob, and the 11->13 grow of
an EC(4,2) cluster under read-after-write load) run on the port's
modules and nodes through `port_mirror`.  The grow's nodes ask for the
CPU, where the codec is the native host codec; it is marked slow, as on
the reference."""

import torch

from torch_mirror import assert_mirror_whole, mirrored_tests, port_mirror, time_limit

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

# a test still running after 10 minutes ends its worker process (the grow
# alone waits up to 420 s for the transition to close), so that no
# scenario can hold the suite past its clock
_limit = time_limit(600)

TRANSITION_LEFT_OUT = ()  # every scenario runs on the port
transition_mirror = port_mirror("test_transition.py", TRANSITION_LEFT_OUT)
globals().update(mirrored_tests(transition_mirror, "transition"))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_transition.py", transition_mirror, TRANSITION_LEFT_OUT, 11)
