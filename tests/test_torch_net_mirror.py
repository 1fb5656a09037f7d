"""The port's network layer (garage_tpu_torch/net) held to the
reference's own tests on the CPU: tests/test_net.py (calls, errors,
large bodies and streams, peer-id pinning, the refused reflection and
wrong-key handshakes, priority QoS, timeouts, concurrent calls both
ways, stream flow control and producer failure, ordered substreams,
the peering mesh and its peer-list address update) and
tests/test_faultplan.py (the seeded fault plane, `net/fault.py`: delay,
drop, stream truncation, same seed same faults) run on the port through
`port_mirror`.  Every test of both files runs."""

from torch_mirror import assert_mirror_whole, mirrored_tests, port_mirror, time_limit

# a test still running after 2 minutes ends its worker process, so that
# no scenario can hold the suite past its clock
_limit = time_limit(120)

NET_LEFT_OUT = ()  # every scenario runs on the port
FAULTPLAN_LEFT_OUT = ()
net_mirror = port_mirror("test_net.py", NET_LEFT_OUT)
globals().update(mirrored_tests(net_mirror, "net"))
faultplan_mirror = port_mirror("test_faultplan.py", FAULTPLAN_LEFT_OUT)
globals().update(mirrored_tests(faultplan_mirror, "faultplan"))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_net.py", net_mirror, NET_LEFT_OUT, 17)
    assert_mirror_whole("test_faultplan.py", faultplan_mirror, FAULTPLAN_LEFT_OUT, 7)
