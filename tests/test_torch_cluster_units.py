"""The port's cluster plane held to the reference's own unit tests on
the CPU: tests/test_peer_health.py (the per-peer circuit breaker,
adaptive timeouts and health-aware request order, `rpc/peer_health.py`),
tests/test_rpc.py (layout gossip, quorum calls and write sets, read and
zone order on a small mesh: `rpc/system.py`, `rpc/rpc_helper.py`) and
tests/test_layout.py (the layout's placement properties over
seeded random clusters, `rpc/layout/`) run on the port through
`port_mirror`.  Every test of the three files runs."""

from torch_mirror import assert_mirror_whole, mirrored_tests, port_mirror, time_limit

_limit = time_limit(120)  # a stuck test ends its worker instead of the suite

PEER_HEALTH_LEFT_OUT = ()  # every scenario runs on the port
RPC_LEFT_OUT = ()
LAYOUT_LEFT_OUT = ()
peer_health_mirror = port_mirror("test_peer_health.py", PEER_HEALTH_LEFT_OUT)
globals().update(mirrored_tests(peer_health_mirror, "peer_health"))
rpc_mirror = port_mirror("test_rpc.py", RPC_LEFT_OUT)
globals().update(mirrored_tests(rpc_mirror, "rpc"))
layout_mirror = port_mirror("test_layout.py", LAYOUT_LEFT_OUT)
globals().update(mirrored_tests(layout_mirror, "layout"))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_peer_health.py", peer_health_mirror, PEER_HEALTH_LEFT_OUT, 11)
    assert_mirror_whole("test_rpc.py", rpc_mirror, RPC_LEFT_OUT, 5)
    assert_mirror_whole("test_layout.py", layout_mirror, LAYOUT_LEFT_OUT, 8)
