"""The port's utilities held to the reference's own unit tests on the
CPU: tests/test_util.py (config parsing and its secret files, data
helpers, migrations, the persister, bucket-name rules, the public
address), tests/test_crdt.py (the CRDTs'
merge laws) and tests/test_backoff.py (the shared retry ladder) run on
the port's `utils/` through `port_mirror`.  Every test of the three
files runs."""

from torch_mirror import assert_mirror_whole, mirrored_tests, port_mirror, time_limit

_limit = time_limit(60)  # a stuck test ends its worker instead of the suite

UTIL_LEFT_OUT = ()  # every scenario runs on the port
CRDT_LEFT_OUT = ()
BACKOFF_LEFT_OUT = ()
util_mirror = port_mirror("test_util.py", UTIL_LEFT_OUT)
globals().update(mirrored_tests(util_mirror, "util"))
crdt_mirror = port_mirror("test_crdt.py", CRDT_LEFT_OUT)
globals().update(mirrored_tests(crdt_mirror, "crdt"))
backoff_mirror = port_mirror("test_backoff.py", BACKOFF_LEFT_OUT)
globals().update(mirrored_tests(backoff_mirror, "backoff"))


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_util.py", util_mirror, UTIL_LEFT_OUT, 19)
    assert_mirror_whole("test_crdt.py", crdt_mirror, CRDT_LEFT_OUT, 11)
    assert_mirror_whole("test_backoff.py", backoff_mirror, BACKOFF_LEFT_OUT, 6)
