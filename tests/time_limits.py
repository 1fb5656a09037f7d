"""`time_limit`: a per-file clock for test modules, with no torch.

A test module that boots nodes or starts a process sets
`_limit = time_limit(N)`.  A test of it still running after `N` seconds
dumps every thread's stack and fails where it stands.  Its process goes on
to the next test only clean: once the failed test has unwound and every
thread it started has ended.  Otherwise the process ends `min(N, 60)`
seconds after the failure, or after its teardown, dumping the stacks
again.

Failing in place matters under `-n 6 --dist loadfile`: when a worker dies,
pytest-xdist queues the dead test and the rest of its file again for a
replacement worker, which runs the stalled test again, and if that is one
test while other files still wait in the queue, the replacement holds it
waiting for a next test that never comes, and the run hangs to its clock.
"""

import faulthandler
import os
import signal
import threading

import pytest


class TimeLimitExceeded(SystemExit):
    """The test outlived its file's time limit.  A `SystemExit`, so that an
    event loop's callbacks let it through, where they log other errors;
    pytest reports it as the test's failure."""


def time_limit(seconds: float):
    """An autouse fixture for a test module: a test still running after
    `seconds` dumps every thread's stack and fails; its process ends if the
    test, or a thread it started, is still running `min(seconds, 60)`
    seconds later, so no test can hold the suite past its clock or leave
    its nodes running under the next one."""
    grace = min(seconds, 60)

    @pytest.fixture(autouse=True)
    def _time_limit(request):
        # the stacks go to the stderr the run started with: while a test
        # runs, pytest's capture holds fd 2, and its file dies unread with
        # the process
        capture = request.config.pluginmanager.getplugin("capturemanager")
        with capture.global_and_fixture_disabled():
            stderr = os.dup(2)
        before = set(threading.enumerate())
        expired = False

        def expire(signum, frame):
            nonlocal expired
            expired = True
            os.write(stderr, f"\nTime limit: still running after {seconds} s\n".encode())
            faulthandler.dump_traceback(file=stderr)
            raise TimeLimitExceeded(f"still running after the file's time limit of {seconds} s")

        faulthandler.dump_traceback_later(seconds + grace, exit=True, file=stderr)
        previous = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, seconds)
        yield
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        if expired:
            # pytest cancels faulthandler's clock as it reports a failure:
            # a thread the failed test left running ends the process at a
            # new one, before the next test can meet it
            faulthandler.dump_traceback_later(grace, exit=True, file=stderr)
            for thread in set(threading.enumerate()) - before:
                thread.join()
        faulthandler.cancel_dump_traceback_later()
        os.close(stderr)

    return _time_limit
