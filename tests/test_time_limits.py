"""`time_limit` (tests/time_limits.py) fails a stalled test where it stands,
lets its process go on only once the test's threads have ended, and ends a
process that will not unwind; every port test file that boots nodes on the
network or starts a process sets one, so a stall costs one test and not
the suite."""

import os
import re
import subprocess
import sys
import time

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
# the helpers that boot in-process nodes on the network, and a child process
WAITS = re.compile(r"\b(make_cluster|make_ec_cluster|boot_cluster|make_cluster_with_clients"
                   r"|make_daemon|make_block_cluster|make_table_cluster|make_node"
                   r"|subprocess\.Popen)\(")
LIMIT = re.compile(r"^\w+ = time_limit\(\d+\)", flags=re.M)

HEAD = """\
import asyncio
import threading
import time

from time_limits import time_limit

_limit = time_limit(2)
"""
STALLS = HEAD + """

def test_sleeps():
    time.sleep(60)


def test_waits_on_an_idle_loop():
    async def main():
        await asyncio.Event().wait()

    asyncio.run(main())


def test_stops_its_thread_as_it_unwinds():
    stop = threading.Event()

    def serve():
        stop.wait()
        time.sleep(0.5)  # a node's stop takes a while

    threading.Thread(target=serve, name="leftover", daemon=True).start()
    try:
        time.sleep(60)
    finally:
        stop.set()


def test_after():
    assert "leftover" not in {t.name for t in threading.enumerate()}
"""
# tests that do not let their process go on, the next one never runs, and
# faulthandler's banner: 2 s after the failure, or after its teardown
HELD = {
    "swallows_its_failure": ("""

def test_holds():
    try:
        time.sleep(60)
    except BaseException:
        time.sleep(60)
""", "Timeout (0:00:04)!"),
    "leaves_a_thread_running": ("""

def test_holds():
    threading.Thread(target=threading.Event().wait, name="leftover", daemon=True).start()
    time.sleep(60)
""", "Timeout (0:00:02)!"),
}
QUICK = """\
def test_one():
    pass


def test_two():
    pass
"""


def _python(*args, cwd, timeout=60):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": TESTS}, timeout=timeout)


def _pytest(tmp_path, files: dict, *args):
    """pytest run on `files` in `tmp_path`: its result and its seconds."""
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    t0 = time.monotonic()
    r = _python("-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly", *args,
                cwd=tmp_path)
    return r, time.monotonic() - t0


def test_a_stalled_test_dumps_its_stacks_and_fails_in_place(tmp_path):
    r, seconds = _pytest(tmp_path, {"test_stall.py": STALLS}, "-p", "no:xdist")
    assert seconds < 30
    assert r.returncode != 0
    assert r.stderr.count("Time limit: still running after 2 s") == 3, r.stderr
    assert re.search(r'File ".*test_stall\.py", line \d+ in test_sleeps', r.stderr), r.stderr
    # the file goes on, and the next test meets no thread of the failed one
    assert "3 failed, 1 passed" in r.stdout, r.stdout
    assert "Timeout (" not in r.stderr, r.stderr


@pytest.mark.parametrize("case", sorted(HELD))
def test_a_test_that_holds_its_process_ends_it(tmp_path, case):
    body, banner = HELD[case]
    text = HEAD + body + "\n\ndef test_after():\n    pass\n"
    r, seconds = _pytest(tmp_path, {"test_stall.py": text}, "-p", "no:xdist")
    assert seconds < 30
    assert r.returncode != 0
    assert banner in r.stderr, r.stderr
    assert re.search(r'File ".*test_stall\.py", line \d+ in test_holds', r.stderr), r.stderr
    assert "passed" not in r.stdout, r.stdout


def test_a_stall_that_ends_its_file_does_not_hold_an_xdist_run(tmp_path):
    """The stall last in its file, and files still queued: had the worker
    died, its replacement would wait for a next test forever."""
    files = {"test_a.py": HEAD + "\n\ndef test_a1():\n    pass\n\n\ndef test_a2():\n"
                                 "    time.sleep(60)\n"}
    files.update({f"test_{c}.py": QUICK for c in "bcdefgh"})
    r, seconds = _pytest(tmp_path, files, "-p", "xdist", "-n", "2", "--dist", "loadfile")
    assert seconds < 40
    assert "1 failed, 15 passed" in r.stdout, r.stdout + r.stderr


def test_the_helper_imports_no_torch(tmp_path):
    r = _python("-c", "import sys, time_limits; print(sorted(m for m in sys.modules"
                " if m.split('.')[0] in ('torch', 'garage_tpu_torch')))", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


# the port's test files; the reference's own are left as it wrote them
@pytest.mark.parametrize("name", sorted(f for f in os.listdir(TESTS)
                                        if f.startswith("test_torch_") and f.endswith(".py")))
def test_a_port_file_that_waits_on_nodes_or_processes_sets_a_time_limit(name):
    with open(os.path.join(TESTS, name)) as f:
        src = f.read()
    if WAITS.search(src):
        assert LIMIT.search(src), (
            f"{name} boots nodes or starts a process: it needs `_limit = time_limit(N)`")
