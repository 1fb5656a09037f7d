"""The port's codec X-ray and sampling profiler held to the reference's
own tests on the CPU: tests/test_codec_xray.py (pad-waste accounting,
first-call-wins pad geometry, one compile event per cold shape class,
the overlap-efficiency gauge, batcher lane linger joined with its flush
reason, collapsed stacks with the event-loop tag, profiler stop and
overhead, the stall profiler and the watchdog hook; the 11-node EC(8,3)
federation keeps its `slow` mark) runs on the port through
`port_mirror`.

Left out: `test_instrumented_cache_hit_records_no_compile_time`, which
drives the reference's jit memoizer (`utils/compile_cache.py`, with its
module-level import dropped from the mirror); the port has no jit
cache.  Its counterpart here holds the port's compile cache, the nvcc
build cache (`ops/_build.py`), to the same rule: a miss is timed as a
compile event, a hit records none."""

import os
import sys

import torch

from garage_tpu_torch.ops import _build, telemetry
from garage_tpu_torch.utils.metrics import Metrics
from torch_mirror import (assert_mirror_whole, mirrored_tests, port_mirror, refusing_skips,
                          time_limit)

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "script"))

_limit = time_limit(120)  # a stuck test ends its worker instead of the suite

XRAY_LEFT_OUT = ("test_instrumented_cache_hit_records_no_compile_time",)
XRAY_DROPPED = (
    "from garage_tpu.utils.compile_cache import instrumented_cache  # noqa: E402",
)
xray_mirror = port_mirror("test_codec_xray.py", XRAY_LEFT_OUT, drop=XRAY_DROPPED)
globals().update(refusing_skips(mirrored_tests(xray_mirror, "codec_xray")))
fresh_xray = xray_mirror.fresh_xray  # the mirrored tests' fixture

# stands in for nvcc: writes an empty file where `-o` says
FAKE_NVCC = """#!/bin/sh
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then : > "$2"; fi
  shift
done
echo "ptxas info    : 0 bytes stack frame"
"""


def test_mirror_holds_every_reference_scenario():
    assert_mirror_whole("test_codec_xray.py", xray_mirror, XRAY_LEFT_OUT, 12)
    assert "compile_cache" not in xray_mirror.mirror_source


def test_build_cache_hit_records_no_compile_time(tmp_path, monkeypatch):
    """The nvcc build cache, the port's compile cache: the first build
    of a source is a miss and one compile event under its cache label; a
    process that finds the digest-named library built is a hit and
    records no compile time.  The exposition passes the reference's
    strict lint, whose label sets bound the compile family's caches."""
    from dashboard_lint import lint_exposition

    r = Metrics()
    monkeypatch.setattr(telemetry, "registry", r)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    src = tmp_path / "probe.cu"
    src.write_text("// a kernel source\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "SIGNATURES", {"probe": {}})
    monkeypatch.setattr(_build, "SOURCES", {"probe": src})
    monkeypatch.setattr(_build, "BUILD_CACHES", {"probe": "ec_apply"})
    monkeypatch.setattr(_build, "_bind", lambda name, path: path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_logs", {})
    lbl = (("cache", "ec_apply"),)

    def counts():
        return (r.counters.get(("tpu_compile_cache_miss_total", lbl), 0),
                r.counters.get(("tpu_compile_cache_hit_total", lbl), 0),
                r.durations.get(("tpu_compile_duration", lbl), (0, 0.0, None))[0])

    secs = _build.build_all()
    assert secs["probe"] > 0 and _build._target("probe").exists()
    assert counts() == (1, 0, 1)  # miss: built and timed
    assert _build.lib("probe") == _build._target("probe")
    assert counts() == (1, 0, 1)  # loaded in this process: no lookup
    monkeypatch.setattr(_build, "_libs", {})  # a new process, the library on disk
    assert _build.build_all() == {"probe": 0.0}
    assert counts() == (1, 1, 1)  # hit: no compile time
    lint_exposition("\n".join(r.render()) + "\n")
