"""The port's host sanitizer job (`garage_tpu_torch/tools/sanitize_native.py`):
the port's own `_native/{gf8,blake3,kvlog}.cpp` built under ASan, UBSan
and TSan, the oracle cross-checks and the kvlog smokes run through the
ctypes binding in a child that preloads the runtime.  Slow-marked, as
the reference's `tests/test_sanitize_smoke.py` is: each mode pays a g++
build.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sanitize.py -m slow
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOOL = [sys.executable, "-m", "garage_tpu_torch.tools.sanitize_native"]


def _run(*args: str) -> subprocess.CompletedProcess:
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    return subprocess.run([*TOOL, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=900)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["--asan", "--ubsan"])
def test_sanitized_native_library(mode):
    r = _run(mode)
    assert r.returncode == 0, f"{mode} failed (rc {r.returncode}):\n{r.stdout}\n{r.stderr}"
    name = mode.lstrip("-")
    assert "gf8_apply and blake3 agree with the oracles" in r.stdout
    assert f"{name}: kvlog group-commit smoke clean" in r.stdout
    assert f"{name}: sanitized native library clean" in r.stdout


@pytest.mark.slow
def test_sanitize_all_summary():
    """--all runs tsan, asan and ubsan, each in a process of its own, and
    prints one summary table with a PASS row per mode."""
    r = _run("--all")
    assert r.returncode == 0, f"--all failed (rc {r.returncode}):\n{r.stdout}\n{r.stderr}"
    assert "sanitize-native summary" in r.stdout
    for mode in ("tsan", "asan", "ubsan"):
        assert f"{mode}\tPASS" in r.stdout, r.stdout
