"""On the card: each cell of BENCHMARK.json runs once through the
command, briefly, and comes out correct; a run without the program's
package fails.  Marked `cuda`; skips where there is no card.  The
window is long enough for a repair cell to cycle its pool once, so that
every lost rank of its check set is compared."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(cwd: Path, workload: str, trace: int = 0):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload, "--seed", "3000000003",
         "--seconds", "10", "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=1200)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_runs_correct(cuda_card, workload):
    proc = _run(ROOT, workload)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]


@pytest.mark.cuda
def test_no_result_without_the_program(cuda_card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, BENCH["workloads"][0]["name"])
    assert proc.returncode != 0
    assert not proc.stdout.strip().endswith("}")
