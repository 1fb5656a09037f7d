"""BENCHMARK.json names only files that are there, in the shapes the
harness finds by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
        assert (ROOT / configs[cell["config"]]["file"]).is_file()
        traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json")
                             .read_text())
        from perfbench.harness import kind_of

        kind = kind_of(traffic)
        assert callable(kind.drive) and callable(kind.compare)


@pytest.mark.parametrize("kind", ["no_such_kind", "../harness", "Ingest", None])
def test_a_traffic_kind_without_its_file_fails(kind):
    from perfbench.harness import kind_of

    with pytest.raises(SystemExit):
        kind_of({"kind": kind})


def test_roofline_files_are_found_by_name():
    from perfbench.harness import load_roofline

    roof = load_roofline()
    names = {p.stem for p in (ROOT / "perfbench" / "roofline").glob("*.py")}
    assert names <= set(roof) and "peaks" in roof


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert (ROOT / "perfbench" / "metrics" / f"{metric['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for metric in BENCH["per_layer"]:
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    from perfbench.harness import metrics_of

    for cell in BENCH["workloads"]:
        e2e = [m["name"] for m in metrics_of(BENCH, cell["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert metrics_of(BENCH, cell["name"], True)
