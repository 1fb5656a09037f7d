"""The work counts against the bounds PERF.md's kernel table states."""

from __future__ import annotations

import json
from pathlib import Path

from perfbench.harness import load_roofline

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "roofline" / "peaks.json").read_text())


def test_k1_bound_of_a_full_encode_dispatch():
    roof = load_roofline()
    least = 64 * roof["k1"].bytes_moved(8, 3, 131072) / PEAKS["hbm_bytes_per_s"]
    assert abs(least * 1e3 - 0.027545) < 1e-6


def test_k2_bound_of_a_full_encode_dispatch():
    roof = load_roofline()
    assert roof["k2"].compressions(131072) == 2175
    rate = PEAKS["int32_lanes_per_sm_cycle"] * PEAKS["sms"] * PEAKS["sm_clock_hz"]
    least = 704 * roof["k2"].int_ops(131072) / rate
    assert abs(least * 1e3 - 0.041742) < 1e-6


def test_k2_compressions_of_short_and_uneven_lengths():
    k2 = load_roofline()["k2"]
    assert k2.compressions(0) == 1
    assert k2.compressions(64) == 1
    assert k2.compressions(1024) == 16
    assert k2.compressions(1025) == 16 + 1 + 1
    assert k2.compressions(3 * 1024) == 48 + 2


def test_transfer_is_read_from_the_trace_alone():
    from types import SimpleNamespace

    from perfbench.harness import reader

    spans = SimpleNamespace(blocks=lambda name: 40)
    for name in ("device_api.transfer_ms_per_block.ingest",
                 "device_api.transfer_ms_per_block.repair"):
        read = reader(name)
        assert read(SimpleNamespace(trace=None, spans=spans)) is None
        assert read(SimpleNamespace(trace={"copy_s": 0.2}, spans=spans)) == 5.0
