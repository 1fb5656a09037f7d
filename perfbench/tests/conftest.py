"""Shared pieces of the benchmark's tests: a tiny configuration and
traffic for CPU runs of the harness."""

from __future__ import annotations

import pytest

from perfbench import harness

TINY = {"name": "tiny", "k": 4, "m": 2, "block_size": 65536}
SEED = (1 << 31) + 12345


def tiny_traffic(kind: str) -> dict:
    traffic = harness.load_json(harness.BENCH_DIR / "traffic" / f"{kind}.json")
    # the check set is the whole pool: every completion is compared
    traffic.update(pool_bytes=1 << 21, warmup_s=0.3, check_bytes=1 << 21)
    if kind == "ingest":
        traffic.update(clients=2, blocks_in_flight=2)
    return traffic


def tiny_run(kind: str, trace: bool = False, codec_factory=None, seconds: float = 1.5,
             seed: int = SEED, **traffic_params) -> dict:
    """One run of a cell of `kind` on the CPU at the tiny size, through
    the port's EcCuda path (its plain versions) unless `codec_factory`
    replaces the codec; `traffic_params` replace the tiny traffic's."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["traffic"] == kind)
    traffic = tiny_traffic(kind)
    traffic.update(traffic_params)
    return harness.run_cell(cell, TINY, traffic, bench, seed, seconds, trace,
                            device="cpu", impl="xla", codec_factory=codec_factory,
                            log=lambda line: None)


@pytest.fixture
def cuda_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
