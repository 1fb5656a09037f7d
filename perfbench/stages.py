"""The program's own stage families over the window, for the per-layer
metrics that read them: `block_codec_stage_duration{op,stage}` (host
seconds of each use of a codec-plane stage) and
`block_codec_stage_blocks_total{op,stage}` (the blocks those uses
carried; pieces for `wrap`), which the port records where each stage
runs (its `ops/telemetry.py` lists the stages).  A run of a program
without them reads nothing here, and its metrics are left out."""

from __future__ import annotations

DURATION = "block_codec_stage_duration"
BLOCKS = "block_codec_stage_blocks_total"
INGEST = ("encode",)  # the ops of an ingest cell's codec stages
REPAIR = ("decode", "reconstruct")  # a repair round's: the verify, the rebuild
STORE = (None,)  # the piece store's stages carry no op


def _labels(stage: str, op: str | None) -> dict:
    return {"stage": stage} if op is None else {"stage": stage, "op": op}


def uses_and_seconds(run, stage: str, ops=STORE) -> tuple[int, float]:
    """(uses, seconds) of `stage` in the window, summed over `ops`."""
    uses, secs = 0, 0.0
    for op in ops:
        n, s = run.reg.histogram(DURATION, **_labels(stage, op))
        uses += n
        secs += s
    return uses, secs


def blocks(run, stage: str, ops=STORE) -> float:
    """Blocks (pieces for `wrap`) that `stage` carried in the window,
    summed over `ops`."""
    return sum(run.reg.counter(BLOCKS, **_labels(stage, op)) for op in ops)


def ms_per_block(run, stage: str, ops, per: str, per_ops) -> float | None:
    """ms of `stage` (over `ops`) per block carried by stage `per` (over
    `per_ops`); None where `stage` never ran or `per` carried nothing."""
    uses, secs = uses_and_seconds(run, stage, ops)
    n = blocks(run, per, per_ops)
    return 1e3 * secs / n if uses and n else None
