"""The check fails what it must: the control (the reference with the
XOR code in the program's place), and the timed path broken underneath
in each way a cell of this benchmark can break, all driven through the
rest of a run at a tiny size on the CPU.  (No cell spans cards, so no
exchange between cards can be left out.)"""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.reference.codec import ReferenceCodec
from perfbench.tests.conftest import TINY, tiny_run

TINY_PIECES = TINY["k"] + TINY["m"]


def _failed(result: dict) -> list[str]:
    out = []
    for name, c in result["compared"].items():
        rule, limit = c["limit"].split()
        ok = c["value"] <= int(limit) if rule == "<=" else c["value"] >= int(limit)
        if not ok:
            out.append(name)
    return out


@pytest.mark.parametrize("kind", ["ingest", "repair"])
def test_sound_runs_are_correct(kind):
    result = tiny_run(kind)
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("kind", ["ingest", "repair"])
def test_control_is_not_correct(kind):
    result = tiny_run(kind, codec_factory=lambda k, m, _d: ReferenceCodec(k, m, parity="xor"))
    assert not result["correct"]
    assert "pieces_wrong" in _failed(result) or "verdicts_wrong" in _failed(result)


def _broken(fault: str, kind: str):
    """The port's codec with its device API broken: the step's output
    left as allocated (zeros), the second half of each batch given the
    first half's results, or one byte of the output altered."""
    from garage_tpu_torch.block.codec.ec import EcCodec

    def spoil(out: np.ndarray) -> np.ndarray:
        out = np.array(out)
        if fault == "unchanged":
            out[...] = 0
        elif fault == "half_batch":
            half = out.shape[0] // 2
            out[out.shape[0] - half:] = out[:half]
        else:
            out[0, 0, 0] ^= 1
        return out

    def factory(k, m, device):
        codec = EcCodec(k, m, device=device)
        ec = codec._ec
        if kind == "ingest":
            encode = ec.encode_and_hash

            def encode_and_hash(data):
                parity, hashes = encode(data)
                return spoil(parity), (spoil(hashes) if fault == "unchanged" else hashes)

            ec.encode_and_hash = encode_and_hash
        else:
            reconstruct = ec.reconstruct
            ec.reconstruct = lambda shards, present, want: spoil(reconstruct(shards, present, want))
        return codec

    return factory


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("kind", ["ingest", "repair"])
def test_a_broken_timed_path_is_not_correct(kind, fault):
    result = tiny_run(kind, codec_factory=_broken(fault, kind))
    assert not result["correct"], (kind, fault, result["compared"])
    assert _failed(result)


def _one_pattern_wrong(lost_rank: int):
    """The port's codec whose reconstruction alters a byte of the piece
    it rebuilds for one lost rank only."""
    from garage_tpu_torch.block.codec.ec import EcCodec

    def factory(k, m, device):
        codec = EcCodec(k, m, device=device)
        reconstruct = codec.reconstruct_batch

        def reconstruct_batch(batches, impl="auto"):
            out = reconstruct(batches, impl)
            for rec in out:
                if lost_rank in rec:
                    bad = bytearray(rec[lost_rank])
                    bad[0] ^= 1
                    rec[lost_rank] = bytes(bad)
            return out

        codec.reconstruct_batch = reconstruct_batch
        return codec

    return factory


@pytest.mark.parametrize("lost_rank", [0, 5])
def test_every_erasure_pattern_is_compared(lost_rank):
    """With no check blocks drawn by bytes, the one block of each lost
    rank still catches a reconstruction wrong for that rank alone."""
    sound = tiny_run("repair", check_bytes=0)
    assert sound["correct"], sound["compared"]
    assert sound["compared"]["patterns"]["value"] == TINY_PIECES
    result = tiny_run("repair", codec_factory=_one_pattern_wrong(lost_rank), check_bytes=0)
    assert not result["correct"]
    assert "pieces_wrong" in _failed(result)
