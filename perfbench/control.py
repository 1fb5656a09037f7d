"""The control of the check: the plain reference in the program's place,
with one of the configuration's guarantees broken (every parity piece
the XOR of the data shards, so not every k of the k+m pieces rebuild a
block).  Its runs have to come out not correct; their compared numbers
set the upper readings the limits are kept below.

    python3 perfbench/control.py --workload ec8-3.ingest --seconds 10 \
        --seeds 3000000011,3000000023,3000000037

Every seed runs in this one process at the cell's own size and load, on
the card.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    from perfbench import harness
    from perfbench.reference.codec import ReferenceCodec

    bench, cell, cfg, traffic = harness.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(
            cell, cfg, traffic, bench, seed, args.seconds, False, device=args.device,
            codec_factory=lambda k, m, _dev: ReferenceCodec(k, m, parity="xor"),
            log=lambda line: print(line, flush=True))
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "failed": result["failed"], "compared": result["compared"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
