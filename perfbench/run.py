"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Earlier lines of standard output are
notes (sample counts, round sizes, the trace's totals); the last line is
the result object.  The numbers the check compared, each with its limit,
are the last lines of standard error.  Without a CUDA card, or with
fewer cards than the cell asks for, the run fails and prints no result;
so it does if the JAX stack or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THREADS = "4"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the harness's own threads, and every build cache inside the checkout
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = THREADS
    os.environ["USE_FLAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[0] = str(ROOT)  # not perfbench/: its module names stay its own

    from perfbench import harness

    bench, cell, cfg, traffic = harness.load_cell(args.workload, ROOT)
    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, cfg, traffic, bench, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t_start=T_START,
                              log=lambda line: print(line, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process, which the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
