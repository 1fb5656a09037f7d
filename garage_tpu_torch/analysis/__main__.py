"""graft-lint for this package: run the analyzer over the repository.

    python -m garage_tpu_torch.analysis                       # lint garage_tpu_torch/
    python -m garage_tpu_torch.analysis garage_tpu_torch/block  # a subtree
    python -m garage_tpu_torch.analysis --rules host-sync     # one rule family
    python -m garage_tpu_torch.analysis --json                # machine-readable
    python -m garage_tpu_torch.analysis --write-baseline      # re-triage debt

Exit codes: 0 clean (every finding is baselined), 1 new violations (or,
with --strict, stale baseline entries), 2 usage error.

The committed baseline (garage_tpu_torch/analysis/lint_baseline.json)
is triaged debt: findings listed there stay visible without failing the
gate, new ones fail tests/test_torch_analysis.py.  Paths are relative to
the repository root.  The reference package is linted by
script/graft_lint.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .core import analyze, diff_baseline, load_baseline, write_baseline

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lint_baseline.json")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m garage_tpu_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs relative to the repository root (default: the package)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the new baseline")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule families (default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON (with per-rule timings)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    args = ap.parse_args(argv)

    rules = args.rules.split(",") if args.rules else None
    timings: dict[str, float] = {}
    try:
        violations = analyze(REPO, args.paths or None, rules, timings=timings)
    except ValueError as e:
        print(f"graft-lint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(BASELINE, violations)
        print(f"graft-lint: wrote {len(violations)} finding(s) to "
              f"{os.path.relpath(BASELINE, REPO)}")
        return 0

    try:
        baseline = load_baseline(BASELINE)
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        print(f"graft-lint: unreadable baseline {BASELINE}: {e}", file=sys.stderr)
        return 2
    new, stale = diff_baseline(violations, baseline)

    if args.as_json:
        print(json.dumps({
            "total": len(violations),
            "new": [v.__dict__ | {"key": v.key} for v in new],
            "baselined": len(violations) - len(new),
            "stale_baseline_keys": stale,
            "timings": {k: round(t, 4) for k, t in sorted(timings.items())},
        }, indent=2))
    else:
        for v in new:
            print(v.render())
        known = len(violations) - len(new)
        for k in stale:
            print(f"graft-lint: stale baseline entry (debt paid — re-run "
                  f"--write-baseline): {k}")
        if not new and not (stale and args.strict):
            print(f"graft-lint: clean ({len(violations)} total, {known} baselined, "
                  f"{len(stale)} stale)")
    if new or (stale and args.strict):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
