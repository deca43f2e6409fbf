"""CLI: `python -m repro_torch.analysis [--fail-on-findings] [--json out]`.

Prints every finding (suppressed ones tagged), writes the machine-readable
report when asked, and — under `--fail-on-findings` — exits 1 if any
finding survives the baseline.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import (DEFAULT_TARGETS, default_baseline_path,
                                  run_all, write_json)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="host-discipline linter of the serving loops")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 if any unsuppressed finding remains")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the findings report as JSON")
    ap.add_argument("--baseline", metavar="PATH",
                    default=default_baseline_path(),
                    help="suppression file (default: the reviewed "
                         "analysis/baseline.toml; pass '' to disable)")
    args = ap.parse_args(argv)

    live, muted, counters = run_all(baseline_path=args.baseline)
    for f in live:
        print(f.format())
    for f in muted:
        print(f"{f.format()}  [suppressed]")
    if args.json:
        write_json(args.json, live, muted, counters)
    print(f"analysis: {len(DEFAULT_TARGETS)} modules linted, "
          f"{len(live)} finding(s), {len(muted)} suppressed")
    if args.fail_on_findings and live:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
