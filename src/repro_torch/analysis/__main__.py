"""CLI: `python -m repro_torch.analysis [--fail-on-findings] [--json out]`.

Runs the program audit (JX101-JX106, the registered programs on the CPU,
through the kernels' plain versions; `chip_smoke.py`'s audit phase runs
them on the card) and the host lint (HL201-HL205); prints every finding
(suppressed ones tagged), writes the machine-readable report when asked,
and — under `--fail-on-findings` — exits 1 if any finding survives the
baseline.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import (DEFAULT_TARGETS, SMEM_LIMIT,
                                  default_baseline_path, run_all, write_json)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="program invariant auditor + host-discipline linter")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 if any unsuppressed finding remains")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the findings report as JSON")
    ap.add_argument("--baseline", metavar="PATH",
                    default=default_baseline_path(),
                    help="suppression file (default: the reviewed "
                         "analysis/baseline.toml; pass '' to disable)")
    ap.add_argument("--smem-budget", type=int, default=SMEM_LIMIT,
                    help="shared memory a kernel block may take, in "
                         "bytes, for JX105 (default: %(default)s)")
    args = ap.parse_args(argv)

    live, muted, counters = run_all(smem_budget=args.smem_budget,
                                    baseline_path=args.baseline)
    for f in live:
        print(f.format())
    for f in muted:
        print(f"{f.format()}  [suppressed]")
    if args.json:
        write_json(args.json, live, muted, counters)
    per_program = counters.get("signatures_per_program", {})
    print(f"analysis: {counters.get('programs_traced', 0)} programs "
          f"audited ({sum(per_program.values())} signatures), "
          f"{len(DEFAULT_TARGETS)} modules linted, {len(live)} finding(s), "
          f"{len(muted)} suppressed")
    if args.fail_on_findings and live:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
