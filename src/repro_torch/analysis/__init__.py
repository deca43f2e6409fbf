"""Static analysis of the port's serving stack (port of `repro.analysis`).

One engine over the reference's Finding/baseline vocabulary:

- `host_lint` walks the scheduler modules' ASTs and enforces the host
  side of the engines' contract: no per-step device math (HL201) or
  implicit syncs (HL202), no allocator mutation from a device step
  (HL203), `PoolExhausted` raised before a step (HL204), every CUDA-graph
  / compiled entry point declared in `__analysis__` (HL205).

The reference's second engine, the jaxpr auditor (JX101-JX106), is not
ported yet (ROADMAP, M11.4).

`run_all()` is the programmatic entry; `python -m repro_torch.analysis`
the CLI (`--fail-on-findings` exits 1 on any unsuppressed finding).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import (ALL_CHECKS, Finding, Suppression,
                                           default_baseline_path,
                                           load_baseline, report_json,
                                           split_suppressed, write_json)
from repro_torch.analysis.host_lint import DEFAULT_TARGETS, lint_all

__all__ = [
    "ALL_CHECKS", "DEFAULT_TARGETS", "Finding", "Suppression",
    "default_baseline_path", "lint_all", "load_baseline", "report_json",
    "run_all", "split_suppressed", "write_json",
]


def run_all(*, baseline_path: Optional[str] = None,
            targets: Sequence[str] = DEFAULT_TARGETS,
            ) -> Tuple[List[Finding], List[Finding], dict]:
    """Run the lint engine and apply the baseline.

    Returns (unsuppressed, suppressed, counters); `counters` is empty
    until the jaxpr auditor's counterpart exists (the reference's holds
    its compile-cache tallies). Pass `baseline_path=""` to skip
    suppression entirely."""
    findings = lint_all(targets)
    if baseline_path is None:
        baseline_path = default_baseline_path()
    sups = load_baseline(baseline_path) if baseline_path else []
    live, muted = split_suppressed(findings, sups)
    return live, muted, {}
