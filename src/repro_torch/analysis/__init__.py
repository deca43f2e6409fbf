"""Static analysis of the port's serving stack (port of `repro.analysis`).

Two engines over the reference's Finding/baseline vocabulary:

- `program_audit` runs the registered hot programs (`registry`) on small
  real tensors under a recorder and enforces the device side of the
  engines' contract: no host read or sync inside a step (JX101), packed
  planes decoded only inside a kernel (JX102), the kernels' unmasked
  tiles divide what they tile (JX103), page-sized key tiles in paged
  paths (JX104), shared memory under budget (JX105), one call signature
  per program under the engine's real shape set (JX106).
- `host_lint` walks the scheduler modules' ASTs and enforces the host
  side: no per-step device math (HL201) or implicit syncs (HL202), no
  allocator mutation from a device step (HL203), `PoolExhausted` raised
  before a step (HL204), every CUDA-graph / compiled entry point declared
  in `__analysis__` (HL205).

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
from repro_torch.analysis.program_audit import (ProgramSpec, audit_all,
                                                call_signature)
from repro_torch.kernels.build import SMEM_LIMIT

__all__ = [
    "ALL_CHECKS", "DEFAULT_TARGETS", "Finding", "ProgramSpec", "SMEM_LIMIT",
    "Suppression", "analysis_counters", "audit_all", "call_signature",
    "default_baseline_path", "lint_all", "load_baseline", "report_json",
    "run_all", "split_suppressed", "write_json",
]


def _programs(programs):
    if programs is not None:
        return programs
    from repro_torch.analysis.registry import default_programs
    return default_programs()


def run_all(*, smem_budget: int = SMEM_LIMIT,
            baseline_path: Optional[str] = None,
            targets: Sequence[str] = DEFAULT_TARGETS,
            programs: Optional[Sequence[ProgramSpec]] = None,
            ) -> Tuple[List[Finding], List[Finding], dict]:
    """Run both engines and apply the baseline.

    Returns (unsuppressed, suppressed, counters); `counters` carries the
    program audit's tallies (programs run, call signatures a program).
    `programs` defaults to the registry's, on the CPU. Pass
    `baseline_path=""` to skip suppression entirely."""
    findings, counters = audit_all(_programs(programs),
                                   smem_budget=smem_budget)
    findings += lint_all(targets)
    if baseline_path is None:
        baseline_path = default_baseline_path()
    sups = load_baseline(baseline_path) if baseline_path else []
    live, muted = split_suppressed(findings, sups)
    return live, muted, counters


def analysis_counters(*, smem_budget: int = SMEM_LIMIT,
                      programs=None) -> dict:
    """Just the program audit's counters (no lint pass): a benchmark can
    fold them into its output, so that a signature explosion shows next
    to the numbers it would poison."""
    _, counters = audit_all(_programs(programs), smem_budget=smem_budget)
    return counters
