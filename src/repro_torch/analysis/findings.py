"""Finding records, the reviewed baseline file, and machine-readable output
(port of `repro.analysis.findings`).

Every analyzer check reports `Finding`s: a stable check ID, a file:line
anchor, the program or lint scope the violation lives in, and a message.
Intentional exceptions are not silenced in code — they go through
`baseline.toml`, a reviewed suppression list whose entries must carry a
`reason`. The CLI (`python -m repro_torch.analysis`) loads the baseline,
splits findings into unsuppressed/suppressed, and exits non-zero on any
unsuppressed finding under `--fail-on-findings`.

The baseline parser is deliberately tiny: the file only ever holds
`[[suppress]]` tables of string keys, and a full TOML implementation
would be a dependency for nothing. The reference's baseline files parse
here unchanged.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

#: program-audit check IDs (repro_torch.analysis.program_audit), the
#: reference's jaxpr-auditor IDs
JX_HOSTCALL = "JX101"       # host read / device-to-host copy / sync in a
                            # hot program
JX_PACKED_CAST = "JX102"    # packed int8 plane cast to float outside a
                            # kernel / the registered meta-decode
JX_TILE_DIVIDE = "JX103"    # an unmasked tile of a kernel's launch plan
                            # does not divide its dimension
JX_PAGE_TILE = "JX104"      # packed-plane tile != page size in a paged /
                            # replay program
JX_VMEM = "JX105"           # a launch's shared memory over budget
JX_COMPILE_CACHE = "JX106"  # more than one call signature under the
                            # engine's real shape set

#: host-discipline linter check IDs (repro_torch.analysis.host_lint)
HL_LOOP_NUMERIC = "HL201"   # torch math inside the per-step host
                            # scheduler loop
HL_LOOP_SYNC = "HL202"      # implicit device sync (int()/np.asarray/if
                            # ...) on an engine tensor in the host loop
HL_TRACED_MUT = "HL203"     # PageAllocator/PrefixIndex/SwapStore mutation
                            # reachable from a device step
HL_TRACED_RAISE = "HL204"   # PoolExhausted raise site inside a device
                            # step (must precede it)
HL_UNANNOTATED = "HL205"    # CUDA-graph / torch.compile / torch.jit
                            # target missing from the module's
                            # __analysis__ traced list

ALL_CHECKS = (JX_HOSTCALL, JX_PACKED_CAST, JX_TILE_DIVIDE, JX_PAGE_TILE,
              JX_VMEM, JX_COMPILE_CACHE, HL_LOOP_NUMERIC, HL_LOOP_SYNC,
              HL_TRACED_MUT, HL_TRACED_RAISE, HL_UNANNOTATED)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: check ID + file:line anchor + scope + message."""
    check: str              # one of ALL_CHECKS
    file: str               # path of the violating code ("" = program-level)
    line: int               # 1-based source line (0 = whole file/program)
    program: str            # hot program name or lint scope qualname
    message: str

    def format(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else (self.file or "-")
        return f"{self.check} {loc} [{self.program}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One reviewed baseline entry. Matching is by check ID plus optional
    file-path and message/program substrings; `reason` is mandatory — an
    unexplained suppression is a config error, not a review artifact."""
    check: str
    file: str = ""
    contains: str = ""
    reason: str = ""

    def matches(self, f: Finding) -> bool:
        if self.check and self.check != f.check:
            return False
        if self.file and self.file not in f.file.replace(os.sep, "/"):
            return False
        if self.contains and self.contains not in f.message \
                and self.contains not in f.program:
            return False
        return True


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.toml")


def load_baseline(path: str) -> List[Suppression]:
    """Parse the `[[suppress]]` tables of a baseline file.

    Accepts the subset of TOML the baseline actually uses: `[[suppress]]`
    section headers, `key = "string"` pairs, comments, blank lines.
    Anything else is a hard error — a malformed baseline must never
    silently suppress nothing (or everything)."""
    sups: List[Suppression] = []
    current: Dict[str, str] = {}
    in_table = False

    def flush():
        nonlocal current
        if not in_table:
            return
        if "check" not in current:
            raise ValueError(f"{path}: [[suppress]] entry missing 'check'")
        if not current.get("reason"):
            raise ValueError(
                f"{path}: suppression of {current['check']} has no "
                f"'reason' — baseline entries must be justified")
        unknown = set(current) - {"check", "file", "contains", "reason"}
        if unknown:
            raise ValueError(f"{path}: unknown suppression keys {unknown}")
        sups.append(Suppression(**current))
        current = {}

    with open(path) as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[suppress]]":
                flush()
                in_table = True
                continue
            if "=" in line and in_table:
                key, _, val = line.partition("=")
                key, val = key.strip(), val.strip()
                if val.startswith('"') and val.endswith('"') and len(val) >= 2:
                    val = val[1:-1]
                else:
                    raise ValueError(
                        f"{path}:{lineno}: values must be double-quoted "
                        f"strings, got {val!r}")
                current[key] = val
                continue
            raise ValueError(f"{path}:{lineno}: unparseable line {line!r}")
    flush()
    return sups


def split_suppressed(findings: Iterable[Finding],
                     suppressions: Sequence[Suppression]
                     ) -> Tuple[List[Finding], List[Finding]]:
    """-> (unsuppressed, suppressed)."""
    live, muted = [], []
    for f in findings:
        (muted if any(s.matches(f) for s in suppressions) else live).append(f)
    return live, muted


def report_json(unsuppressed: Sequence[Finding],
                suppressed: Sequence[Finding],
                counters: dict) -> dict:
    """Machine-readable report; `counters` (the program audit's) under
    "compile_cache", as the reference writes its jaxpr auditor's."""
    return {
        "findings": [f.as_dict() for f in unsuppressed],
        "suppressed": [f.as_dict() for f in suppressed],
        "counts": {
            "unsuppressed": len(unsuppressed),
            "suppressed": len(suppressed),
        },
        "compile_cache": counters,
    }


def write_json(path: str, unsuppressed: Sequence[Finding],
               suppressed: Sequence[Finding], counters: dict) -> None:
    with open(path, "w") as fh:
        json.dump(report_json(unsuppressed, suppressed, counters), fh,
                  indent=2, sort_keys=True)
        fh.write("\n")
