"""Port parity, the host-discipline lint (`repro_torch.analysis`) against
the reference's (`repro.analysis`): each HL check fires exactly once on a
seeded fixture, a module without `__analysis__` is flagged wholesale, the
baseline machinery keeps the reference's format and strictness (the
reference's own `baseline.toml` parses with the port's parser), the
report JSON keeps its keys, and the port's tree lints clean.

The fixtures are written from strings into `tmp_path` and only parsed,
never imported. Tolerance: exact (check IDs, lines, names)."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.analysis import findings as jfindings
from repro_torch.analysis import (ALL_CHECKS, Finding, load_baseline,
                                  report_json, run_all, split_suppressed)
from repro_torch.analysis import host_lint
from repro_torch.analysis.findings import (HL_LOOP_NUMERIC, HL_LOOP_SYNC,
                                           HL_TRACED_MUT, HL_TRACED_RAISE,
                                           HL_UNANNOTATED, JX_COMPILE_CACHE,
                                           JX_HOSTCALL, JX_PACKED_CAST,
                                           JX_PAGE_TILE, JX_TILE_DIVIDE,
                                           JX_VMEM)

ROOT = pathlib.Path(__file__).resolve().parents[1]

HEADER = '''\
import numpy as np
import torch

from repro_torch.models.paging import PageAllocator, PoolExhausted

__analysis__ = {
    "traced": ("FakeEngine._step",),
    "host_loop": ("FakeEngine.run",),
    "device_returning": (),
    "device_params": (),
    "host_objects": (),
}
'''

# one construct a check; everything else in it is clean
VIOLATIONS = HEADER + '''

class FakeEngine:
    def __init__(self):
        self.allocator = PageAllocator(4)

    def _step(self, tok):
        self.allocator.release([0])             # HL203: mutation in a step
        if tok.shape[0] == 0:
            raise PoolExhausted("dry inside the step")      # HL204
        return tok + 1

    def run(self, tok):
        out, z = [], None
        while len(out) < 4:
            tok = self._step(tok)
            z = torch.softmax(tok, 0)           # HL201: loop device math
            out.append(int(np.asarray(tok[0])))  # HL202: implicit sync
            out.append(tok[0].item())           # explicit read: clean
            if tok.shape[0] > 1:                # a host attribute: clean
                out.append(len(out))
        return out, z


def _double(x):
    return x * 2


fast_double = torch.compile(_double)            # HL205: undeclared target
'''

# the other forms of HL201, HL202 and HL205, one finding each
VARIANTS = {
    "math_method": (HL_LOOP_NUMERIC, '''
class FakeEngine:
    def _step(self, tok):
        return tok

    def run(self, tok):
        tok = self._step(tok)
        return tok.argmax(-1)
'''),
    "branch": (HL_LOOP_SYNC, '''
class FakeEngine:
    def _step(self, tok):
        return tok

    def run(self, n):
        pos = torch.zeros((), dtype=torch.int32, device="cuda")
        while pos < n:
            pos = self._step(pos)
'''),
    "float_of_copy": (HL_LOOP_SYNC, '''
class FakeEngine:
    def _step(self, tok):
        return tok

    def run(self, host, dev):
        x = torch.as_tensor(host).to(dev)
        return float(x)
'''),
    "decorator": (HL_UNANNOTATED, '''
class FakeEngine:
    def _step(self, tok):
        return tok

    def run(self, tok):
        return self._step(tok)


@torch.compile
def fused(x):
    return x * 2
'''),
    "graph_capture": (HL_UNANNOTATED, '''
class FakeEngine:
    def _step(self, tok):
        return tok

    def _other(self, tok):
        return tok

    def run(self, tok):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self._step(tok)
            self._other(tok)
        return g
'''),
}

# reads the lint must not flag: the explicit reads, CPU tensors, shapes
CLEAN = '''
class FakeEngine:
    def _step(self, tok):
        return tok

    def run(self, tok, host_bt):
        tok = self._step(tok)
        toks = tok[:, 0].tolist()
        first = int(tok[0].item())
        cpu = torch.as_tensor(host_bt, dtype=torch.int32)
        rows = int(cpu.sum())
        moved = tok.to("cpu")
        ok = bool(moved[0] > 0)
        n = int(tok.shape[0])
        for i, t in enumerate([tok]):
            if i == n:
                break
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self._step(tok)
        return toks, first, rows, ok, g
'''


def _lint(tmp_path, body, name="mod.py"):
    p = tmp_path / name
    p.write_text(body)
    return host_lint.lint_file(str(p), f"fixtures/{name}")


def test_check_ids_keep_the_reference_ids():
    """Every check ID is the reference's, in its order: the program
    audit's JX101-JX106 (`program_audit`), then the lint's HL201-HL205."""
    assert ALL_CHECKS == jfindings.ALL_CHECKS
    assert ALL_CHECKS == (JX_HOSTCALL, JX_PACKED_CAST, JX_TILE_DIVIDE,
                          JX_PAGE_TILE, JX_VMEM, JX_COMPILE_CACHE,
                          HL_LOOP_NUMERIC, HL_LOOP_SYNC, HL_TRACED_MUT,
                          HL_TRACED_RAISE, HL_UNANNOTATED)
    assert (JX_HOSTCALL, JX_PACKED_CAST, JX_TILE_DIVIDE, JX_PAGE_TILE,
            JX_VMEM, JX_COMPILE_CACHE) == (
        jfindings.JX_HOSTCALL, jfindings.JX_PACKED_CAST,
        jfindings.JX_TILE_DIVIDE, jfindings.JX_PAGE_TILE, jfindings.JX_VMEM,
        jfindings.JX_COMPILE_CACHE)
    assert (HL_LOOP_NUMERIC, HL_LOOP_SYNC, HL_TRACED_MUT, HL_TRACED_RAISE,
            HL_UNANNOTATED) == (jfindings.HL_LOOP_NUMERIC,
                                jfindings.HL_LOOP_SYNC,
                                jfindings.HL_TRACED_MUT,
                                jfindings.HL_TRACED_RAISE,
                                jfindings.HL_UNANNOTATED)


def test_each_host_check_fires_exactly_once(tmp_path):
    findings = _lint(tmp_path, VIOLATIONS)
    assert sorted(f.check for f in findings) == [
        HL_LOOP_NUMERIC, HL_LOOP_SYNC, HL_TRACED_MUT, HL_TRACED_RAISE,
        HL_UNANNOTATED], [f.format() for f in findings]
    assert all(f.file == "fixtures/mod.py" and f.line > 0 for f in findings)
    src = VIOLATIONS.splitlines()
    for f in findings:
        assert f.check in src[f.line - 1], (f.format(), src[f.line - 1])


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_check_variant_fires_exactly_once(tmp_path, name):
    check, body = VARIANTS[name]
    findings = _lint(tmp_path, HEADER + body)
    assert [f.check for f in findings] == [check], \
        [f.format() for f in findings]


def test_explicit_reads_and_host_values_are_clean(tmp_path):
    findings = _lint(tmp_path, HEADER + CLEAN)
    assert findings == [], [f.format() for f in findings]


def test_module_without_annotation_is_flagged_wholesale(tmp_path):
    findings = _lint(tmp_path, "import torch\n\nfast = torch.compile("
                               "lambda x: x)\n", "unannotated.py")
    assert [f.check for f in findings] == [HL_UNANNOTATED]


def test_unknown_host_loop_is_flagged(tmp_path):
    body = HEADER.replace('("FakeEngine.run",)', '("FakeEngine.gone",)')
    findings = _lint(tmp_path, body + "\n\nclass FakeEngine:\n"
                     "    def _step(self, t):\n        return t\n")
    assert [f.check for f in findings] == [HL_UNANNOTATED]
    assert "FakeEngine.gone" in findings[0].message


# ------------------------------------------------------------- baseline

def test_baseline_round_trip(tmp_path):
    p = tmp_path / "baseline.toml"
    p.write_text(
        '# reviewed\n'
        '[[suppress]]\n'
        'check = "HL202"\n'
        'contains = "SwapStore.put"\n'
        'reason = "one explicit copy a device by design"\n')
    sups = load_baseline(str(p))
    assert len(sups) == 1
    hit = Finding("HL202", "a.py", 1, "SwapStore.put", "asserting")
    miss = Finding("HL202", "a.py", 1, "SwapStore.pop", "asserting")
    live, muted = split_suppressed([hit, miss], sups)
    assert muted == [hit] and live == [miss]
    # the reference's parser reads the same file to the same entries
    assert [s.__dict__ for s in jfindings.load_baseline(str(p))] == \
        [s.__dict__ for s in sups]


@pytest.mark.parametrize("body,err", [
    ('[[suppress]]\ncheck = "HL201"\n', "reason"),      # no justification
    ('[[suppress]]\nreason = "x"\n', "check"),          # no check
    ('[[suppress]]\ncheck = HL201\nreason = "x"\n', "double-quoted"),
    ('[[suppress]]\ncheck = "HL201"\nreason = "x"\nfoo = "y"\n',
     "unknown"),
    ('what is this\n', "unparseable"),
], ids=["no-reason", "no-check", "unquoted", "unknown-key", "garbage"])
def test_malformed_baseline_is_a_hard_error(tmp_path, body, err):
    p = tmp_path / "baseline.toml"
    p.write_text(body)
    with pytest.raises(ValueError, match=err):
        load_baseline(str(p))
    with pytest.raises(ValueError, match=err):   # as the reference's
        jfindings.load_baseline(str(p))


def test_reference_baseline_parses():
    path = ROOT / "src" / "repro" / "analysis" / "baseline.toml"
    assert load_baseline(str(path)) == []
    assert jfindings.load_baseline(str(path)) == []


def test_report_json_matches_reference():
    f = Finding("HL201", "a.py", 3, "E.run", "m")
    g = Finding("HL202", "b.py", 0, "E.run", "n")
    assert report_json([f], [g], {}) == jfindings.report_json(
        [jfindings.Finding(**f.as_dict())],
        [jfindings.Finding(**g.as_dict())], {})
    assert f.format() == jfindings.Finding(**f.as_dict()).format()
    assert g.format() == jfindings.Finding(**g.as_dict()).format()


# ------------------------------------------------------------ clean tree

def test_clean_tree_reports_zero_unsuppressed_findings():
    """Every default target is annotated and lints clean; every
    suppression in the shipped baseline carries a reason (there are
    none). The program audit's half runs in
    tests/test_torch_program_audit.py."""
    live, muted, counters = run_all(programs=())
    assert live == [], [f.format() for f in live]
    assert muted == []
    assert all(s.reason for s in load_baseline(
        str(ROOT / "src" / "repro_torch" / "analysis" / "baseline.toml")))
    for rel in host_lint.DEFAULT_TARGETS:
        assert host_lint._Module(str(ROOT / rel), rel).ann is not None, rel


def test_serve_loops_are_declared():
    """The serving loops the lint reads are the engines' own: each
    declared step and host loop names a function of its module."""
    for rel in ("src/repro_torch/launch/serve.py",
                "src/repro_torch/launch/prefill.py",
                "src/repro_torch/models/paging.py"):
        m = host_lint._Module(str(ROOT / rel), rel)
        local = [q for q in m.ann["traced"] + m.ann["host_loop"]
                 if "." not in q or q.split(".")[0][0].isupper()]
        assert local and all(q in m.funcs for q in local), (rel, local)
    serve = host_lint._Module(str(ROOT / "src/repro_torch/launch/serve.py"),
                              "serve")
    assert "ContinuousBatchingEngine._run" in serve.ann["host_loop"]


def test_cli_fails_on_findings_only(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "report.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--fail-on-findings", "--json", str(out)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s), 0 suppressed" in r.stdout
    rep = json.loads(out.read_text())
    assert rep["counts"] == {"unsuppressed": 0, "suppressed": 0}


def test_cli_exit_code_follows_the_baseline(tmp_path, monkeypatch, capsys):
    """`--fail-on-findings` exits 1 while a finding survives the
    baseline, 0 once every finding is suppressed."""
    from repro_torch import analysis
    from repro_torch.analysis import __main__ as cli
    v = tmp_path / "v.py"
    v.write_text(VIOLATIONS)
    monkeypatch.setattr(cli, "run_all", lambda **k: analysis.run_all(
        targets=(str(v),), programs=(), **k))
    some = tmp_path / "some.toml"
    some.write_text('[[suppress]]\ncheck = "HL204"\nreason = "r"\n')
    assert cli.main(["--fail-on-findings", "--baseline", str(some)]) == 1
    assert "4 finding(s), 1 suppressed" in capsys.readouterr().out
    every = tmp_path / "every.toml"
    every.write_text("".join(f'[[suppress]]\ncheck = "{c}"\nreason = "r"\n'
                             for c in ALL_CHECKS))
    assert cli.main(["--fail-on-findings", "--baseline", str(every)]) == 0
    assert "0 finding(s), 5 suppressed" in capsys.readouterr().out
