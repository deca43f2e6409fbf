"""Port parity, the program audit (`repro_torch.analysis.program_audit`,
`repro_torch.analysis.registry`) against the reference's jaxpr auditor
(`repro.analysis.jaxpr_audit`, `repro.analysis.registry`).

- Each JX check fires exactly once, and nothing else, on its seeded torch
  program (tests/fixtures/torch_analysis/program_violations.py, the port's
  counterpart of the reference's JX_CASES), anchored at the line that
  violates it; a read inside a tensor-parallel shard's run is seen; a
  float plane that a kernel decodes is clean.
- JX106 fires once on a shape-polymorphic program; `call_signature` is a
  call's graph identity (shape, dtype, device, static values, structure).
- Every launch plan check is evaluated by the kernel's own plan function.
- The registry's program names are the reference's (its TP programs
  included), its dispatchers and meta-decode sources the reference's
  with the package renamed; every registered program audits clean on the
  CPU through `run_all` (`tests/test_torch_analysis.py` holds the CLI).
Tolerance: exact (check IDs, lines, names, counts).
"""
import importlib.util
import inspect
import os
import pathlib

import numpy as np
import pytest
import torch

from repro.analysis import findings as jfindings
from repro_torch.analysis.findings import (ALL_CHECKS, JX_COMPILE_CACHE,
                                           JX_HOSTCALL, JX_PACKED_CAST,
                                           JX_PAGE_TILE, JX_TILE_DIVIDE,
                                           JX_VMEM)
from repro_torch.analysis.program_audit import (ProgramSpec, audit_program,
                                                call_signature, plan_checks)
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "torch_analysis" / \
    "program_violations.py"
REL = os.path.relpath(FIXTURE, ROOT)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx():
    spec = importlib.util.spec_from_file_location("program_violations",
                                                  FIXTURE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rng(seed=0):
    return np.random.default_rng(seed)


def _codes(shape, seed=0):
    return torch.as_tensor(_rng(seed).integers(-7, 8, shape),
                           dtype=torch.int8)


def _meta(shape, seed=1):
    return torch.as_tensor(_rng(seed).integers(0, 64, shape),
                           dtype=torch.int8)


def _f32(shape, seed=2):
    return torch.as_tensor(_rng(seed).standard_normal(shape),
                           dtype=torch.float32)


def _contiguous():
    """q [1, 1, 2, 8] over contiguous planes of 32 keys, 1 KV head."""
    shape = (1, 32, 1, 8)
    return (_f32((1, 1, 2, 8)), _codes(shape, 3), _meta(shape, 4),
            torch.tensor(0.1), _codes(shape, 5), _meta(shape, 6),
            torch.tensor(0.1), torch.arange(32, dtype=torch.int32)[None],
            torch.tensor(31, dtype=torch.int32))


def _paged():
    """q [2, 1, 2, 8] over 4 pages of 16 keys, 2 blocks a slot."""
    shape = (4, 16, 1, 8)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    return (_f32((2, 1, 2, 8)), _codes(shape, 3), _meta(shape, 4),
            torch.full((2,), 0.1), _codes(shape, 5), _meta(shape, 6),
            torch.full((2,), 0.1), bt,
            torch.tensor([20, 5], dtype=torch.int32))


def _tp():
    from repro_torch.launch.mesh import make_tp_mesh
    mesh = make_tp_mesh(2, devices=["cpu", "cpu"])
    return mesh, _f32((1, 1, 4, 8)), [_codes((1, 8, 1, 8), s)
                                      for s in (0, 1)]


# (fixture program, argument maker, ProgramSpec keywords, smem budget,
# the one check it fires)
JX_CASES = [
    ("hostcall", lambda: (_f32((4,)),), {}, None, JX_HOSTCALL),
    ("tp_hostcall", _tp, {}, None, JX_HOSTCALL),
    ("packed_cast", lambda: (_codes((8, 16)),), {}, None, JX_PACKED_CAST),
    ("laundered_cast", lambda: (_codes((8, 16)),), {}, None,
     JX_PACKED_CAST),
    ("tile_misdivide", lambda: (_codes((4, 15)), _meta((4, 15))), {}, None,
     JX_TILE_DIVIDE),
    ("page_tile_mismatch", _contiguous, {"page_size": 16}, None,
     JX_PAGE_TILE),
    # K2's block at G 2, hd 8, pages of 16: 3,992 bytes, over a 1 KiB
    # test budget and far under the card's
    ("smem_hog", _paged, {}, 1024, JX_VMEM),
]


@pytest.mark.parametrize("name,make,kw,budget,check", JX_CASES,
                         ids=[c[0] for c in JX_CASES])
def test_program_check_fires_exactly_once(fx, name, make, kw, budget,
                                          check):
    spec = ProgramSpec(name, getattr(fx, name), [make], **kw)
    findings, n_sig = audit_program(
        spec, **({} if budget is None else {"smem_budget": budget}))
    assert [f.check for f in findings] == [check], \
        [f.format() for f in findings]
    assert n_sig == 1
    f = findings[0]
    assert f.program == name
    assert f.file == REL and f.line > 0, f.format()
    src = inspect.getsource(getattr(fx, name))
    line = FIXTURE.read_text().splitlines()[f.line - 1].strip()
    assert line and line in src, (f.format(), line)


def test_compile_cache_check_fires_exactly_once(fx):
    spec = ProgramSpec("shape_polymorphic", fx.shape_polymorphic,
                       [(_f32((4,)),), (_f32((8,)),)])
    findings, n_sig = audit_program(spec)
    assert [f.check for f in findings] == [JX_COMPILE_CACHE]
    assert n_sig == 2
    same = ProgramSpec("shape_polymorphic", fx.shape_polymorphic,
                       [(_f32((4,)),), (_f32((4,), 9),)])
    assert audit_program(same) == ([], 1)
    off = ProgramSpec("shape_polymorphic", fx.shape_polymorphic,
                      [(_f32((4,)),), (_f32((8,)),)], audit_cache=False)
    assert audit_program(off) == ([], 2)


def test_kernel_decode_is_clean(fx):
    """The same packed plane made float by K6's float mode (inside the
    kernel, a meta-decode source) is no JX102 finding, and the recorder
    counts its one launch."""
    spec = ProgramSpec("kernel_decode", fx.kernel_decode, [
        (_codes((4, 16)), _meta((4, 16)), torch.tensor(0.5))])
    st = {}
    assert audit_program(spec, stats=st) == ([], 1)
    assert st == {"plain_route_reads": 0, "dispatches": 1}


def test_every_check_id_is_covered_by_a_fixture():
    """The seeded corpora (these JX cases, tests/test_torch_analysis.py's
    HL ones) span the whole catalog, which is the reference's."""
    seeded = {c[4] for c in JX_CASES} | {JX_COMPILE_CACHE} | {
        "HL201", "HL202", "HL203", "HL204", "HL205"}
    assert seeded == set(ALL_CHECKS) == set(jfindings.ALL_CHECKS)
    assert (JX_HOSTCALL, JX_PACKED_CAST, JX_TILE_DIVIDE, JX_PAGE_TILE,
            JX_VMEM, JX_COMPILE_CACHE) == (
        jfindings.JX_HOSTCALL, jfindings.JX_PACKED_CAST,
        jfindings.JX_TILE_DIVIDE, jfindings.JX_PAGE_TILE, jfindings.JX_VMEM,
        jfindings.JX_COMPILE_CACHE)


def test_call_signature_is_graph_identity():
    """As the reference's `test_call_signature_is_jit_cache_identity`,
    plus the device and the fields of a dataclass argument."""
    from repro_torch.models.paging import ChunkMeta

    def sig(*args, **kw):
        return call_signature(args, kw or None)
    x, y = _f32((4, 2)), _f32((4, 2), 7)
    assert sig(x, 3) == sig(y, 3)                   # same shapes/statics
    assert sig(x, 3) != sig(_f32((8, 2)), 3)        # shape
    assert sig(x, 3) != sig(x.to(torch.float64), 3)  # dtype
    assert sig(x, 3) != sig(x, 4)                   # static value
    assert sig(x, steps=3) != sig(x, 3)             # tree structure
    assert sig(x, 3) != sig(x.to("meta"), 3)        # device
    i32 = torch.zeros(8, dtype=torch.int32)
    m = ChunkMeta(i32, i32, i32, i32[:2], i32[:4])
    assert sig(m) == sig(ChunkMeta(i32 + 1, i32, i32, i32[:2], i32[:4]))
    assert sig(m) != sig(ChunkMeta(i32, i32, i32, i32[:4], i32[:4]))
    assert sig(m) != sig(tuple(m))                  # the named type
    assert sig({"a": x}) != sig({"b": x})
    assert sig(np.zeros(3)) != sig(np.zeros(4))     # a host array's shape


def test_plan_checks_are_the_kernels_own():
    """The launch geometry each dispatcher reports is evaluated by its
    kernel's plan functions: K1's tile plan and shared memory, K3's
    instantiation, K2 / K5's split body, K7's block."""
    from repro_torch.kernels import sparq_decode_attn as dec
    from repro_torch.kernels import sparq_matmul as mm
    from repro_torch.kernels.build import SMEM_LIMIT
    cpu = torch.device("cpu")
    p = mm.plan(2048, 5632, 2048, 132)
    assert mm.smem_bytes(p) == 4 * (p.bm * 64 + 64 * 128)
    assert plan_checks("sparq_matmul", dict(M=2048, N=5632, K=2048,
                                            device=cpu), None) == []
    assert [c for c, _ in plan_checks(
        "sparq_matmul", dict(M=8, N=64, K=63, device=cpu), None)] == \
        [JX_TILE_DIVIDE]
    assert [c for c, _ in plan_checks(
        "sparq_matmul", dict(M=8, N=64, K=64, device=cpu), None,
        smem_budget=mm.smem_bytes(mm.plan(8, 64, 64)) - 1)] == [JX_VMEM]
    # K2 at granite's G 48, hd 128, page 128: the chunked split fits
    geo = dict(G=48, hd=128, page=128, NB=4)
    assert dec.smem_bytes(48, 128, 128) <= SMEM_LIMIT
    assert plan_checks("sparq_paged_decode_attn", geo, 128) == []
    assert [c for c, _ in plan_checks("sparq_paged_decode_attn", geo,
                                      16)] == [JX_PAGE_TILE]
    # K3: an odd head dim has no instantiation; bq must divide C
    k3 = dict(C=32, G=4, hd=64, bq=8, page=16, NB=5)
    assert plan_checks("sparq_chunked_prefill_attn", k3, 16) == []
    assert [c for c, _ in plan_checks("sparq_chunked_prefill_attn",
                                      dict(k3, C=36), 16)] == \
        [JX_TILE_DIVIDE]
    assert [c for c, _ in plan_checks("sparq_chunked_prefill_attn",
                                      dict(k3, hd=63), 16)] == \
        [JX_TILE_DIVIDE]
    # K7 at deepseek's widths fits, at the scan decode's 296 slots and at
    # a 65,536-key cache alike (a block's shared memory does not grow with
    # the keys); widths past every instantiation or the card's shared
    # memory are reported; K4's head shard must start on a pair
    assert plan_checks("sparq_mla_decode", dict(H=16, r=512, dr=64,
                                                n_keys=296), None) == []
    assert plan_checks("sparq_mla_decode", dict(H=16, r=512, dr=64,
                                                n_keys=65536), None) == []
    assert [c for c, _ in plan_checks("sparq_mla_decode", dict(
        H=16, r=768, dr=64, n_keys=296), None)] == [JX_VMEM]
    assert [c for c, _ in plan_checks("sparq_mla_decode", dict(
        H=16, r=2048, dr=64, n_keys=296), None)] == [JX_TILE_DIVIDE]
    assert [c for c, _ in plan_checks("sparq_quant", dict(
        widths=(64, 64), lane0=3), None)] == [JX_TILE_DIVIDE]
    with pytest.raises(ValueError, match="no launch plan"):
        plan_checks("nothing", {}, None)


def test_dispatchers_and_sources_are_the_reference_s():
    from repro.kernels import ops as jops
    assert ops.HOT_DISPATCHERS == jops.HOT_DISPATCHERS
    assert ops.META_DECODE_SOURCES == tuple(
        s.replace("repro/", "repro_torch/")
        for s in jops.META_DECODE_SOURCES)
    assert ops.AUDIT_HOOK is None


@pytest.fixture(scope="module")
def programs():
    from repro_torch.analysis.registry import default_programs
    return default_programs("cpu")


def test_registry_names_equal_reference(programs):
    """The reference registers its two TP programs only where two devices
    are visible; the port's TP engine is a one-process mesh, so they are
    always registered, in the reference's place (after the replay)."""
    from repro.analysis import registry as jreg
    want = [s.name for s in jreg.default_programs()]
    tp = ["decode_step.paged_tp2", "prefill_chunk_tp2"]
    src = inspect.getsource(jreg._tp_engine_specs)
    assert all(f'"{n}"' in src for n in tp)
    if not any(n in want for n in tp):
        at = want.index("decode_replay") + 1
        want = want[:at] + tp + want[at:]
    assert [s.name for s in programs] == want


def test_registered_programs_audit_clean(programs):
    """`run_all` over every registered program on the CPU and the host
    lint: no finding, one signature a program but the replay's (two
    recorded-token counts), dispatcher calls reaching K1 .. K6,
    no read in the plain versions."""
    from repro_torch.analysis import run_all
    live, muted, counters = run_all(programs=programs)
    assert live == [] and muted == [], [f.format() for f in live + muted]
    sigs = dict(counters["signatures_per_program"])
    assert counters["programs_traced"] == len(programs) == 12
    assert sigs.pop("decode_replay") == 2
    assert set(sigs.values()) == {1}
    assert all(n > 0 for n in counters["dispatches_per_program"].values())
    assert set(counters["plain_route_reads"].values()) == {0}
