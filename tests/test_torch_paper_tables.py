"""Port parity, the paper's tables: `repro_torch.launch.paper_tables`
against the reference's `benchmarks/tables.py` (Tables 1-4, 6 and
`bit_stats`), `benchmarks/table5_hw_cost.py`'s configurations and
`tests/test_paper_claims.py`'s claims, on the reduced `paper-resnet`
(width 16, stages (1, 1), 16 x 16 images, 8 classes).

The model is made by the JAX package (seeded init, BatchNorm and site
spans calibrated by the reference's own functions on one batch of 16)
and carried across with `interop.params_from_jax`; the images are made
by the JAX package as numpy and fed to both sides: two evaluation
batches of 16, one calibration batch of 16. The reference's tables read
`common.eval_batches` / `calib_batches`, which are monkeypatched to
those batches; `common.train_cnn` is never called (it writes a cache
under `benchmarks/`).

Tolerances, with their reasons:
- table rows (rounded to 4 places, as the reference rounds): equal. A
  quantized forward's logits differ from the reference's by f32
  summation order (3.3e-7 of max |logit| measured in
  `test_torch_cnn.py`, held there to 1e-5; the float forward's to
  1e-4), so an argmax may flip where the top two logits lie closer than
  that. A row that differs must show such ties on the port's side
  (`_ties`) and differ by no more than the tied images' share; on these
  inputs every row is equal.
- ACIQ's row: each side computes its own Laplace clips (the reference's
  eager f32 means are up to 3e-4 off f64, `test_torch_cnn.py`); held
  as the other rows, and equal on these inputs.
- bit_stats on the same activations: equal (one f32 division, integer
  counts). Against the reference on its own activations: within 1e-4,
  one unit of the rows' last place (site inputs differ by ulps, so a
  code at a rounding tie may flip; measured equal).
- Table 5's packed bits: equal to the reference's `bytes_per_value`;
  shared memory and device-memory bytes: equal to counts by hand.
"""
import dataclasses
import os
import pathlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_resnet as jconfigs
from repro.core.sparq import SparqConfig as JCfg
from repro.models import cnn as jcnn
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import sparq_matmul as mm
from repro_torch.launch import cnn_eval as ce
from repro_torch.launch import cnn_train as ct
from repro_torch.launch import paper_tables as pt

ROOT = pathlib.Path(__file__).resolve().parent.parent
BATCH = 16
TIE_TOL = 1e-5        # of max |logit|: test_torch_cnn.QUANT_LOGIT_TOL
FLOAT_TOL = 1e-4      # the float forward's, test_torch_cnn.py
ONE = 8               # images of the one batch of Table 6 and bit_stats


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small tensors: with several
    test workers on the machine, idle OpenMP threads spinning between
    small ops would take the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tb(batches):
    return [{k: _t(v) for k, v in b.items()} for b in batches]


def _jb(batches):
    return [jax.tree.map(jnp.asarray, b) for b in batches]


def _apply_prune(p):
    """The reference's 2:4 pruning (`common.train_cnn`'s apply_prune)."""
    from repro.core.pruning import prune_2_4

    def prune_leaf(path, leaf):
        if leaf.ndim == 4 and "stem" not in str(path):
            w2 = leaf.reshape(-1, leaf.shape[-1])
            return prune_2_4(w2, axis=0).reshape(leaf.shape)
        return leaf
    return jax.tree_util.tree_map_with_path(prune_leaf, p)


@pytest.fixture(scope="module")
def setup():
    """The JAX-made model and its 2:4-pruned copy, each calibrated by
    the reference's `common.calibrate_cnn` on the calibration batch, and
    the shared batches."""
    from benchmarks import common
    cfg = jconfigs.reduced()
    init = jax.jit(jcnn.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    data = jax.jit(jcnn.synthetic_dataset, static_argnums=(1, 2))
    calib = [_np(data(jax.random.PRNGKey(10), cfg, BATCH))]
    evalb = [_np(data(jax.random.PRNGKey(20 + i), cfg, BATCH))
             for i in range(2)]
    mp = pytest.MonkeyPatch()
    mp.setattr(common, "calib_batches", lambda cfg, n=None: _jb(calib))
    model = {"cfg": cfg, "params": init}
    scales = common.calibrate_cnn(model)
    pruned = {"cfg": cfg, "params": _apply_prune(init)}
    pscales = common.calibrate_cnn(pruned)
    mp.undo()
    tcfg = tconfigs.get_reduced_config("paper-resnet")

    def port(m):
        return {"cfg": tcfg, "params": params_from_jax(_np(m["params"]))}
    one = [{k: v[:ONE] for k, v in evalb[0].items()}]
    return dict(cfg=cfg, tcfg=tcfg, init=init, calib=calib, evalb=evalb,
                one=one, model=model, scales=scales, pruned=pruned,
                pscales=pscales, tmodel=port(model),
                tpruned=dict(port(pruned), stc=True))


def _patch_ref_batches(mp, setup):
    """Point the reference's batch makers at the shared batches: the one
    batch where the reference asks for 256 images (Table 6, bit_stats),
    the evaluation batches otherwise."""
    from benchmarks import common
    evalb, calib = _jb(setup["evalb"]), _jb(setup["calib"])
    one = _jb(setup["one"])
    mp.setattr(common, "eval_batches",
               lambda cfg, n=common.N_EVAL, batch=256, seed=None:
               one if n == 256 else evalb)
    mp.setattr(common, "calib_batches",
               lambda cfg, n=None, batch=None, seed=None: calib)


@pytest.fixture
def ref_batches(setup, monkeypatch):
    _patch_ref_batches(monkeypatch, setup)


# Table 2's rows run through both forwards: one of each column (every
# quantizer costs the reference a jit compile, and all nine took the
# file past a minute); all nine rows' names and quantizers are held
# by test_rows_name_the_reference_quantizers
TABLE2_ROWS = ("5opt_trim", "3opt_R", "2opt_R_noVS")


def _table2_subset(tables, setup):
    """The reference's Table 2 with its `_deltas` handed only the
    configurations of TABLE2_ROWS."""
    real = tables._deltas
    mp = pytest.MonkeyPatch()
    mp.setattr(tables, "_deltas", lambda model, scales, configs, **k: real(
        model, scales, [c for c in configs if c[0] in TABLE2_ROWS], **k))
    try:
        return tables.table2_sparq_configs(setup["model"], setup["scales"])
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def ref(setup):
    """ref(table): the reference's rows on the shared inputs, each table
    computed once for the file (every quantizer is a jit compile)."""
    from benchmarks import tables
    make = {
        "table1": lambda: tables.table1_precision_grid(setup["model"],
                                                       setup["scales"]),
        "table2": lambda: _table2_subset(tables, setup),
        "table3": lambda: tables.table3_baselines(setup["model"],
                                                  setup["scales"]),
        "table4": lambda: tables.table4_low_bits(setup["model"],
                                                 setup["scales"]),
        "table6": lambda: tables.table6_sparse_tc(setup["pruned"],
                                                  setup["pscales"]),
        "bit_stats": lambda: tables.bit_stats(setup["model"]),
    }
    memo = {}

    def get(name):
        if name not in memo:
            mp = pytest.MonkeyPatch()
            _patch_ref_batches(mp, setup)
            try:
                memo[name] = make[name]()
            finally:
                mp.undo()
        return memo[name]
    return get


def _ties(model, scales, cfg, batches):
    """Images whose top-two logit margin on the port's forward (float
    where `cfg` is None, else quantized with `cfg`, on the STC path where
    `cfg.enabled` and the model is the pruned one) is under the
    packages' logit tolerance of max |logit|: where an argmax may flip
    between them."""
    from repro_torch.models import cnn as tcnn
    ctx = None if cfg is None else ce.quant_ctx(
        scales, cfg, stc=model.get("stc", False) and cfg.enabled,
        device="cpu")
    n = 0
    for b in _tb(batches):
        lg, _ = tcnn.forward(model["params"], b["image"], model["cfg"],
                             ctx=ctx)
        top2 = torch.topk(lg, 2, -1).values
        tol = (FLOAT_TOL if cfg is None else TIE_TOL) * float(lg.abs().max())
        n += int((top2[:, 0] - top2[:, 1] < tol).sum())
    return n


def _hold_rows(got, want, model, scales, codecs, batches):
    """Rows equal to the reference's. A row that differs must be
    explained by ties: each tied image (float or quantized forward) can
    move the row by one image's share, and no more."""
    assert [r[:2] for r in got] == [r[:2] for r in want]
    images = sum(b["label"].shape[0] for b in batches)
    for (name, metric, g), (_, _, w) in zip(got, want):
        if g == w:
            continue
        ties = _ties(model, scales, None, batches)
        if metric == "top1_delta":
            ties += _ties(model, scales, codecs[name], batches)
        assert ties and abs(g - w) <= ties / images + 1e-4, (
            f"{name}: {g} against the reference's {w}, {ties} tied images")


TABLES = {
    "table1": ("table1_precision_grid", ("a8w8", "a4w8", "a8w4")),
    "table2": ("table2_sparq_configs",
               tuple(f"{o}opt_{v}" for o in (5, 3, 2)
                     for v in ("trim", "R", "R_noVS"))),
    "table4": ("table4_low_bits",
               ("3b_6opt", "2b_7opt", "3b_6opt_noVS", "2b_7opt_noVS")),
}


@pytest.mark.parametrize("table", list(TABLES))
def test_deltas_tables_match_reference(setup, ref, table):
    """Tables 1, 2 (TABLE2_ROWS) and 4: the rows, in the reference's
    order, equal."""
    fn, names = TABLES[table]
    want = ref(table)
    got = getattr(pt, fn)(setup["tmodel"], setup["scales"],
                          _tb(setup["evalb"]), device="cpu")
    assert [r[0] for r in got] == ["fp32", *names]
    if table == "table2":
        got = [r for r in got if r[0] in ("fp32",) + TABLE2_ROWS]
    _hold_rows(got, want, setup["tmodel"], setup["scales"],
               ce.PAPER_CODECS, setup["evalb"])


def test_table3_matches_reference(setup, ref):
    """Table 3: ACIQ's clips from the calibration batch on the model as
    given (calibrated), its delta from the rounded fp32 row."""
    want = ref("table3")
    got = pt.table3_baselines(setup["tmodel"], setup["scales"],
                              _tb(setup["evalb"]), _tb(setup["calib"]),
                              device="cpu")
    assert [r[0] for r in got] == ["fp32", "sparq_5opt", "sparq_3opt",
                                   "sparq_2opt_sysmt", "minmax_a4w8",
                                   "aciq_a4w8"]
    codecs = {"sparq_5opt": ce.PAPER_CODECS["5opt_R"],
              "sparq_3opt": ce.PAPER_CODECS["3opt_R"],
              "sparq_2opt_sysmt": ce.PAPER_CODECS["2opt_R"],
              "minmax_a4w8": ce.PAPER_CODECS["a4w8"]}
    _hold_rows(got[:-1], want[:-1], setup["tmodel"], setup["scales"],
               codecs, setup["evalb"])
    clips = ce.aciq_scales(setup["tmodel"], 4, _tb(setup["calib"]),
                           device="cpu")
    _hold_rows(got[-1:], want[-1:], setup["tmodel"], clips,
               {"aciq_a4w8": ce.PAPER_CODECS["a4w8"]}, setup["evalb"])


def test_table3_aciq_delta_uses_rounded_fp32(setup, ref_batches,
                                             monkeypatch):
    """The reference's quirk, reproduced: with the float top-1 at 2/3
    and every quantizer at 1/3, the quantizers' deltas read
    round(1/3 - 2/3, 4) = -0.3333 but ACIQ's reads round(1/3 - 0.6667, 4)
    = -0.3334, in both packages."""
    from benchmarks import common, tables
    monkeypatch.setattr(common, "cnn_accuracy", lambda model, ctx=None, **k:
                        2 / 3 if ctx is None else 1 / 3)
    monkeypatch.setattr(jcnn, "accuracy", lambda *a, **k: 1 / 3)
    monkeypatch.setattr(ce, "cnn_accuracy", lambda model, ctx=None, **k:
                        2 / 3 if ctx is None else 1 / 3)
    want = tables.table3_baselines(setup["model"], setup["scales"])
    got = pt.table3_baselines(setup["tmodel"], setup["scales"],
                              _tb(setup["evalb"]), _tb(setup["calib"]),
                              device="cpu")
    assert got == want
    assert [v for _, _, v in got] == [0.6667] + [-0.3333] * 4 + [-0.3334]


def test_table6_matches_reference(setup, ref):
    """Table 6 on the pruned network, one batch: the A8W8 row on the
    dense path, the STC rows through the simulation."""
    want = ref("table6")
    got = pt.table6_sparse_tc(setup["tpruned"], setup["pscales"],
                              _tb(setup["one"]), device="cpu")
    assert [r[0] for r in got] == ["stc_fp32_pruned", "stc_a8w8",
                                   *ce.STC_CODECS]
    _hold_rows(got, want, setup["tpruned"], setup["pscales"],
               dict(stc_a8w8=ce.PAPER_CODECS["a8w8"], **ce.STC_CODECS),
               setup["one"])


def _fingerprint(ctx):
    """A top-1 that names the quantizer: 2/3 for the float network, else
    a value in k / 3072 drawn from the codec's fields and the STC flag,
    alike for both packages' SparqConfig."""
    if ctx is None:
        return 2 / 3
    key = repr((dataclasses.astuple(ctx.cfg), bool(ctx.stc)))
    return (zlib.crc32(key.encode()) % 3072) / 3072


@pytest.mark.parametrize("table", ["table1", "table2", "table3", "table4",
                                   "table6"])
def test_rows_name_the_reference_quantizers(setup, ref_batches,
                                            monkeypatch, table):
    """With every top-1 replaced by a fingerprint of the quantizer that
    ran (its fields and whether the STC path was asked for), each row
    equals the reference's: every row runs the reference's quantizer on
    the reference's path, and the rounding (ACIQ's from the rounded
    fp32 row) is the reference's. The forward runs on neither side."""
    from benchmarks import common, tables
    monkeypatch.setattr(common, "cnn_accuracy",
                        lambda model, ctx=None, **k: _fingerprint(ctx))
    monkeypatch.setattr(jcnn, "accuracy",
                        lambda params, b, cfg, ctx=None: _fingerprint(ctx))
    monkeypatch.setattr(ce, "cnn_accuracy",
                        lambda model, ctx=None, **k: _fingerprint(ctx))
    fn = {"table1": "table1_precision_grid",
          "table2": "table2_sparq_configs", "table3": "table3_baselines",
          "table4": "table4_low_bits", "table6": "table6_sparse_tc"}[table]
    m, tm, sc = (("pruned", "tpruned", "pscales") if table == "table6"
                 else ("model", "tmodel", "scales"))
    want = getattr(tables, fn)(setup[m], setup[sc])
    got = getattr(pt, fn)(setup[tm], setup[sc], _tb(setup["evalb"]),
                          device="cpu")
    assert got == want
    # all told apart, but ACIQ, which is min-max A4W8 on other spans
    told = [v for c, _, v in got if c != "aciq_a4w8"]
    assert len(set(told)) == len(told)


def _ref_bit_stats_on(x, setup, monkeypatch):
    """The reference's bit_stats with its forward replaced by one that
    hands the tap the activations `x`."""
    from benchmarks import tables

    def forward(params, image, cfg, ctx=None, train=False):
        ctx.collect.observe("all", jnp.asarray(x))
        return None, None
    monkeypatch.setattr(jcnn, "forward", forward)
    return tables.bit_stats(setup["model"])


def test_bit_stats_same_activations(setup, ref_batches, monkeypatch):
    """The port's rates on its own site inputs equal the reference's
    function on those same inputs."""
    b = _tb(setup["one"])[0]
    x = pt.site_inputs(setup["tmodel"], b)
    got = pt.bit_stats(setup["tmodel"], b, device="cpu")
    assert got == pt.bit_rates(x)
    assert got == _ref_bit_stats_on(x.numpy(), setup, monkeypatch)


def test_bit_stats_matches_reference(setup, ref):
    want = ref("bit_stats")
    got = pt.bit_stats(setup["tmodel"], _tb(setup["one"])[0],
                       device="cpu")
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        assert abs(g - w) <= 1e-4
    assert 0 < dict((c, v) for c, _, v in got)["zero_fraction"] < 1


def test_bit_rates_by_hand():
    """Codes 0, 255, 16, 15 and 128 (scale 1): zero share 1/5; among the
    four non-zero codes bit 7 is set in 255 and 128, bit 4 in 255 and 16,
    and 255, 16 and 128 need the window above bit 3."""
    x = torch.tensor([0.0, 255.0, 16.0, 15.0, 128.0])
    assert dict((c, v) for c, _, v in pt.bit_rates(x)) == {
        "zero_fraction": 0.2, "bit7_toggle_nonzero": 0.5,
        "bit6_toggle_nonzero": 0.25, "bit5_toggle_nonzero": 0.25,
        "bit4_toggle_nonzero": 0.5, "msb_window_needed": 0.75}


# ----------------------------------------------------------------------
# Table 5
# ----------------------------------------------------------------------

REF_TABLE5 = ("8b8b_baseline", "7opt_2b", "6opt_3b", "5opt_4b", "3opt_4b",
              "2opt_4b", "5opt_noVS", "3opt_noVS")


@pytest.mark.parametrize("i", range(len(REF_TABLE5)))
def test_table5_packed_bits_match_reference(i):
    """Each of the reference's eight configurations, by its name: the
    packed bits per activation equal the reference's bytes_per_value x 8."""
    from repro.kernels.ops import bytes_per_value
    name, cfg = pt.TABLE5_CONFIGS[i]
    assert name == REF_TABLE5[i]
    want = bytes_per_value(JCfg(**dataclasses.asdict(cfg))) * 8
    rows = {(c, m): v for c, m, v in pt.table5_rows("cpu")}
    assert rows[(name, "packed_bits_per_act")] == want


def test_table5_counts_by_hand():
    """At M 256, K 1024, N 256 on 132 SMs: 64 x 128 tiles (8), split-K
    16 (one k tile of 64 each), 128 blocks. Shared memory: 4 stages x
    (64 x 64 code bytes + 64 x 128 weight bytes) = 49152. Device memory:
    x 1 MiB f32 read and r 256 KiB written; r read by 2 N tiles (512 KiB)
    and w (256 KiB) by 4 M tiles (1 MiB); 16 planes of 256 x 256 int32
    partials written and read (8 MiB); 256 KiB f32 out: 11534336."""
    p = mm.plan(256, 256, 1024, 132)
    assert (p.bm, p.bn, p.split_k, p.tiles_per_split, p.blocks) == (
        64, 128, 16, 1, 128)
    assert mm.smem_bytes(p) == 4 * (64 * 64 + 64 * 128) == 49152
    KiB = 1024
    want = (1024 * KiB + 256 * KiB) + (512 * KiB + 1024 * KiB) \
        + 2 * 16 * 256 * KiB + 256 * KiB
    assert mm.hbm_bytes(p, 256, 256, 1024) == want == 11534336
    rows = pt.table5_rows("cpu")
    assert {v for c, m, v in rows if m == "smem_bytes"} == {49152}
    assert {v for c, m, v in rows if m == "hbm_bytes"} == {11534336}
    # no split: out once, no partials
    q = mm.plan(4096, 256, 1024, 132)
    assert q.split_k == 1
    assert mm.hbm_bytes(q, 4096, 256, 1024, x_bytes=2) == (
        4096 * 1024 * 2 + 4096 * q.kp + 4096 * q.kp * (256 // q.bn)
        + 1024 * 256 * (4096 // q.bm) + 4 * 4096 * 256)


def test_table5_no_time_rows_on_cpu():
    rows = pt.table5_rows("cpu")
    assert [(c, m) for c, m, _ in rows] == [
        (n, m) for n in REF_TABLE5
        for m in ("packed_bits_per_act", "smem_bytes", "hbm_bytes")]


def test_table5_inputs():
    """Seeded; x f32 with zeros (vSPARQ's pair test sees them), w int8
    symmetric, a = max |x| / 127; K1's plain version runs on them."""
    a_set = pt.table5_inputs(2, device="cpu")
    again = pt.table5_inputs(1, device="cpu")[0]
    x, w, a, c = a_set[0]
    assert torch.equal(x, again[0]) and not torch.equal(x, a_set[1][0])
    assert x.dtype == torch.float32 and x.shape == (256, 1024)
    assert w.dtype == torch.int8 and w.shape == (1024, 256)
    assert int(w.min()) >= -127
    assert 0.25 < float((x == 0).float().mean()) < 0.35
    assert float(a) == float(x.abs().max() / 127)
    out = mm.ref_sparq_matmul(x, w, a, c, **ops._codec_kw(
        pt.TABLE5_CONFIGS[3][1]))
    assert out.shape == (256, 256) and bool(torch.isfinite(out).all())
    # the _int_mm yardstick's operands: int8 codes, A8W8's product
    q, w2, a2, c2 = pt.int_mm_inputs(a_set[:1])[0]
    assert q.dtype == torch.int8 and w2 is w and a2 is a and c2 is c
    base = mm.ref_sparq_matmul(x, w, a, c, **ops._codec_kw(
        pt.TABLE5_CONFIGS[0][1]))
    lib = (torch.matmul(q.double(), w.double()).float() * a) * c
    assert torch.equal(lib, base)


# ----------------------------------------------------------------------
# the claims
# ----------------------------------------------------------------------

def _reference_asserts(t, errs, pruned):
    """tests/test_paper_claims.py's assertions, each written as there,
    on accuracies read off the rows (fp32 plus delta)."""
    t1, t2, t4, t6, st = (dict((c, v) for c, _, v in t[k]) for k in (
        "table1", "table2", "table4", "table6", "bit_stats"))
    fp32 = t1["fp32"]
    acc = {n: fp32 + d for n, d in t1.items() if n != "fp32"}
    acc.update({n: t2["fp32"] + d for n, d in t2.items() if n != "fp32"})
    acc.update({n: t4["fp32"] + d for n, d in t4.items() if n != "fp32"})
    margin = 0.012
    stc_fp32 = t6["stc_fp32_pruned"]
    return {
        "T1 fp32 top1 > 0.85": fp32 > 0.85,
        "T1 a8w8 top1 > fp32 - 0.01": acc["a8w8"] > fp32 - 0.01,
        "T1 a8w4 top1 > 0.85": acc["a8w4"] > 0.85,
        "T1 err(a8w4) > 4 err(a8w8)": errs["a8w4"] > 4 * errs["a8w8"],
        "T1 err(5opt) < err(a8w4)": errs["5opt_R"] < errs["a8w4"],
        "T2 5opt top1 > fp32 - 0.025": acc["5opt_R"] > t2["fp32"] - 0.025,
        "T2 3opt top1 > fp32 - 0.025": acc["3opt_R"] > t2["fp32"] - 0.025,
        **{f"T2 |{o}opt trim - fp32| < 0.08":
           abs(acc[f"{o}opt_trim"] - t2["fp32"]) < 0.08 for o in (5, 3, 2)},
        "T4 5opt top1 >= 7opt top1 - 0.012":
            acc["5opt_R"] >= acc["2b_7opt"] - margin,
        "T4 7opt top1 > 0.5": acc["2b_7opt"] > 0.5,
        "T4 7opt top1 >= 7opt noVS top1 - 0.012":
            acc["2b_7opt"] >= acc["2b_7opt_noVS"] - margin,
        "T6 pruned top1 > 0.8": pruned["top1"] > 0.8,
        "T6 |pruned stage-0 w1 sparsity - 0.5| < 1e-6":
            abs(pruned["sparsity"] - 0.5) < 1e-6,
        "T6 STC 5opt top1 > pruned fp32 - 0.03":
            stc_fp32 + t6["stc_4b_5opt"] > stc_fp32 - 0.03,
        "stats zero_fraction > 0.3": st["zero_fraction"] > 0.3,
        "stats bit7 < bit5":
            st["bit7_toggle_nonzero"] < st["bit5_toggle_nonzero"],
    }


def _crafted(seed):
    """Rows, logit errors and pruned figures drawn around the claims'
    bounds (seed 0: every claim held, 1: none held, others at random)."""
    rng = np.random.default_rng(seed)

    def pick(held, fail):
        return held if seed == 0 else fail if seed == 1 else \
            [held, fail][int(rng.integers(2))]
    fp = pick(0.9, 0.8)
    t1 = [("fp32", "top1", fp), ("a8w8", "top1_delta", pick(-0.0099, -0.01)),
          ("a4w8", "top1_delta", -0.3),
          ("a8w4", "top1_delta", pick(-0.04, -0.05))]
    t2 = [("fp32", "top1", fp)]
    for o in (5, 3, 2):
        t2 += [(f"{o}opt_trim", "top1_delta", pick(0.0799, -0.0801)),
               (f"{o}opt_R", "top1_delta", pick(-0.0249, -0.025)),
               (f"{o}opt_R_noVS", "top1_delta", -0.01)]
    t4 = [("fp32", "top1", fp), ("3b_6opt", "top1_delta", -0.02),
          ("2b_7opt", "top1_delta", pick(-0.03, -0.5)),
          ("3b_6opt_noVS", "top1_delta", -0.03),
          ("2b_7opt_noVS", "top1_delta", pick(-0.042, -0.0179))]
    # 5opt against 7opt: 5opt_R - 7opt >= -0.012 fails only where 5opt
    # falls below 7opt by more than the margin
    if seed == 1 or (seed > 1 and rng.integers(2)):
        t2[2] = ("5opt_R", "top1_delta", -0.36)
        t4[2] = ("2b_7opt", "top1_delta", -0.32)
    t6 = [("stc_fp32_pruned", "top1", 0.95),
          ("stc_a8w8", "top1_delta", 0.0),
          ("stc_4b_5opt", "top1_delta", pick(-0.0299, -0.03))]
    st = [("zero_fraction", "rate", pick(0.3001, 0.3)),
          ("bit7_toggle_nonzero", "rate", pick(0.1, 0.2)),
          ("bit5_toggle_nonzero", "rate", pick(0.2, 0.2))]
    errs = {"a8w8": 0.002, "a8w4": pick(0.0081, 0.008),
            "5opt_R": pick(0.0079, 0.0081)}
    pruned = {"top1": pick(0.8001, 0.8), "sparsity": pick(0.5, 0.5000011)}
    return (dict(table1=t1, table2=t2, table4=t4, table6=t6, bit_stats=st),
            errs, pruned)


@pytest.mark.parametrize("seed", range(8))
def test_paper_claims_on_crafted_rows(seed):
    """Every claim held or not exactly as the reference's assertion on
    the same numbers would pass or fail; seed 0 holds all, 1 none."""
    t, errs, pruned = _crafted(seed)
    got = pt.paper_claims(t, errs, pruned)
    want = _reference_asserts(t, errs, pruned)
    assert set(got) == set(want)
    assert {k: v[2] for k, v in got.items()} == want
    if seed < 2:
        assert set(want.values()) == {seed == 0}


def test_paper_claims_leave_out_missing_inputs():
    t, _, _ = _crafted(0)
    got = pt.paper_claims({"table4": t["table4"]})
    assert set(got) == {"T4 7opt top1 > 0.5",
                        "T4 7opt top1 >= 7opt noVS top1 - 0.012"}
    got = pt.paper_claims({"table3": [("fp32", "top1", 0.9),
                                      ("sparq_5opt", "top1_delta", 0.0)],
                           "table4": t["table4"]})
    assert got["T4 5opt top1 >= 7opt top1 - 0.012"][0] == 0.9


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

def test_main_prints_the_reference_rows(setup, ref, monkeypatch, capsys,
                                        tmp_path):
    """`main --device cpu --tables 1,3,5,6,stats` on the reduced model
    (the trainer and the batch makers patched to it): the header, then
    (table, config, metric) in the reference's order, the claims on
    stderr, and no file written."""
    want = []
    for t in ("table1", "table3", "table5", "table6", "bit_stats"):
        if t == "table5":
            want += [(t, n, m) for n in REF_TABLE5 for m in (
                "packed_bits_per_act", "smem_bytes", "hbm_bytes")]
        else:
            want += [(t, c, m) for c, m, _ in ref(t)]
    capsys.readouterr()

    def train_cnn(prune_2_4=False, device=None, **kw):
        init = params_from_jax(_np(setup["init"]))
        return {"cfg": setup["tcfg"], "losses": [],
                "params": ce.prune_cnn(init) if prune_2_4 else init}
    evalb, calib = _tb(setup["evalb"]), _tb(setup["calib"])
    # the order of the rows is under test here, not their values: Table
    # 6's STC simulation, the slow part on the CPU, gets two images
    one = [{k: v[:2] for k, v in b.items()} for b in _tb(setup["one"])]
    monkeypatch.setattr(ct, "train_cnn", train_cnn)
    monkeypatch.setattr(ce, "eval_batches",
                        lambda cfg, n=ce.N_EVAL, batch=256, seed=None,
                        device=None: one if n == 256 else evalb)
    monkeypatch.setattr(ce, "calib_batches",
                        lambda cfg, n=None, batch=None, seed=None,
                        device=None: calib)
    cache = ROOT / "benchmarks" / ".cache"
    before = sorted(os.listdir(cache)) if cache.exists() else None
    monkeypatch.chdir(tmp_path)
    out = pt.main(["--device", "cpu", "--tables", "1,3,5,6,stats"])
    cap = capsys.readouterr()
    lines = cap.out.splitlines()
    assert lines[0] == "table,config,metric,value"
    assert [tuple(s.split(",")[:3]) for s in lines[1:]] == want
    assert set(out["tables"]) == {"table1", "table3", "table5", "table6",
                                  "bit_stats"}
    err = cap.err.splitlines()
    assert "# table5: ms, ms_rel and int8_int_mm need the card; left out " \
        "on cpu" in err
    assert [s.split(":")[0][2:] for s in err
            if s.startswith("# ") and not s.startswith("# table5")] == list(
                out["claims"])
    assert "T6 pruned top1 > 0.8" in out["claims"]
    assert list(tmp_path.iterdir()) == []
    assert (sorted(os.listdir(cache)) if cache.exists() else None) == before


def test_main_rejects_unknown_tables(capsys):
    with pytest.raises(SystemExit):
        pt.main(["--device", "cpu", "--tables", "1,serve"])
    assert "unknown tables ['serve']" in capsys.readouterr().err


def test_entry_points_raise_without_gpu(setup, monkeypatch, capsys):
    """Without a GPU and without a device every entry point raises, and
    the CLI prints nothing first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, s = setup["tmodel"], setup["scales"]
    calls = [lambda: pt.main([]), lambda: pt.table5_rows(),
             lambda: pt.table1_precision_grid(m, s),
             lambda: pt.table2_sparq_configs(m, s),
             lambda: pt.table3_baselines(m, s),
             lambda: pt.table4_low_bits(m, s),
             lambda: pt.table6_sparse_tc(m, s), lambda: pt.bit_stats(m),
             lambda: pt.table5_inputs()]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert capsys.readouterr().out == ""
