"""The paper's tables on the CNN path (port of the reference's
`benchmarks/tables.py`, `benchmarks/table5_hw_cost.py` and the `--tables`
branch of `benchmarks/run.py`), with a CLI:

    python -m repro_torch.launch.paper_tables [--tables 1,2,3,4,5,6,stats]
                                              [--device cpu]

It prints `table,config,metric,value` and then each requested table's
rows in the reference's order, under the reference's table, config and
metric names, and writes the claims of `tests/test_paper_claims.py` to
stderr as `#` lines. It trains the float network (`cnn_train.train_cnn`,
420 steps) and, for Table 6 only, the 2:4-pruned one (630 steps), and
writes no file (the reference caches its networks on disk).

Each table function returns rows `(config, metric, value)` and asserts
nothing; `paper_claims` turns rows into the reference's claims. Every
entry point takes `device=None`, resolved by `repro_torch.resolve_device`:
the card unless the caller asks for the CPU, and a raise without a GPU.
Batches default to `cnn_eval.eval_batches` / `calib_batches` on that
device; the port's `torch.Generator` draws other images than the
reference's `jax.random`, so the card's rows are the port's own numbers.

- Tables 1, 2 and 4: top-1 deltas of the quantizers in
  `cnn_eval.PAPER_CODECS` against the float network, each conv but the
  stem through K1 (unsigned codes) on the card.
- Table 3: SPARQ 5/3/2opt and min-max A4W8 (the same codecs), then the
  ACIQ A4W8 baseline, whose delta subtracts the *rounded* float top-1 as
  the reference's does. Its spans are the Laplace clips of one
  calibration batch of 128 on the model as given (after `calibrate_cnn`
  in `main`); the reference recomputes the same spans once per
  evaluation batch, the port once.
- Table 5, recast for the card: the reference's eight signed K1
  configurations at its shape (x f32 [256, 1024], w int8 [1024, 256]).
  Per configuration: the packed bits per activation (the §5.1 format),
  one GEMM block's shared memory and one call's device-memory bytes as
  K1's tile plan implies (both the same for every configuration: SPARQ's
  logic adds no memory traffic), and on the card the median K1 time and
  its ratio to the `8b8b_baseline` row (plain A8W8), then `torch._int_mm`
  on the codes plus the scaling as a yardstick. On the CPU the time rows
  are left out: the plain version is no yardstick.
- Table 6: the 2:4-pruned network on one batch of 256. Its A8W8 row runs
  the dense path (K1); the STC rows run `core/sparq.py::sparq_dot_stc`,
  plain PyTorch on every device, as the reference's is plain JAX.
- bit_stats: every quantized site's input on one batch of 256, quantized
  to unsigned 8 bits with one scale from the global max: the zero share,
  the toggle rate of bits 7..4 among non-zero codes, and the share of
  non-zero codes that need the window above bit 3 (codes >= 16).
"""
from __future__ import annotations

import argparse
import math
import operator
import statistics
import sys
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.calibration import CalibBank
from repro_torch.core.pruning import sparsity
from repro_torch.core.quantizer import act_scale_from_stats, quantize
from repro_torch.core.sparq import SparqConfig
from repro_torch.kernels import ops
from repro_torch.kernels import sparq_matmul as mm
from repro_torch.kernels.ref import quantize_codes
from repro_torch.launch import cnn_eval, cnn_train
from repro_torch.models import cnn
from repro_torch.models.common import QuantCtx

Row = Tuple[str, str, object]
TABLES = ("1", "2", "3", "4", "5", "6", "stats")

_C = cnn_eval.PAPER_CODECS


def emit(table: str, rows: List[Row]) -> None:
    """CSV rows: table,config,metric,value."""
    for config, metric, value in rows:
        print(f"{table},{config},{metric},{value}")


def _deltas(model, scales, configs, batches, dev) -> List[Row]:
    """The float top-1 (rounded to 4 places), then each configuration's
    top-1 less the unrounded float top-1, rounded to 4 places."""
    fp32 = cnn_eval.cnn_accuracy(model, batches=batches, device=dev)
    rows = [("fp32", "top1", round(fp32, 4))]
    for name, cfg in configs:
        acc = cnn_eval.cnn_accuracy(
            model, cnn_eval.quant_ctx(scales, cfg, device=dev),
            batches=batches, device=dev)
        rows.append((name, "top1_delta", round(acc - fp32, 4)))
    return rows


def _eval(model, batches, dev):
    if batches is None:
        return cnn_eval.eval_batches(model["cfg"], device=dev)
    return batches


def table1_precision_grid(model, scales, batches=None,
                          device=None) -> List[Row]:
    """Table 1: float, then uniform min-max A8W8, A4W8 and A8W4."""
    dev = resolve_device(device)
    return _deltas(model, scales, [(n, _C[n]) for n in
                                   ("a8w8", "a4w8", "a8w4")],
                   _eval(model, batches, dev), dev)


def table2_sparq_configs(model, scales, batches=None,
                         device=None) -> List[Row]:
    """Table 2: 5/3/2opt 4-bit windows, trimmed, rounded (+R) and rounded
    without vSPARQ."""
    dev = resolve_device(device)
    names = [f"{o}opt_{v}" for o in (5, 3, 2)
             for v in ("trim", "R", "R_noVS")]
    return _deltas(model, scales, [(n, _C[n]) for n in names],
                   _eval(model, batches, dev), dev)


def table3_baselines(model, scales, batches=None, calib=None,
                     device=None) -> List[Row]:
    """Table 3: SPARQ against other 4-bit schemes. SySMT is 2opt; the
    naive baseline is min-max A4W8; ACIQ is min-max A4W8 on the analytic
    Laplace clips of the calibration batches (`calib`, by default one
    batch of 128) at 4 bits."""
    dev = resolve_device(device)
    batches = _eval(model, batches, dev)
    rows = _deltas(model, scales, [
        ("sparq_5opt", _C["5opt_R"]), ("sparq_3opt", _C["3opt_R"]),
        ("sparq_2opt_sysmt", _C["2opt_R"]), ("minmax_a4w8", _C["a4w8"]),
    ], batches, dev)
    fp32 = rows[0][2]                       # the rounded row, as reference
    clips = cnn_eval.aciq_scales(model, 4, calib, device=dev)
    acc = cnn_eval.cnn_accuracy(
        model, cnn_eval.quant_ctx(clips, _C["a4w8"], device=dev),
        batches=batches, device=dev)
    rows.append(("aciq_a4w8", "top1_delta", round(acc - fp32, 4)))
    return rows


def table4_low_bits(model, scales, batches=None, device=None) -> List[Row]:
    """Table 4: 3-bit 6opt and 2-bit 7opt, with and without vSPARQ."""
    dev = resolve_device(device)
    names = ("3b_6opt", "2b_7opt", "3b_6opt_noVS", "2b_7opt_noVS")
    return _deltas(model, scales, [(n, _C[n]) for n in names],
                   _eval(model, batches, dev), dev)


def table6_sparse_tc(pruned, scales, batches=None,
                     device=None) -> List[Row]:
    """Table 6: SPARQ on a sparse tensor core, on a 2:4-pruned network.
    All rows on `batches`, by default one batch of 256 (the STC
    simulation rebuilds codes per output channel, far slower than the
    dense path). The A8W8 row runs the dense path."""
    dev = resolve_device(device)
    if batches is None:
        batches = cnn_eval.eval_batches(pruned["cfg"], n=256, device=dev)
    configs = [("stc_a8w8", _C["a8w8"])] + list(
        cnn_eval.STC_CODECS.items())
    fp32 = cnn_eval.cnn_accuracy(pruned, batches=batches, device=dev)
    rows = [("stc_fp32_pruned", "top1", round(fp32, 4))]
    for name, cfg in configs:
        acc = cnn_eval.cnn_accuracy(
            pruned, cnn_eval.quant_ctx(scales, cfg, stc=cfg.enabled,
                                       device=dev),
            batches=batches, device=dev)
        rows.append((name, "top1_delta", round(acc - fp32, 4)))
    return rows


class _Tap(CalibBank):
    """Keeps every calibrate-mode site input, flattened, in order."""

    def __init__(self):
        super().__init__()
        self.taps: List[torch.Tensor] = []

    def observe(self, name: str, x: torch.Tensor) -> None:
        self.taps.append(x.reshape(-1))


def site_inputs(model, batch) -> torch.Tensor:
    """Every quantized site's input on `batch`, flattened and joined in
    site order."""
    tap = _Tap()
    cnn.forward(model["params"], batch["image"], model["cfg"],
                ctx=QuantCtx(mode="calibrate", collect=tap))
    return torch.cat(tap.taps)


def bit_rates(x: torch.Tensor) -> List[Row]:
    """bit_stats' rows for activations `x`: unsigned 8-bit codes with one
    scale from the global max. Rates are exact counts over counts."""
    q = quantize(x, act_scale_from_stats(x.max(), bits=8, signed=False))
    nz = q[q > 0]

    def rate(mask, n):
        return round(int(mask.sum()) / n, 4)
    rows = [("zero_fraction", "rate", rate(q == 0, q.numel()))]
    for bit in (7, 6, 5, 4):
        rows.append((f"bit{bit}_toggle_nonzero", "rate",
                     rate((nz >> bit) & 1, nz.numel())))
    rows.append(("msb_window_needed", "rate", rate(nz >= 16, nz.numel())))
    return rows


def bit_stats(model, batch=None, device=None) -> List[Row]:
    """§2 / §5.1: per-bit toggle rates of the non-zero activation codes
    and the share that needs the window above bit 3, on one batch (by
    default the first evaluation batch of 256)."""
    dev = resolve_device(device)
    if batch is None:
        batch = cnn_eval.eval_batches(model["cfg"], n=256, device=dev)[0]
    return bit_rates(site_inputs(model, batch))


# ----------------------------------------------------------------------
# Table 5: K1's cost at the reference's shape
# ----------------------------------------------------------------------

TABLE5_SHAPE = (256, 1024, 256)          # M, K, N
TABLE5_CONFIGS = (
    ("8b8b_baseline", SparqConfig(enabled=False, signed=True)),
    ("7opt_2b", SparqConfig.opt7(signed=True)),
    ("6opt_3b", SparqConfig.opt6(signed=True)),
    ("5opt_4b", SparqConfig.opt5(signed=True)),
    ("3opt_4b", SparqConfig.opt3(signed=True)),
    ("2opt_4b", SparqConfig.opt2(signed=True)),
    ("5opt_noVS", SparqConfig.opt5(signed=True, vsparq=False)),
    ("3opt_noVS", SparqConfig.opt3(signed=True, vsparq=False)),
)
TIME_ITERS = 50
TIME_WARMUP = 5
# cycles of torch.cuda._sleep queued ahead of the timed calls (~50 ms on
# an H100): the card waits while the host queues them, so each call's
# events time the card and not the wrapper's Python
SLEEP_CYCLES = 100_000_000


def table5_inputs(n: int = 1, device=None) -> List[tuple]:
    """`n` input sets of Table 5's K1 call, (x, w, a, c): x f32 (M, K),
    normal with 30% zeros (vSPARQ's pair test sees zeros), w int8 codes
    (K, N), a = max |x| / 127 (one f32), c (N,) per-channel scales."""
    dev = resolve_device(device)
    M, K, N = TABLE5_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for _ in range(n):
        x = torch.randn((M, K), generator=gen, device=dev)
        x = torch.where(torch.rand((M, K), generator=gen, device=dev) < 0.3,
                        0.0, x)
        w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        c = torch.rand((N,), generator=gen, device=dev) * 1e-3
        a = (x.abs().amax() / 127).reshape(1)
        out.append((x, w, a, c))
    return out


def median_ms(fn, arg_sets, iters=TIME_ITERS, warmup=TIME_WARMUP) -> float:
    """Median ms of `fn(*set)` on the card, each call between two CUDA
    events, cycling through `arg_sets` after `warmup` untimed calls."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for i, (start, end) in enumerate(events):
        start.record()
        fn(*arg_sets[(warmup + i) % len(arg_sets)])
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def table5_rows(device=None) -> List[Row]:
    """Table 5 recast as K1's cost on the card (module docstring). On the
    card each timed call reads its own input set, and the sets together
    take twice the L2 cache, so every call reads device memory."""
    dev = resolve_device(device)
    M, K, N = TABLE5_SHAPE
    sms = mm.sm_count(dev) if dev.type == "cuda" else 132
    p = mm.plan(M, N, K, sms)
    rows = []
    for name, cfg in TABLE5_CONFIGS:
        rows += [(name, "packed_bits_per_act", 8 * ops.bytes_per_value(cfg)),
                 (name, "smem_bytes", mm.smem_bytes(p)),
                 (name, "hbm_bytes", mm.hbm_bytes(p, M, N, K))]
    if dev.type != "cuda":
        return rows
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 * 2 ** 20)
    sets = table5_inputs(math.ceil(2 * l2 / (M * K + K * N)), device=dev)
    times = {}
    for name, cfg in TABLE5_CONFIGS:
        kw = ops._codec_kw(cfg)
        times[name] = median_ms(
            lambda x, w, a, c: mm.sparq_matmul_cuda(x, w, a, c, **kw), sets)
    out, base = [], times["8b8b_baseline"]
    for i, (name, _) in enumerate(TABLE5_CONFIGS):
        out += rows[3 * i:3 * i + 3] + [
            (name, "ms", times[name]), (name, "ms_rel", times[name] / base)]
    out.append(("int8_int_mm", "ms", median_ms(
        lambda q, w, a, c: (torch._int_mm(q, w).float() * a) * c,
        int_mm_inputs(sets))))
    return out


def int_mm_inputs(sets) -> List[tuple]:
    """The yardstick's inputs: each set's x as signed int8 codes (A8W8's,
    no SPARQ window), with its w, a and c."""
    return [(quantize_codes(x, a, True, 127).to(torch.int8), w, a, c)
            for x, w, a, c in sets]


# ----------------------------------------------------------------------
# the claims of tests/test_paper_claims.py, on the rows
# ----------------------------------------------------------------------

# the reference tests' paired-evaluation margin
CLAIM_MARGIN = 0.012
# the codecs whose cnn_eval.logit_err Table 1's claims read
CLAIM_ERR_CODECS = ("a8w8", "a8w4", "5opt_R")
_OPS = {">": operator.gt, ">=": operator.ge, "<": operator.lt}


def paper_claims(tables: Dict[str, List[Row]],
                 logit_errs: Optional[Dict[str, float]] = None,
                 pruned: Optional[Dict[str, float]] = None
                 ) -> Dict[str, Tuple[float, float, bool]]:
    """The assertions of `tests/test_paper_claims.py`, each as
    {claim: (value, bound, held)}, read off the rows of `tables`
    ({"table1": rows, ...}; a codec's top-1 is the float row plus its
    delta), `logit_errs` ({codec: cnn_eval.logit_err} for
    CLAIM_ERR_CODECS, the reference's `_logit_err`) and `pruned`
    ({"top1", "sparsity"}: the 2:4 network before calibration on the
    evaluation batches, and its stage-0 w1 sparsity). A claim whose
    inputs are missing is left out."""
    def by_name(t):
        return {c: v for c, _, v in tables.get(t, ())}

    t1, t2, t3, t4, t6, st = (by_name(t) for t in (
        "table1", "table2", "table3", "table4", "table6", "bit_stats"))
    claims = []

    def claim(name, value, op, bound):
        claims.append((name, value, op, bound))

    if t1:
        fp = t1["fp32"]
        claim("T1 fp32 top1 > 0.85", fp, ">", 0.85)
        claim("T1 a8w8 top1 > fp32 - 0.01", fp + t1["a8w8"], ">", fp - 0.01)
        claim("T1 a8w4 top1 > 0.85", fp + t1["a8w4"], ">", 0.85)
    if logit_errs:
        e = logit_errs
        claim("T1 err(a8w4) > 4 err(a8w8)", e["a8w4"], ">", 4 * e["a8w8"])
        claim("T1 err(5opt) < err(a8w4)", e["5opt_R"], "<", e["a8w4"])
    if t2:
        fp = t2["fp32"]
        for o in (5, 3):
            claim(f"T2 {o}opt top1 > fp32 - 0.025", fp + t2[f"{o}opt_R"],
                  ">", fp - 0.025)
        for o in (5, 3, 2):
            claim(f"T2 |{o}opt trim - fp32| < 0.08",
                  abs(fp + t2[f"{o}opt_trim"] - fp), "<", 0.08)
    if t4:
        fp = t4["fp32"]
        a2 = fp + t4["2b_7opt"]
        five = (t2["fp32"] + t2["5opt_R"] if t2 else
                t3["fp32"] + t3["sparq_5opt"] if t3 else None)
        if five is not None:
            claim("T4 5opt top1 >= 7opt top1 - 0.012", five, ">=",
                  a2 - CLAIM_MARGIN)
        claim("T4 7opt top1 > 0.5", a2, ">", 0.5)
        claim("T4 7opt top1 >= 7opt noVS top1 - 0.012", a2, ">=",
              fp + t4["2b_7opt_noVS"] - CLAIM_MARGIN)
    if pruned:
        claim("T6 pruned top1 > 0.8", pruned["top1"], ">", 0.8)
        claim("T6 |pruned stage-0 w1 sparsity - 0.5| < 1e-6",
              abs(pruned["sparsity"] - 0.5), "<", 1e-6)
    if t6:
        fp = t6["stc_fp32_pruned"]
        claim("T6 STC 5opt top1 > pruned fp32 - 0.03",
              fp + t6["stc_4b_5opt"], ">", fp - 0.03)
    if st:
        claim("stats zero_fraction > 0.3", st["zero_fraction"], ">", 0.3)
        claim("stats bit7 < bit5", st["bit7_toggle_nonzero"], "<",
              st["bit5_toggle_nonzero"])
    return {n: (v, b, bool(_OPS[op](v, b))) for n, v, op, b in claims}


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> Dict:
    """The tables' CLI (module docstring). Returns {"tables": {name:
    rows}, "claims": paper_claims(...)}."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.paper_tables",
        description="The paper's Tables 1-6 and bit statistics on the "
                    "CNN path, as CSV rows.")
    ap.add_argument("--tables", default=",".join(TABLES),
                    help=f"comma-separated, of {','.join(TABLES)}")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    args = ap.parse_args(argv)
    want = args.tables.split(",")
    unknown = sorted(set(want) - set(TABLES))
    if unknown:
        ap.error(f"unknown tables {unknown}; the port has {TABLES}")
    dev = resolve_device(args.device)
    print("table,config,metric,value", flush=True)
    tables: Dict[str, List[Row]] = {}

    def put(name, rows):
        emit(name, rows)
        tables[name] = rows

    model = errs = pruned_info = evalb = None
    if {"1", "2", "3", "4", "stats"} & set(want):
        model = cnn_train.train_cnn(device=dev)
        scales = cnn_eval.calibrate_cnn(model, device=dev)
        evalb = cnn_eval.eval_batches(model["cfg"], device=dev)
    if "1" in want:
        put("table1", table1_precision_grid(model, scales, evalb, dev))
        errs = {n: cnn_eval.logit_err(model, scales, _C[n], device=dev)
                for n in CLAIM_ERR_CODECS}
    if "2" in want:
        put("table2", table2_sparq_configs(model, scales, evalb, dev))
    if "3" in want:
        put("table3", table3_baselines(model, scales, evalb, device=dev))
    if "4" in want:
        put("table4", table4_low_bits(model, scales, evalb, dev))
    if "5" in want:
        put("table5", table5_rows(dev))
        if dev.type != "cuda":
            _log("# table5: ms, ms_rel and int8_int_mm need the card; "
                 f"left out on {dev.type}")
    if "6" in want:
        pruned = cnn_train.train_cnn(prune_2_4=True, device=dev)
        w = pruned["params"]["stages"][0][0]["w1"]
        pruned_info = dict(
            top1=cnn_eval.cnn_accuracy(pruned, batches=evalb, device=dev),
            sparsity=sparsity(w.reshape(-1, w.shape[-1])))
        pscales = cnn_eval.calibrate_cnn(pruned, device=dev)
        put("table6", table6_sparse_tc(pruned, pscales, device=dev))
    if "stats" in want:
        put("bit_stats", bit_stats(model, device=dev))
    sys.stdout.flush()
    claims = paper_claims(tables, errs, pruned_info)
    for name, (value, bound, held) in claims.items():
        _log(f"# {name}: {value} against {bound}: "
             f"{'held' if held else 'NOT held'}")
    return {"tables": tables, "claims": claims}


if __name__ == "__main__":
    main()
