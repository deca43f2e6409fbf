"""Smoke run of the PyTorch/CUDA port on one GPU (the quickest proof that
the port still starts on the card).

    python3 chip_smoke.py            # every phase, as the acceptance run
    python3 chip_smoke.py --phases build,kernels

Phases (each one that fails makes the script exit non-zero):
  build       nvcc-build the six hand-written kernels from
              src/repro_torch/csrc, one nvcc per source, all at once;
              cuobjdump -sass of K1's library must show IMMA (int8 tensor
              cores) and no IDP4A, and K3's DMMA (f64 tensor cores)
  kernels     each kernel against its plain PyTorch version on the card, at
              the shapes the main paths give it: K1 sparq_matmul (M = 8,
              256, 445, 2048 on the four projections, 5opt and a8w8, each
              shape run twice: both runs equal and bit-exact; its tile
              plan logged per row), K4 sparq_quant and K6 sparq_dequant
              bit-exact; K2 paged decode and K5 contiguous decode (the
              split-key body) at their serving shapes and at hd 16 / G 4,
              hd 128 and misaligned planes, K3 chunked prefill at every
              K3_SHAPES shape (hd 64 G 8, the serving shape; hd 16, hd 128
              at G 8 and G 48, bq * G = 128, page size 128, hd 256, hd 10,
              misaligned tensors, and the exact shapes of the cli and wide
              paths, a 32-token chunk over a long history, each at the
              instantiation k3_traits names) on the K3_LAYOUTS that
              fit the chunk (check_k3), all without and with a sliding
              window, each within 1e-4 of an f64 evaluation and of
              its plain version (PLAIN_TOL beyond the serving shapes, where
              the plain version's own f32 error passes 1e-4); K5 with bk =
              16 against K2 on the same bytes laid out as pages, at a cur
              inside a split and on a split boundary: difference 0.0.
              Times of the kernel, the plain version and one PyTorch
              library call where one computes the same function, and each
              kernel's least possible time from its bytes and operations
  serve       tinyllama-1.1b at full width (22 layers, bf16, 5opt, int8
              weights, one calibration batch) serves 8 ragged requests
              through the paged chunked-prefill engine: K1, K2, K3 and K4
              at every KV write (2 x 22 per chunk and per decode step)
  scan        the same model, `DecodeEngine.generate` on batch 8, prompt
              256, gen 32 over the contiguous sparq cache: K1 = 7*22*32,
              K4 = 2*22*32, K5 = 22*31, K2 = K3 = K6 = 0; then every layer's
              K/V read back through `CacheStore.kv()` (K6, 44 launches),
              equal to the plain dequant of the same bytes
  sequential  the serve phase's 8 requests through the paged engine with
              sequential admission (prefill alone, adopt into pages): K1,
              K2, K4 at every write, K3 = K5 = 0
  cli         `python -m repro_torch.launch.serve` (CLI_ARGS: the reduced
              tinyllama, paged chunked engine, sparq KV, 5opt) through its
              `main`: every request returns its tokens; K3 at every chunk's
              layer (hd 16 G 4), K2 every decode step
  wide        the same CLI at full width with --chunk-align 16
              --page-size 128 (WIDE_ARGS: 22 layers, K3 at 128 query rows
              a tile in two row blocks, two key tiles a page): the same
              checks
  parity      2-layer full-width f32 models on the card (kernels) and on
              the CPU (plain versions): the paged chunked engine (also at
              chunk-align 16 and page size 128) and the scan engine give
              equal greedy tokens; on the card, the paged
              sequential engine equals the scan engine serving each request
              alone with attn_bk = page_size
  profile     (not run by default) the serve workload once more under
              torch.profiler: device time by kernel and the device's idle
              share of the run

Each of serve, scan, sequential, cli and wide resets the launch counters
just before it drives its path and reads them just after; the plain
versions of the KV codec must not run there at all. With all five, every
kernel must have launched on some path.

Output: progress lines, then the card's name and power limit, one JSON line
of per-kernel results, and last `{"ok": true, "device": {...}}`. Full
results also go to chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_INT8_OPS_S = 1979e12     # dense int8 tensor-core rate
H100_F32_FLOPS_S = 67e12      # f32 outside the tensor cores
H100_F64_MMA_FLOPS_S = 67e12  # f64 tensor cores (DMMA), the same rate
L2_BYTES = 50 * 2 ** 20


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


# cycles of torch.cuda._sleep queued ahead of a timed loop (~50 ms at the
# H100's clocks): the card stays busy while the host queues the timed
# launches, which then run back to back, so a small kernel's time is its
# device time and not its wrapper's Python overhead
SLEEP_CYCLES = 100_000_000


def bench(fn, arg_sets, iters=50, warmup=5):
    """Mean ms per call on the card (CUDA events), cycling through input
    sets large enough together to defeat the 50 MB L2 cache."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(bytes_per_set: int) -> int:
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(bytes_per_set, 1))))


# ----------------------------------------------------------------------
# phase: kernels against their plain versions
# ----------------------------------------------------------------------

PROJ = {"wq/wo": (2048, 2048), "wk/wv": (2048, 256),
        "gate/up": (2048, 5632), "down": (5632, 2048)}


# M of K1's calls on the main paths: decode (8 active slots), one prefill
# chunk (256), the longest serve prompt alone (445, ragged) and the scan
# prefill (8 x 256)
K1_MS = (8, 256, 445, 2048)
# one layer's seven projections: wq, wk, wv, wo, gate, up, down
LAYER = {"wq/wo": 2, "wk/wv": 2, "gate/up": 2, "down": 1}


def check_k1(dev, results):
    from repro_torch.core.sparq import SparqConfig
    from repro_torch.kernels import sparq_matmul as mm
    from repro_torch.kernels.ref import quantize_codes
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    rows = []
    for codec_name, cfg in (("5opt", SparqConfig.opt5(signed=True)),
                            ("a8w8", SparqConfig(enabled=False,
                                                 signed=True))):
        kw = dict(bits=cfg.bits, opts_shifts=cfg.shifts,
                  rounding=cfg.rounding, vsparq=cfg.vsparq,
                  signed=cfg.signed, max_val=cfg.max_val,
                  enabled=cfg.enabled)
        for proj, (K, N) in PROJ.items():
            for M in K1_MS:
                def make():
                    x = torch.randn((M, K), generator=gen, device=dev)
                    x = torch.where(torch.rand((M, K), generator=gen,
                                               device=dev) < 0.3, 0.0, x)
                    x = x.to(torch.bfloat16)
                    w = torch.randint(-127, 128, (K, N), generator=gen,
                                      device=dev, dtype=torch.int8)
                    c = torch.rand((N,), generator=gen, device=dev) * 1e-3
                    a = (x.abs().amax().float() / cfg.max_val).reshape(1)
                    return x, w, a, c
                sets = [make() for _ in range(n_sets(K * N + M * K * 2))]
                x, w, a, c = sets[0]
                got = mm.sparq_matmul_cuda(x, w, a, c, **kw)
                # split-K's slices finish in another order on each run
                again = mm.sparq_matmul_cuda(x, w, a, c, **kw)
                want = mm.ref_sparq_matmul(x, w, a, c, **kw)
                torch.cuda.synchronize()
                exact = torch.equal(got, want)
                err = float((got - want).abs().max())
                worst = max(worst, err)
                if not exact:
                    raise AssertionError(
                        f"K1 {codec_name} {proj} M={M}: not bit-exact "
                        f"(max abs err {err})")
                if not torch.equal(got, again):
                    raise AssertionError(
                        f"K1 {codec_name} {proj} M={M}: two runs differ")
                p = mm.plan(M, N, K, mm.sm_count(dev))
                ms = bench(lambda *s: mm.sparq_matmul_cuda(*s, **kw), sets)
                plain_ms = bench(lambda *s: mm.ref_sparq_matmul(*s, **kw),
                                 sets, iters=5, warmup=1)
                # yardstick: torch._int_mm on the codes + the scaling;
                # _int_mm takes M > 16 and M a multiple of 8, so the codes
                # are zero-padded to lib_m rows where M is not
                lib_m = max(24, -(-M // 8) * 8)

                def codes(s):
                    q = torch.zeros((lib_m, K), dtype=torch.int8,
                                    device=dev)
                    q[:M] = quantize_codes(s[0], s[2], True, 127)
                    return q, s[1], s[2], s[3]
                lib_ms = bench(lambda xq, w_, a_, c_: (torch._int_mm(
                    xq, w_).float() * a_) * c_, [codes(s) for s in sets])
                nbytes = M * K * 2 + K * N + N * 4 + M * N * 4
                bound = max(nbytes / H100_BYTES_S,
                            2 * M * N * K / H100_INT8_OPS_S) * 1e3
                row = dict(codec=codec_name, proj=proj, M=M, K=K, N=N,
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           library_m=lib_m, bound_ms=bound,
                           bound_by="bytes" if nbytes / H100_BYTES_S
                           >= 2 * M * N * K / H100_INT8_OPS_S
                           else "operations", exact=exact,
                           plan=dict(bm=p.bm, bn=p.bn, split_k=p.split_k,
                                     blocks=p.blocks))
                rows.append(row)
                log(f"K1 sparq_matmul {codec_name} {proj:7s} M={M:4d} "
                    f"K={K} N={N} [BM {p.bm} BN {p.bn} split {p.split_k} "
                    f"blocks {p.blocks}]: bit-exact x2, {ms:.4f} ms (plain "
                    f"{plain_ms:.3f} ms, _int_mm {lib_ms:.4f} ms"
                    f"{f' padded to M={lib_m}' if lib_m != M else ''}, "
                    f"bound {bound:.4f} ms)")
        layer = {k: sum(n * r[k] for r in rows for p_, n in LAYER.items()
                        if r["codec"] == codec_name and r["M"] == 8
                        and r["proj"] == p_)
                 for k in ("ms", "library_ms", "bound_ms")}
        results.setdefault("sparq_matmul_layer_m8", {})[codec_name] = layer
        log(f"K1 {codec_name} one layer's seven projections at M=8: "
            f"{layer['ms']:.4f} ms (_int_mm padded {layer['library_ms']:.4f}"
            f" ms, bound {layer['bound_ms']:.4f} ms)")
        # off the main path: ragged K (kp > K), N % 16 != 0 (the kernel's
        # byte-wise weight copies) and split-K over a ragged last tile
        for M, K, N in ((37, 70, 40), (8, 1030, 200)):
            x = torch.randn((M, K), generator=gen, device=dev)
            w = torch.randint(-127, 128, (K, N), generator=gen,
                              device=dev, dtype=torch.int8)
            c = torch.rand((N,), generator=gen, device=dev) * 1e-3
            a = (x.abs().amax() / cfg.max_val).reshape(1)
            got = mm.sparq_matmul_cuda(x, w, a, c, **kw)
            again = mm.sparq_matmul_cuda(x, w, a, c, **kw)
            want = mm.ref_sparq_matmul(x, w, a, c, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(again, want)):
                raise AssertionError(
                    f"K1 {codec_name} ragged M={M} K={K} N={N}: not "
                    f"bit-exact (max abs err "
                    f"{float((got - want).abs().max())})")
            p = mm.plan(M, N, K, mm.sm_count(dev))
            log(f"K1 sparq_matmul {codec_name} ragged M={M} K={K} N={N} f32 "
                f"[BM {p.bm} BN {p.bn} split {p.split_k} blocks "
                f"{p.blocks}]: bit-exact x2")
    # the JSON line's representative: one prefill-chunk gate/up
    # projection; every shape is in rows
    rep = next(r for r in rows if r["codec"] == "5opt"
               and r["proj"] == "gate/up" and r["M"] == 256)
    results["sparq_matmul"] = dict(
        max_abs_err=worst, ms=rep["ms"], plain_ms=rep["plain_ms"],
        bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
        library_ms=rep["library_ms"],
        shape="5opt gate/up M=256 K=2048 N=5632", rows=rows)


def _pools(gen, dev, P, ps, KV, hd, misalign=False):
    """Random packed data and meta planes; with `misalign` each starts one
    byte past a 16-byte boundary (the kernels' byte-wise load path)."""
    def plane(lo, hi):
        t = torch.randint(lo, hi, (P, ps, KV, hd), generator=gen,
                          device=dev, dtype=torch.int8)
        if not misalign:
            return t
        buf = torch.empty((t.numel() + 1,), dtype=torch.int8, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    return plane(-15, 16), plane(0, 128)


def _dequant_pages(data, meta, pages, scale):
    from repro_torch.kernels.ref import _meta_decode32
    return _meta_decode32(data[pages], meta[pages], scale)


# window > 0 cases: K2's skips the first blocks of long slots and masks
# inside a page; K3's cuts into slot 0's history pages and its chunk keys
K2_WINDOW, K3_WINDOW = 100, 64


def decode_f64_reference(q, k, v, live):
    """The decode attention of K2 and K5 with the oracles' rounding points
    up to the scores (q.k rounded to f32, times the f32 scale) and
    everything after in f64: one softmax per query row over all its live
    keys. q [B, KV, G, hd]; k, v the decoded keys and values [B, n, KV, hd]
    f32; live [B, n] bool. The yardstick of how far the kernels and their
    plain versions each lie from the exact result; a slot without a live
    key gives zeros."""
    hd = q.shape[-1]
    sc = torch.tensor(hd ** -0.5, dtype=torch.float32, device=q.device)
    s = (torch.einsum("bkgh,bnkh->bkgn", q.double(), k.double()).float()
         * sc).double()
    ok = live[:, None, None, :]
    x = torch.where(ok, s, float("-inf"))
    mx = x.amax(-1, keepdim=True)
    e = torch.where(ok, torch.exp(x - torch.where(torch.isinf(mx), 0.0, mx)),
                    0.0)
    o = torch.einsum("bkgn,bnkh->bkgh", e, v.double())
    return o / e.sum(-1, keepdim=True).clamp(min=1e-300)


def paged_keys(kd, km, ks, vd, vm, vs, bt, cur, window=0):
    """K2's keys as decode_f64_reference takes them: each slot's logical
    positions [0, NB * ps) decoded through its block table, and K2's mask
    (`paged_live`)."""
    from repro_torch.kernels.ref import _meta_decode32
    from repro_torch.kernels.sparq_decode_attn import paged_live
    B, NB = bt.shape
    ps, KV, hd = kd.shape[1:]
    pg = bt.clamp(min=0).long()

    def keys(d, m, s):
        return _meta_decode32(d[pg], m[pg], s.reshape(B, 1, 1, 1, 1)) \
            .reshape(B, NB * ps, KV, hd)
    live = paged_live(bt.cpu().numpy(), cur.cpu().numpy(), ps, window)
    return keys(kd, km, ks), keys(vd, vm, vs), torch.from_numpy(live).to(
        bt.device)


def contig_keys(kd, km, ks, vd, vm, vs, kpos, cur, window=0):
    """K5's keys as decode_f64_reference takes them: the Tk rows decoded,
    and K5's mask (`contig_live`)."""
    from repro_torch.kernels.ref import _meta_decode32
    from repro_torch.kernels.sparq_decode_attn import contig_live
    live = contig_live(kpos.cpu().numpy(), cur.cpu().numpy(), window)
    return (_meta_decode32(kd, km, ks.reshape(())),
            _meta_decode32(vd, vm, vs.reshape(())),
            torch.from_numpy(live).to(kpos.device))


# K2's slots: cur per slot (slot 4 inactive); slot 5's block table is
# allocated up to page 20 only
K2_CURS = [599, 433, 17, 300, -1, 511, 64, 250]
# K2 and K5 beyond their timed shape (G 8, hd 64): (G, hd, misaligned
# planes) — the reduced tinyllama's heads, granite-class hd 128, the
# byte-wise load path, and a head dim that is not a multiple of 4 (the
# scalar score loop)
DECODE_SHAPES = {"hd 16 G 4": (4, 16, False), "hd 128 G 8": (8, 128, False),
                 "hd 64 G 8 unaligned": (8, 64, True),
                 "hd 10 G 4": (4, 10, False)}


# How far a kernel may lie from its plain version. The plain versions sum
# f32 products in f32, and their own error grows with the length of those
# sums and with the inputs: on the serving shapes (K2's and K5's timed
# cases, K3 at hd 64 G 8) chip_smoke's inputs keep it under 1e-4, but at
# hd 128, at pages of 128 keys and on other random inputs it passes 1e-4
# (it is logged beside every case as "plain vs f64"). So every kernel is
# held to the f64 evaluation by 1e-4, which holds its accuracy, and to its
# plain version by 1e-4 on the serving shapes and by PLAIN_TOL beyond them,
# which still catches any difference in what is computed.
PLAIN_TOL = 1e-3


def hold(what, got, want, exact, plain_tol=1e-4):
    """Hold a kernel's output within plain_tol of its plain version and
    within 1e-4 of the f64 evaluation; returns the distances (kernel -
    plain, kernel - f64, plain - f64, all max abs)."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err64 = float((got.double() - exact).abs().max())
    plain64 = float((want.double() - exact).abs().max())
    if not torch.isfinite(got).all() or err > plain_tol or err64 > 1e-4:
        raise AssertionError(
            f"{what}: max abs err {err} against the plain version (limit "
            f"{plain_tol}), {err64} against f64 (limit 1e-4); the plain "
            f"version lies {plain64} from f64")
    return dict(plain=err, f64=err64, plain_f64=plain64)


def _log_decode(name, errs):
    log(f"{name} max abs err vs plain / vs f64 (plain vs f64): " + ", ".join(
        f"{k} {v['plain']:.2e} / {v['f64']:.2e} ({v['plain_f64']:.2e})"
        for k, v in errs.items()))


def k2_case(gen, dev, G=8, hd=64, misalign=False, S=8, KV=4, ps=16, NB=40):
    """K2's inputs at check_k2's slots (K2_CURS), random from `gen`: each
    active slot's pages up to its cur, permuted in the pool, slot 5's table
    cut at page 20."""
    curs = K2_CURS
    P = sum(c // ps + 1 for c in curs if c >= 0) + 8
    kd, km = _pools(gen, dev, P + 1, ps, KV, hd, misalign)
    vd, vm = _pools(gen, dev, P + 1, ps, KV, hd, misalign)
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    bt = torch.full((S, NB), -1, dtype=torch.int32, device=dev)
    at = 0
    for s, c in enumerate(curs):
        if c < 0:
            continue
        n = c // ps + 1
        bt[s, :n] = perm[at:at + n]
        at += n
    bt[5, 20:] = -1               # partially allocated table (cur 511)
    q = torch.randn((S, KV, G, hd), generator=gen, device=dev)
    ks = torch.rand((S,), generator=gen, device=dev) * 0.02 + 0.005
    vs = torch.rand((S,), generator=gen, device=dev) * 0.02 + 0.005
    cur = torch.tensor(curs, dtype=torch.int32, device=dev)
    return q, kd, km, ks, vd, vm, vs, bt, cur


def check_k2(dev, results):
    """K2 at check_k2's slots (timed) and at DECODE_SHAPES, without and
    with a window, held by `hold` to its plain version and to
    decode_f64_reference; the inactive slot exactly zero."""
    import torch.nn.functional as F
    from repro_torch.kernels import sparq_decode_attn as dec
    gen = torch.Generator(device=dev).manual_seed(2)
    S, KV, G, hd, ps = 8, 4, 8, 64, 16
    curs = K2_CURS
    NB = 40
    P = sum(c // ps + 1 for c in curs if c >= 0) + 8
    sets = [k2_case(gen, dev)
            for _ in range(n_sets(4 * (P + 1) * ps * KV * hd))]
    args = sets[0]
    cases = [("timed", args)] + [(name, k2_case(gen, dev, *shape))
                                 for name, shape in DECODE_SHAPES.items()]
    errs = {}
    for name, a in cases:
        # window > 0: K2 masks whole splits and keys inside a page
        for window in (0, K2_WINDOW):
            what = f"K2 {name}, window {window}"
            got = dec.sparq_paged_decode_attn_cuda(*a, window=window)
            want = dec.ref_sparq_paged_decode_attn(*a, window=window)
            exact = decode_f64_reference(a[0], *paged_keys(*a[1:],
                                                           window=window))
            errs[f"{name}, window {window}"] = hold(
                what, got, want, exact, 1e-4 if name == "timed" else PLAIN_TOL)
            if not torch.all(got[4] == 0):
                raise AssertionError(f"{what}: inactive slot is not exactly "
                                     f"zero")
    _log_decode("K2", errs)
    err = max(e["plain"] for k, e in errs.items() if k.startswith("timed"))
    plans = dec.split_plan(dec.paged_live(args[7].cpu().numpy(), curs, ps),
                           ps)
    blocks = KV * sum(len(p) for p in plans)
    geo = dec.split_geometry(NB * ps, ps)
    ms = bench(dec.sparq_paged_decode_attn_cuda, sets)
    plain_ms = bench(dec.ref_sparq_paged_decode_attn, sets, iters=5,
                     warmup=1)
    # library yardstick: SDPA over the dequantized K/V (decode excluded)
    bt5 = args[7]
    lens = [min(c + 1, int((bt5[s] >= 0).sum()) * ps) if c >= 0 else 0
            for s, c in enumerate(curs)]
    T = max(lens)
    kk = torch.zeros((S, KV, T, hd), device=dev)
    vv = torch.zeros((S, KV, T, hd), device=dev)
    mask = torch.zeros((S, 1, 1, T), dtype=torch.bool, device=dev)
    for s, n in enumerate(lens):
        if n == 0:
            continue
        pages = bt5[s, :math.ceil(n / ps)].long()
        kk[s, :, :n] = _dequant_pages(args[1], args[2], pages, args[3][s]) \
            .reshape(-1, KV, hd)[:n].transpose(0, 1)
        vv[s, :, :n] = _dequant_pages(args[4], args[5], pages, args[6][s]) \
            .reshape(-1, KV, hd)[:n].transpose(0, 1)
        mask[s, ..., :n] = True
    qh = args[0].reshape(S, KV * G, 1, hd)
    kk, vv = kk.repeat_interleave(G, 1), vv.repeat_interleave(G, 1)
    lib_ms = bench(lambda: F.scaled_dot_product_attention(
        qh, kk, vv, attn_mask=mask), [()])
    tokens = sum(lens)
    nbytes = (S * KV * G * hd * 4 * 2 + tokens * KV * hd * 4 + S * 8
              + S * NB * 4 + S * 4)
    flops = 4 * tokens * KV * G * hd
    bound = max(nbytes / H100_BYTES_S, flops / H100_F32_FLOPS_S) * 1e3
    results["sparq_paged_decode_attn"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound, bound_by="bytes" if nbytes / H100_BYTES_S
        >= flops / H100_F32_FLOPS_S else "operations", errors=errs,
        live_blocks=blocks, grid=[S, KV, geo.n_splits],
        shape=f"S={S} KV={KV} G={G} hd={hd} ps={ps} cur={curs}")
    log(f"K2 sparq_paged_decode_attn: max abs err {err:.2e}, {ms:.4f} ms "
        f"(plain {plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound "
        f"{bound:.5f} ms, {tokens} cached tokens, grid {S}x{KV}x"
        f"{geo.n_splits}, {blocks} blocks with live keys)")


# K3's layouts of one 256-token chunk: runs (slot, first pos, tokens, hist,
# seg) packed in order, each aligned to bq = 8; a token's hist is `hist`,
# or with seg > 0 the start of its segment, (pos // seg) * seg, as the
# scheduler sets it. Beside the runs: pages allocated per slot, and block
# table holes (slot, logical page) set to -1.
K3_LAYOUTS = {
    # timed: slot 0 is the second segment of a 400-token prompt (positions
    # 256..399, hist 256: 16 packed pages of history), slot 1 a fresh
    # 96-token prompt, then 16 rows of padding
    "timed": ([(0, 256, 144, 256, 0), (1, 0, 96, 0, 0)],
              {0: 25, 1: 6}, []),
    # serve-like: four sequences whose runs of 77, 45, 100 and 1 tokens end
    # in partial query tiles; slot 0's hist moves from 192 to 256 inside
    # its run and inside one query tile (seg 64); slot 1's hist 37 and
    # slot 3's 50 are not page-aligned; slot 0's history has a hole
    "serve-like": ([(0, 203, 77, 0, 64), (1, 37, 45, 37, 0),
                    (2, 0, 100, 0, 0), (3, 50, 1, 50, 0)],
                   {0: 18, 1: 6, 2: 7, 3: 4}, [(0, 5)]),
    # long history: the 17th 32-token chunk of one prompt (positions
    # 512..543, hist 512: 32 pages of history, one of them a hole) at the
    # CLI's chunk size, the chunk of the cli and wide paths
    "long history": ([(0, 512, 32, 512, 0)], {0: 34}, [(0, 9)]),
}


def k3_layouts(C, bq=8):
    """The K3_LAYOUTS whose runs fit a chunk of C tokens."""
    return [name for name, (runs, _, _) in K3_LAYOUTS.items()
            if sum(-(-n // bq) * bq for _, _, n, _, _ in runs) <= C]


def k3_stream(runs, C, bq):
    """seq_id, pos, hist (C,) and tile_seq (C / bq,), int32 numpy arrays,
    for runs (slot, first pos, tokens, hist, seg) packed as K3_LAYOUTS
    says."""
    seq_id = np.full(C, -1, np.int32)
    pos = np.zeros(C, np.int32)
    hist = np.zeros(C, np.int32)
    tile_seq = np.full(C // bq, -1, np.int32)
    at = 0
    for slot, start, n, h, seg in runs:
        p = np.arange(start, start + n)
        seq_id[at:at + n] = slot
        pos[at:at + n] = p
        hist[at:at + n] = (p // seg) * seg if seg else h
        tile_seq[at // bq:(at + n + bq - 1) // bq] = slot
        at += -(-n // bq) * bq
    assert at <= C, runs
    return seq_id, pos, hist, tile_seq


def k3_case(gen, dev, layout, S=8, KV=4, G=8, hd=64, ps=16, C=256, bq=8,
            misalign=False):
    """K3's inputs for one of K3_LAYOUTS, random from `gen`. The layout's
    page counts and holes are in pages of 16 positions; another page size
    covers the same positions (34 x 16 of table, a pool of 40 x 16). With
    `misalign`, q starts 4 bytes and the pools 1 byte past a 16-byte
    boundary (the wrapper hands the kernel aligned copies)."""
    runs, pages, holes = K3_LAYOUTS[layout]
    NB, P = -(-34 * 16 // ps), -(-40 * 16 // ps)
    kd, km = _pools(gen, dev, P + 1, ps, KV, hd, misalign)
    vd, vm = _pools(gen, dev, P + 1, ps, KV, hd, misalign)
    bt = torch.full((S, NB), -1, dtype=torch.int32, device=dev)
    for slot, n in pages.items():
        n = -(-n * 16 // ps)
        bt[slot, :n] = torch.randperm(P, generator=gen, device=dev)[:n] \
            .to(torch.int32)
    for slot, t in holes:
        bt[slot, t * 16 // ps] = -1
    seq_id, pos, hist, tile_seq = (
        torch.from_numpy(a).to(dev) for a in k3_stream(runs, C, bq))
    q = torch.randn((C, KV, G, hd), generator=gen, device=dev)
    if misalign:
        q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
    kc = torch.randn((C, KV, hd), generator=gen, device=dev)
    vc = torch.randn((C, KV, hd), generator=gen, device=dev)
    ks = torch.rand((S,), generator=gen, device=dev) * 0.02 + 0.005
    vs = torch.rand((S,), generator=gen, device=dev) * 0.02 + 0.005
    return (q, kc, vc, kd, km, ks, vd, vm, vs, bt, seq_id, pos, hist,
            tile_seq)


def k3_f64_reference(q, kc, vc, kd, km, ks, vd, vm, vs, bt, sid, pos, hist,
                     tile_seq, window=0):
    """K3's function with the oracle's rounding points up to the scores
    (q.k rounded to f32, times the f32 scale) and everything after in f64:
    one softmax per row over all its keys. The yardstick of how far the
    kernel and its plain version each lie from the exact result."""
    from repro_torch.kernels.ref import _meta_decode32
    C, KV, G, hd = q.shape
    ps, NB = kd.shape[1], bt.shape[1]
    T = NB * ps
    tseq = tile_seq.long().repeat_interleave(C // tile_seq.shape[0])
    sc = torch.tensor(hd ** -0.5, dtype=torch.float32, device=q.device)
    q64 = q.double()
    kp = torch.arange(T, device=q.device)
    s_c = (torch.einsum("ckgh,jkh->ckgj", q64, kc.double()).float()
           * sc).double()
    ok_c = (sid[None] == sid[:, None]) & (sid >= 0)[:, None] \
        & (pos[None] <= pos[:, None]) & (pos[None] >= hist[:, None])
    if window:
        ok_c &= pos[None] > pos[:, None] - window
    out = torch.zeros(q.shape, dtype=torch.float64, device=q.device)
    for slot in torch.unique(tseq[tseq >= 0]).tolist():
        rows = torch.nonzero(tseq == slot)[:, 0]
        pages = bt[slot]
        pg = pages.clamp(min=0).long()
        k = _meta_decode32(kd[pg], km[pg], ks[slot]).reshape(T, KV, hd)
        v = _meta_decode32(vd[pg], vm[pg], vs[slot]).reshape(T, KV, hd)
        s_h = (torch.einsum("ckgh,tkh->ckgt", q64[rows], k.double()).float()
               * sc).double()
        ok_h = (pages[kp // ps] >= 0)[None] & (sid[rows] >= 0)[:, None] \
            & (kp[None] < hist[rows, None])
        if window:
            ok_h &= kp[None] > pos[rows, None] - window
        ok = torch.cat([ok_h, ok_c[rows]], 1)[:, None, None, :]
        x = torch.where(ok, torch.cat([s_h, s_c[rows]], -1), float("-inf"))
        mx = x.amax(-1, keepdim=True)
        e = torch.where(ok, torch.exp(x - torch.where(torch.isinf(mx), 0.0,
                                                      mx)), 0.0)
        o = torch.einsum("ckgt,tkh->ckgh", e[..., :T], v.double()) \
            + torch.einsum("ckgj,jkh->ckgh", e[..., T:], vc.double())
        out[rows] = o / e.sum(-1, keepdim=True).clamp(min=1e-300)
    return out


# K3's shapes: (KV, G, hd, ps, bq, misalign, C) and the instantiation
# k3_traits must pick, (head dim, key tile, rows a block, row blocks). The
# first is the serving shape (full tinyllama at the CLI defaults); then the
# reduced tinyllama's heads (the North-star --reduced run), hd 128 (G 8 and
# granite-class G 48 over one KV head), 128 query rows a tile
# (--chunk-align 16), --page-size 128, hd 256, a head dim that is not a
# multiple of 16 (2-byte and 8-byte loads, zero-padded to 16), misaligned
# tensors (aligned copies), and the shapes the cli and wide paths give K3
# (`cli_k3_shape` of CLI_ARGS and WIDE_ARGS: a 32-token chunk, the wide
# one in two row blocks of 16-token query tiles over key tiles that are
# slices of 128-key pages)
K3_SHAPES = {"hd 64 G 8": ((4, 8, 64, 16, 8, False, 256), (64, 64, 64, 1)),
             "hd 16 G 4": ((4, 4, 16, 16, 8, False, 256), (16, 64, 32, 1)),
             "hd 128 G 8": ((4, 8, 128, 16, 8, False, 256),
                            (128, 32, 64, 1)),
             "hd 128 G 48 KV 1": ((1, 48, 128, 16, 8, False, 256),
                                  (128, 32, 64, 6)),
             "bq*G 128": ((4, 8, 64, 16, 16, False, 256), (64, 64, 64, 2)),
             "ps 128": ((4, 8, 64, 128, 8, False, 256), (64, 64, 64, 1)),
             "hd 256 G 8": ((4, 8, 256, 16, 8, False, 256),
                            (256, 16, 32, 2)),
             "hd 10 G 4": ((4, 4, 10, 16, 8, False, 256), (16, 64, 32, 1)),
             "hd 64 G 8 misaligned": ((4, 8, 64, 16, 8, True, 256),
                                      (64, 64, 64, 1)),
             "cli": ((2, 4, 16, 16, 8, False, 32), (16, 64, 32, 1)),
             "wide": ((4, 8, 64, 128, 16, False, 32), (64, 64, 64, 2))}
# the shapes timed, on the timed layout where it fits the chunk, else on
# the long history (the serving shape is the JSON line's row)
K3_TIMED = ("hd 64 G 8", "hd 16 G 4", "hd 128 G 8", "hd 128 G 48 KV 1",
            "bq*G 128", "ps 128", "hd 256 G 8", "cli", "wide")


def k3_timed_layout(C):
    return "timed" if "timed" in k3_layouts(C) else "long history"


def _k3_timing(dev, sets, G, hd, ps, bq):
    """K3's time on sets (a layout whose slot 0 holds every history page)
    beside its plain version, one SDPA call and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import sparq_prefill_attn as pre
    C, KV = sets[0][0].shape[:2]
    S, NB = sets[0][9].shape
    ms = bench(pre.sparq_chunked_prefill_attn_cuda, sets)
    plain_ms = bench(pre.ref_sparq_chunked_prefill_attn, sets, iters=5,
                     warmup=1)
    # library yardstick: one SDPA call over [dequantized history of slot 0
    # ; the chunk's float K/V] with the same mask (decode excluded)
    q, kc, vc, kd, km, ks, vd, vm, vs, bt, sid, pos, hist, _ = sets[0]
    Th = int(hist[sid == 0].max())   # slot 0's history
    pages = bt[0, :-(-Th // ps)].long()
    kh = _dequant_pages(kd, km, pages, ks[0]).reshape(-1, KV, hd)[:Th]
    vh = _dequant_pages(vd, vm, pages, vs[0]).reshape(-1, KV, hd)[:Th]
    kall = torch.cat([kh, kc]).transpose(0, 1)[None]   # [1, KV, Th+C, hd]
    vall = torch.cat([vh, vc]).transpose(0, 1)[None]
    kall = kall.repeat_interleave(G, 1)
    vall = vall.repeat_interleave(G, 1)
    hpos = torch.arange(Th, device=dev)
    m_hist = (sid[:, None] == 0) & (hpos[None, :] < hist[:, None])
    m_chunk = (sid[:, None] == sid[None, :]) & (sid[:, None] >= 0) \
        & (pos[None, :] <= pos[:, None]) & (pos[None, :] >= hist[:, None])
    mask = torch.cat([m_hist, m_chunk], 1)               # [C, Th + C]
    qh = q.reshape(C, KV * G, hd).transpose(0, 1)[None]
    lib_ms = bench(lambda: F.scaled_dot_product_attention(
        qh, kall, vall, attn_mask=mask), [()])
    pairs = int(mask.sum())
    nbytes = (C * KV * G * hd * 4 * 2 + C * KV * hd * 4 * 2
              + Th * KV * hd * 4 + S * 8 + S * NB * 4 + C * 12 + C // bq * 4)
    flops = 4 * pairs * KV * G * hd   # QK^T and PV over all KV * G heads
    bound = max(nbytes / H100_BYTES_S, flops / H100_F64_MMA_FLOPS_S) * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / H100_BYTES_S
                >= flops / H100_F64_MMA_FLOPS_S else "operations")


def check_k3(dev, results):
    """K3 at every K3_SHAPES shape, on both layouts of K3_LAYOUTS, without
    and with a window: k3_traits picks the expected instantiation, and the
    output is held by `hold` to k3_f64_reference (1e-4) and to the plain
    version (1e-4 at the serving shape, PLAIN_TOL beyond it), padding rows
    exactly zero. Both distances are logged, with the plain version's own
    from the f64 result: its f32 sums, not the kernel, set the margin of
    the first gate. K3_TIMED are timed on the timed layout (the long
    history at a 32-token chunk), each beside one SDPA call and its
    bound."""
    from repro_torch.kernels import sparq_prefill_attn as pre
    gen = torch.Generator(device=dev).manual_seed(3)
    runs = K3_LAYOUTS["timed"][0]
    errs, f64_errs, timing = {}, {}, {}
    for shape, ((KV, G, hd, ps, bq, mis, C), want) in K3_SHAPES.items():
        tr = pre.k3_traits(hd, G, bq, ps)
        got_tr = (tr.hd, tr.key_tile, tr.rows, tr.row_blocks)
        if got_tr != want:
            raise AssertionError(f"K3 {shape}: k3_traits gave {tr}, "
                                 f"expected (hd, key tile, rows, row "
                                 f"blocks) = {want}")
        kw = dict(KV=KV, G=G, hd=hd, ps=ps, bq=bq, C=C)
        for layout in k3_layouts(C, bq):
            args = k3_case(gen, dev, layout, misalign=mis, **kw)
            for window in (0, K3_WINDOW):
                got = pre.sparq_chunked_prefill_attn_cuda(*args,
                                                          window=window)
                want_out = pre.ref_sparq_chunked_prefill_attn(*args,
                                                              window=window)
                exact = k3_f64_reference(*args, window=window)
                case = f"{shape}, {layout}, window {window}"
                e = hold(f"K3 chunked prefill, {case}", got, want_out, exact,
                         1e-4 if shape == "hd 64 G 8" else PLAIN_TOL)
                errs[case] = e["plain"]
                f64_errs[case] = dict(kernel=e["f64"], plain=e["plain_f64"])
                if not torch.all(got[args[10] < 0] == 0):
                    raise AssertionError(f"K3 {case}: padding rows are not "
                                         f"exactly zero")
        if shape in K3_TIMED:
            # the four planes of a pool of 41 x 16 positions
            layout = k3_timed_layout(C)
            sets = [k3_case(gen, dev, layout, **kw)
                    for _ in range(n_sets(4 * 41 * 16 * KV * hd))]
            timing[shape] = dict(_k3_timing(dev, sets, G, hd, ps, bq),
                                 traits=tr._asdict(), layout=layout)
            t = timing[shape]
            log(f"K3 {shape} ({tr.hd}/{tr.key_tile}/{tr.rows}x"
                f"{tr.row_blocks}) {layout} layout: "
                f"{t['ms']:.4f} ms (plain {t['plain_ms']:.3f} ms, SDPA "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms)")
    log("K3 max abs err vs plain: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    log("K3 max abs err vs f64, kernel / plain: " + ", ".join(
        f"{k} {v['kernel']:.2e} / {v['plain']:.2e}"
        for k, v in f64_errs.items()))
    dm = timing["hd 64 G 8"]
    results["sparq_chunked_prefill_attn"] = dict(
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("hd 64 G 8,")),
        **{k: dm[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by")},
        errors=errs, f64_errors=f64_errs, rows=timing,
        shape=f"C=256 bq=8 KV=4 G=8 hd=64 ps=16 "
              f"runs(slot,start,n,hist,seg)={runs}")
    r = results["sparq_chunked_prefill_attn"]
    log(f"K3 sparq_chunked_prefill_attn: max abs err {r['max_abs_err']:.2e}, "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, SDPA "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms)")


def check_k4(dev, results):
    """K4 at the scan path's shapes (prefill 8 x 256 tokens x 4 KV heads,
    decode 8 x 4 rows, one scale) and the paged path's (a 256-token chunk
    and a decode step, one scale per row), 5opt and a8w8: bit-exact."""
    from repro_torch.core.sparq import SparqConfig
    from repro_torch.kernels import sparq_quant as qk
    from repro_torch.kernels.ops import _codec_kw
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for codec_name, cfg in (("5opt", SparqConfig.opt5(signed=True)),
                            ("a8w8", SparqConfig(enabled=False,
                                                 signed=True))):
        kw = _codec_kw(cfg)
        for case, M, per_row in (("scan prefill", 8192, False),
                                 ("scan decode", 32, False),
                                 ("paged chunk", 1024, True),
                                 ("paged decode", 32, True)):
            K = 64

            def make():
                x = torch.randn((M, K), generator=gen, device=dev) * 2
                x = torch.where(torch.rand((M, K), generator=gen,
                                           device=dev) < 0.2, 0.0, x)
                n = M if per_row else 1
                a = torch.rand((n,), generator=gen, device=dev) * 0.03 \
                    + 0.005
                return x, a
            sets = [make() for _ in range(n_sets(M * K * 6))]
            x, a = sets[0]
            got = qk.sparq_quant_cuda(x, a, **kw)
            want = qk.ref_sparq_quant(x, a[:, None] if per_row
                                      else a.reshape(()), **kw)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("codes", "meta")):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"K4 {codec_name} {case}: {what} not bit-exact "
                        f"({int((g != w).sum())} of {g.numel()} differ)")
            ms = bench(lambda x_, a_: qk.sparq_quant_cuda(x_, a_, **kw),
                       sets)
            plain_ms = bench(lambda x_, a_: qk.ref_sparq_quant(
                x_, a_[:, None] if per_row else a_.reshape(()), **kw),
                sets, iters=5, warmup=1)
            nbytes = M * K * 4 + a.numel() * 4 + 2 * M * K
            flops = M * K                  # one f32 division per value
            bound = max(nbytes / H100_BYTES_S,
                        flops / H100_F32_FLOPS_S) * 1e3
            rows.append(dict(codec=codec_name, case=case, M=M, K=K,
                             per_row=per_row, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, exact=True))
            log(f"K4 sparq_quant {codec_name} {case:12s} M={M:5d} K={K}"
                f"{' per-row' if per_row else ''}: bit-exact, {ms:.4f} ms "
                f"(plain {plain_ms:.3f} ms, bound {bound:.5f} ms)")
    rep = next(r for r in rows if r["codec"] == "5opt"
               and r["case"] == "scan prefill")
    results["sparq_quant"] = dict(
        max_abs_err=0.0, ms=rep["ms"], plain_ms=rep["plain_ms"],
        bound_ms=rep["bound_ms"], bound_by="bytes", library_ms=None,
        shape="5opt scan prefill M=8192 K=64 (one scale)", rows=rows)


def check_k6(dev, results):
    """K6 at the read-back shape of the scan cache (8 x 296 slots x 4 KV
    heads, hd 64), every int8 byte in store and meta: bit-exact."""
    from repro_torch.kernels import sparq_dequant as dq
    gen = torch.Generator(device=dev).manual_seed(6)
    M, K = 8 * 296 * 4, 64

    def make():
        return tuple(torch.randint(-128, 128, (M, K), generator=gen,
                                   device=dev, dtype=torch.int8)
                     for _ in range(2))
    sets = [make() for _ in range(n_sets(3 * M * K))]
    store, meta = sets[0]
    got = dq.sparq_dequant_cuda(store, meta)
    want = dq.ref_sparq_dequant(store, meta)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K6 dequant: not bit-exact "
                             f"({int((got != want).sum())} differ)")
    # every (store, meta) byte pair on both lane parities
    b = torch.arange(-128, 128, dtype=torch.int16, device=dev)
    st = b.repeat_interleave(256).to(torch.int8)
    mt = b.repeat(256).to(torch.int8)
    st = torch.cat([st, st.roll(1)]).reshape(-1, 128)
    mt = torch.cat([mt, mt.roll(1)]).reshape(-1, 128)
    if not torch.equal(dq.sparq_dequant_cuda(st, mt),
                       dq.ref_sparq_dequant(st, mt)):
        raise AssertionError("K6 dequant: not bit-exact on the 256 x 256 "
                             "byte grid")
    ms = bench(dq.sparq_dequant_cuda, sets)
    plain_ms = bench(dq.ref_sparq_dequant, sets, iters=5, warmup=1)
    bound = 3 * M * K / H100_BYTES_S * 1e3
    results["sparq_dequant"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", library_ms=None,
        shape=f"M={M} K={K} (8 x 296 slots x 4 KV heads)")
    log(f"K6 sparq_dequant M={M} K={K}: bit-exact (and on all 256 x 256 "
        f"byte pairs), {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
        f"{bound:.5f} ms)")


def k5_case(gen, dev, G=8, hd=64, misalign=False, B=8, Tk=296, KV=4,
            cur=286):
    """K5's inputs at the scan decode's shape, random from `gen`: linear
    kpos, cur 286 (a ragged last tile of bk 128)."""
    kd, km = _pools(gen, dev, B, Tk, KV, hd, misalign)
    vd, vm = _pools(gen, dev, B, Tk, KV, hd, misalign)
    q = torch.randn((B, KV, G, hd), generator=gen, device=dev)
    ks = torch.rand((1,), generator=gen, device=dev) * 0.02 + 0.005
    vs = torch.rand((1,), generator=gen, device=dev) * 0.02 + 0.005
    kpos = torch.arange(Tk, dtype=torch.int32, device=dev)[None].expand(
        B, Tk).contiguous()
    return (q, kd, km, ks, vd, vm, vs, kpos,
            torch.tensor([cur], dtype=torch.int32, device=dev))


def check_k5(dev, results):
    """K5 at the scan decode's shapes (q 8 x 4 x 8 x 64, planes 8 x 296 x
    4 x 64, bk 128: a ragged last tile) and at DECODE_SHAPES, without and
    with a window (rotated ring kpos with empty slots), held by `hold` to
    its plain version and to decode_f64_reference. With bk = 16, equal to K2
    on the same bytes laid out as pages, at a cur that ends inside a split
    and one that ends on a split boundary, without and with a window."""
    import torch.nn.functional as F
    from repro_torch.kernels import sparq_decode_attn as dec
    gen = torch.Generator(device=dev).manual_seed(5)
    B, Tk, KV, G, hd, bk, cur = 8, 296, 4, 8, 64, 128, 286
    i32 = torch.int32
    sets = [k5_case(gen, dev) for _ in range(n_sets(4 * B * Tk * KV * hd))]
    args = sets[0]
    # ring-style slots: rotated positions, a run of empty (-1) slots
    ring = ((torch.arange(Tk, device=dev) + 57) % Tk + 40).to(i32)
    ring[100:130] = -1
    ring = ring[None].expand(B, Tk).contiguous()
    errs = {}
    for name, a in [("timed", args)] + [(n, k5_case(gen, dev, *shape))
                                        for n, shape in DECODE_SHAPES.items()]:
        for window, kpos in ((0, a[7]), (K2_WINDOW, ring)):
            case = a[:7] + (kpos, a[8])
            what = f"{name}, window {window}{', ring' if window else ''}"
            got = dec.sparq_decode_attn_cuda(*case, window=window, bk=bk)
            want = dec.ref_sparq_decode_attn(*case, window=window, bk=bk)
            exact = decode_f64_reference(case[0], *contig_keys(
                *case[1:], window=window))
            errs[what] = hold(f"K5 {what}", got, want, exact,
                              1e-4 if name == "timed" else PLAIN_TOL)
    _log_decode("K5", errs)
    err = max(e["plain"] for k, e in errs.items() if k.startswith("timed"))
    # bk = page size: K2 over the same bytes scattered into a page pool
    ps = 16
    NB = math.ceil(Tk / ps)
    q, kd, km, ks, vd, vm, vs, kpos, c = args
    P = B * NB
    perm = torch.randperm(P, generator=gen, device=dev).to(i32)
    bt = perm.reshape(B, NB)

    def paged(plane):
        pad = torch.zeros((B, NB * ps - Tk, KV, hd), dtype=plane.dtype,
                          device=dev)
        pool = torch.empty((P, ps, KV, hd), dtype=plane.dtype, device=dev)
        pool[bt.reshape(-1).long()] = torch.cat([plane, pad], 1).reshape(
            P, ps, KV, hd)
        return pool
    pk, pkm, pv, pvm = map(paged, (kd, km, vd, vm))
    diffs = {}
    # cur 286 ends inside a split, 255 on a split boundary (256 keys)
    for c_ in (cur, 255):
        for window in (0, K2_WINDOW):
            cc = torch.tensor([c_], dtype=i32, device=dev)
            k5 = dec.sparq_decode_attn_cuda(*args[:8], cc, window=window,
                                            bk=ps)
            k2 = dec.sparq_paged_decode_attn_cuda(
                q, pk, pkm, ks.expand(B).contiguous(), pv, pvm,
                vs.expand(B).contiguous(), bt, cc.expand(B).contiguous(),
                window=window)
            torch.cuda.synchronize()
            diffs[f"cur {c_}, window {window}"] = d = float(
                (k5 - k2).abs().max())
            if d != 0.0:
                raise AssertionError(
                    f"K5 (bk={ps}) vs K2 on the same bytes, cur {c_}, "
                    f"window {window}: max abs difference {d}, expected "
                    f"0.0")
    diff_k2 = max(diffs.values())
    geo = dec.split_geometry(Tk, bk)
    ms = bench(lambda *a: dec.sparq_decode_attn_cuda(*a, bk=bk), sets)
    plain_ms = bench(lambda *a: dec.ref_sparq_decode_attn(*a, bk=bk), sets,
                     iters=5, warmup=1)
    # library yardstick: SDPA over the dequantized K/V (decode excluded)
    from repro_torch.kernels.ref import _meta_decode32
    n = cur + 1
    kk = _meta_decode32(kd[:, :n], km[:, :n], ks).transpose(1, 2)
    vv = _meta_decode32(vd[:, :n], vm[:, :n], vs).transpose(1, 2)
    kk, vv = kk.repeat_interleave(G, 1), vv.repeat_interleave(G, 1)
    qh = q.reshape(B, KV * G, 1, hd)
    lib_ms = bench(lambda: F.scaled_dot_product_attention(qh, kk, vv),
                   [()])
    tokens = B * n
    nbytes = (B * KV * G * hd * 4 * 2 + tokens * KV * hd * 4 + B * Tk * 4
              + 12)
    flops = 4 * tokens * KV * G * hd
    bound = max(nbytes / H100_BYTES_S, flops / H100_F32_FLOPS_S) * 1e3
    results["sparq_decode_attn"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound, bound_by="bytes" if nbytes / H100_BYTES_S
        >= flops / H100_F32_FLOPS_S else "operations", vs_k2=diffs,
        errors=errs, grid=[B, KV, geo.n_splits],
        shape=f"B={B} Tk={Tk} KV={KV} G={G} hd={hd} bk={bk} cur={cur}")
    log(f"K5 sparq_decode_attn: max abs err {err:.2e}, vs K2 (bk={ps}) "
        f"{diff_k2} at {list(diffs)}, {ms:.4f} ms (plain {plain_ms:.3f} "
        f"ms, SDPA {lib_ms:.4f} ms, bound {bound:.5f} ms, grid {B}x{KV}x"
        f"{geo.n_splits})")


# ----------------------------------------------------------------------
# phase: the main path end to end, full width
# ----------------------------------------------------------------------

def _full_width(dev):
    """tinyllama-1.1b at full width and depth (22 layers, bf16), random
    weights (seed 0) as int8 codes, one calibration batch, 5opt."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.models.quantize import quantize_params
    cfg = get_config("tinyllama-1.1b")
    model = Model(cfg, device=dev)
    params = model.init_params(seed=0)
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                              global_batch=8, seed=0))
    scales = model.calibrate(params, data.calib_batches(1))
    codec = serve.SPARQ_PRESETS["5opt"]
    return cfg, model, quantize_params(params, codec.weight_bits), scales, \
        codec


def _serve_setup(dev, prefill="chunked"):
    """The serve phase's workload: the full-width model, 8 requests of
    seeded ragged lengths 64-512 and gen 32, and the paged engine (page
    16, chunk 256) sized to hold them, with `prefill` admission."""
    from repro_torch.launch import serve
    from repro_torch.models.common import QuantCtx
    cfg, model, params, scales, codec = _full_width(dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 8)
    gen = 32
    reqs = [serve.Request(rng.integers(0, cfg.vocab_size, int(L)), gen)
            for L in lens]
    ps = 16
    max_seq = -(-(int(lens.max()) + gen - 1) // ps) * ps
    n_pages = sum(math.ceil((int(L) + gen - 1) / ps) for L in lens) + 8
    engine = serve.ContinuousBatchingEngine(
        model, serve.make_cache_config("sparq", codec),
        QuantCtx(mode="quantized", cfg=codec), scales, page_size=ps,
        n_pages=n_pages, max_active=8, max_seq_len=max_seq,
        prefill=prefill, chunk_size=256, chunk_align=8, device=dev)
    return cfg, engine, params, reqs, lens, gen, n_pages


class PlainCodecSpy:
    """Counts calls of the KV codec's plain version while a path runs on
    the card, where every KV write must go through K4 instead."""

    def __enter__(self):
        from repro_torch.kernels import ref, sparq_quant
        self.calls = 0
        self._mods = (ref, sparq_quant)
        self._orig = ref.ref_sparq_quant

        def spy(*a, **k):
            self.calls += 1
            return self._orig(*a, **k)
        for m in self._mods:
            m.ref_sparq_quant = spy
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.ref_sparq_quant = self._orig


def _drive(fn):
    """Run one path with the launch counters set to 0 just before and read
    just after, under the plain-codec spy. Returns (result, counts)."""
    from repro_torch.kernels import build
    with PlainCodecSpy() as spy:
        build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = build.launch_counts()
    if spy.calls:
        raise AssertionError(f"the plain KV codec ran {spy.calls} times on "
                             f"the card")
    return out, counts


def _check_requests(cfg, reqs, out, gen):
    for rid in range(len(reqs)):
        toks = out[rid]
        assert len(toks) == gen, (rid, len(toks))
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), rid


def _paged_full_width(dev, results, prefill):
    t0 = time.perf_counter()
    cfg, engine, params, reqs, lens, gen, n_pages = _serve_setup(dev,
                                                                 prefill)
    L = cfg.n_layers
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    engine.run(params, reqs)                       # warm-up, untimed
    (out, stats), counts = _drive(lambda: engine.run(params, reqs))
    _check_requests(cfg, reqs, out, gen)
    assert stats["free_pages_after"] == n_pages, "pages leaked"
    steps = stats["decode_steps"]
    chunks = stats["prefill_chunks"]
    # sequential: one prefill per request (7 matmuls, 2 K4 per layer)
    prefills = chunks if prefill == "chunked" else len(reqs)
    assert counts["sparq_matmul"] >= 7 * L * (steps + prefills), counts
    assert counts["sparq_paged_decode_attn"] == L * steps, counts
    assert counts["sparq_quant"] == 2 * L * (prefills + steps), counts
    assert counts["sparq_chunked_prefill_attn"] == L * chunks, counts
    assert counts["sparq_decode_attn"] == 0, counts
    assert counts["sparq_dequant"] == 0, counts
    if prefill == "chunked":
        assert chunks > 0, "no prefill chunk ran"
    else:
        assert chunks == 0 and counts["sparq_chunked_prefill_attn"] == 0
    name = "serve" if prefill == "chunked" else "sequential"
    results[name] = dict(
        arch=cfg.name, n_layers=L, dtype=str(cfg.dtype),
        prompt_lens=[int(x) for x in lens], gen=gen, chunk_size=256,
        setup_s=t_setup, launches=counts,
        **{k: v for k, v in stats.items() if not isinstance(v, dict)})
    log(f"{name} {cfg.name} x{L} layers bf16 5opt int8-weights, "
        f"{prefill} prefill: prefill {stats['prefill_s']:.3f} s "
        f"({chunks} chunks) | decode {stats['decode_tok_s']:.1f} tok/s "
        f"({steps} steps) | peak pages {stats['peak_pages_used']}/"
        f"{n_pages} | launches {counts}")
    del params, engine
    torch.cuda.empty_cache()
    return counts


def serve_full_width(dev, results):
    return _paged_full_width(dev, results, "chunked")


def sequential_full_width(dev, results):
    return _paged_full_width(dev, results, "sequential")


def scan_full_width(dev, results):
    """The scan engine at full width: batch 8, prompt 256, gen 32, sparq
    KV (5opt). A first generate is the warm-up; the launch counters are
    reset after it and read after the timed one. Then every layer's K/V
    comes back through CacheStore.kv() (K6), held against the plain
    dequant of the same bytes."""
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.kernels.sparq_dequant import ref_sparq_dequant
    from repro_torch.launch import serve
    from repro_torch.models.common import QuantCtx
    t0 = time.perf_counter()
    cfg, model, params, scales, codec = _full_width(dev)
    B, T, gen = 8, 256, 32
    L = cfg.n_layers
    batch = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=T,
                               global_batch=B, seed=1)).global_batch(0)
    cc = serve.make_cache_config("sparq", codec)
    engine = serve.DecodeEngine(model, cc, QuantCtx(mode="quantized",
                                                    cfg=codec), scales)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    engine.generate(params, batch, gen, warmup=False)     # warm-up
    (toks, stats), counts = _drive(
        lambda: engine.generate(params, batch, gen, warmup=False))
    assert toks.shape == (B, gen), toks.shape
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    want = {"sparq_matmul": 7 * L * gen, "sparq_quant": 2 * L * gen,
            "sparq_decode_attn": L * (gen - 1), "sparq_paged_decode_attn": 0,
            "sparq_chunked_prefill_attn": 0, "sparq_dequant": 0}
    if counts != want:
        raise AssertionError(f"scan launches {counts}, expected {want}")
    caches = engine.last_caches
    planes, k6 = _drive(lambda: [st.kv() for st in caches])
    if k6["sparq_dequant"] != 2 * L or sum(k6.values()) != 2 * L:
        raise AssertionError(f"read-back launches {k6}, expected "
                             f"{2 * L} of sparq_dequant only")
    for st, (k, v) in zip(caches, planes):
        for got, ct in ((k, st.k), (v, st.v)):
            plain = ref_sparq_dequant(ct.data, ct.meta).to(torch.float32) \
                * ct.scale
            if not torch.equal(got, plain):
                raise AssertionError("K6 read-back differs from the plain "
                                     "dequant of the same bytes")
        assert int(st.pos) == T + gen - 1
    results["scan"] = dict(
        arch=cfg.name, n_layers=L, dtype=str(cfg.dtype), batch=B,
        prompt_len=T, gen=gen, setup_s=t_setup, launches=counts,
        readback_launches=k6, **stats)
    log(f"scan {cfg.name} x{L} layers bf16 5opt int8-weights sparq KV, "
        f"B={B} prompt={T} gen={gen}: prefill {stats['prefill_s']:.3f} s | "
        f"decode {stats['decode_tok_s']:.1f} tok/s | cache "
        f"{stats['cache_bytes_per_value']:.4f} B/value data (+"
        f"{stats['cache_ctrl_bytes_per_value']:.4f} ctrl), "
        f"{stats['cache_total_bytes'] / 1e6:.2f} MB modeled | launches "
        f"{counts} | read-back {k6}")
    del params, engine, caches, planes
    torch.cuda.empty_cache()
    return {**counts, "sparq_dequant": k6["sparq_dequant"]}


# the North-star command as a user runs it, on the card: the reduced
# tinyllama (hd 16, G 4) through the paged chunked engine
CLI_ARGS = ["--arch", "tinyllama-1.1b", "--reduced", "--engine", "paged",
            "--prefill", "chunked", "--kv-cache", "sparq", "--sparq", "5opt",
            "--device", "cuda"]
# full-width tinyllama through the same CLI at 16-token query tiles (128
# query rows a tile: two row blocks) and pages of 128 keys (two key tiles
# a page)
WIDE_ARGS = ["--arch", "tinyllama-1.1b", "--engine", "paged", "--prefill",
             "chunked", "--kv-cache", "sparq", "--sparq", "5opt",
             "--chunk-align", "16", "--page-size", "128", "--device", "cuda"]


def _cli_config(argv):
    """The model config `serve.main(argv)` builds."""
    from repro_torch.configs import get_config, get_reduced_config
    arch = argv[argv.index("--arch") + 1]
    return (get_reduced_config if "--reduced" in argv else get_config)(arch)


def cli_k3_shape(argv):
    """K3's shape on the path `serve.main(argv)` drives, as K3_SHAPES
    writes it: (KV, G, hd, ps, bq, misaligned, C), with the CLI's defaults
    (--page-size 16, --chunk-align 8, --chunk-size 32) where argv gives
    none."""
    cfg = _cli_config(argv)
    arg = dict(zip(argv[::2], argv[1::2]))
    return (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
            int(arg.get("--page-size", 16)), int(arg.get("--chunk-align", 8)),
            False, int(arg.get("--chunk-size", 32)))


def _cli(dev, results, name, argv):
    """`python -m repro_torch.launch.serve` with argv, through its `main`
    (a warm-up run, then the timed one): every request returns `gen`
    tokens in [0, vocab); K3 runs at every chunk's layer (the tensor-core
    kernel, at the instantiation k3_traits names, at K3_SHAPES[name], which
    check_k3 holds against f64 and the plain version), K2 every decode
    step, K4 every KV write."""
    from repro_torch.kernels import sparq_prefill_attn as pre
    from repro_torch.launch import serve
    cfg = _cli_config(argv)
    L = cfg.n_layers
    KV, G, hd, ps, bq, _, _ = shape = cli_k3_shape(argv)
    if K3_SHAPES[name][0] != shape:
        raise AssertionError(f"{name}: K3 runs at {shape}, but check_k3 "
                             f"holds {K3_SHAPES[name][0]}")
    tr = pre.k3_traits(hd, G, bq, ps)
    stats, counts = _drive(lambda: serve.main(argv))
    toks = stats["tokens"]
    gen = 32                                  # the CLI's --gen default
    _check_requests(cfg, range(len(toks)), toks, gen)
    chunks, steps = stats["prefill_chunks"], stats["decode_steps"]
    want = {"sparq_chunked_prefill_attn": 2 * L * chunks,
            "sparq_paged_decode_attn": 2 * L * steps,
            "sparq_quant": 2 * 2 * L * (chunks + steps),
            "sparq_decode_attn": 0, "sparq_dequant": 0}
    got = {k: counts[k] for k in want}
    if got != want or counts["sparq_matmul"] == 0 or chunks == 0:
        raise AssertionError(f"{name} launches {counts} (two runs of "
                             f"{chunks} chunks and {steps} steps), expected "
                             f"{want} and K1 > 0")
    results[name] = dict(
        argv=argv, arch=cfg.name, n_layers=L, head_dim=cfg.head_dim, G=G,
        k3_traits=tr._asdict(), launches=counts,
        **{k: v for k, v in stats.items() if not isinstance(v, dict)})
    log(f"{name} {' '.join(argv)}: {len(toks)} requests x {gen} tokens | "
        f"prefill {stats['prefill_s']:.3f} s ({chunks} chunks) | decode "
        f"{stats['decode_tok_s']:.1f} tok/s | K3 {tr} | launches (warm-up + "
        f"timed run) {counts}")
    return counts


def cli_reduced(dev, results):
    return _cli(dev, results, "cli", CLI_ARGS)


def cli_wide(dev, results):
    counts = _cli(dev, results, "wide", WIDE_ARGS)
    torch.cuda.empty_cache()
    return counts


# Device-time groups of the profile phase: the seven kernels by their
# __global__ names in csrc/ (K1's pre-pass and GEMM together), everything
# else (PyTorch's own kernels and copies) as "other".
KERNEL_GROUPS = (("sparq_matmul", "sparq_matmul_"),
                 ("sparq_paged_decode_attn", "paged_decode_kernel"),
                 ("sparq_chunked_prefill_attn", "chunked_prefill_kernel"),
                 ("sparq_quant", "sparq_quant_kernel"),
                 ("sparq_decode_attn", "decode_attn_kernel"),
                 ("sparq_dequant", "sparq_dequant_kernel"))


def profile_serve(dev, results):
    """The serve phase's workload once more under torch.profiler (warm):
    device time by kernel, grouped into the SPARQ kernels and the rest, and
    the device's idle share of the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _, engine, params, reqs, _, _, _ = _serve_setup(dev)
    engine.run(params, reqs)                       # warm-up, unprofiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = engine.run(params, reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (e - s) / 1e3
    busy_ms, end = 0.0, -math.inf
    for s, e in sorted(spans):                     # union of device spans
        if e > end:
            busy_ms += (e - max(s, end)) / 1e3
            end = e
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, ms in by_name.items():
        g = next((g for g, sym in KERNEL_GROUPS if sym in name), "other")
        groups[g] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    results["profile"] = dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms, device_ms_by_group=groups,
        top_kernels_ms=top, decode_steps=stats["decode_steps"],
        prefill_chunks=stats["prefill_chunks"],
        decode_tok_s=stats["decode_tok_s"], prefill_s=stats["prefill_s"])
    log(f"profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}) | device ms by group "
        + ", ".join(f"{g} {ms:.1f}" for g, ms in groups.items()))
    for name, ms in top:
        log(f"profile:   {ms:9.2f} ms  {name[:100]}")
    if not spans:
        log("profile: the profiler recorded no device events")


# ----------------------------------------------------------------------
# phase: kernels vs plain versions, whole model
# ----------------------------------------------------------------------

def parity_two_layers(dev, results):
    """2-layer full-width f32 models with the same weights on the card and
    on the CPU: the paged chunked engine and the scan engine each give
    equal greedy tokens on both; on the card, the paged sequential engine
    gives the scan engine's tokens (each request alone, attn_bk = page
    size, so K5's tiles are K2's pages). The paged chunked engine also
    runs at --chunk-align 16 --page-size 128 (K3's row blocks and pages
    larger than its key tile), card against CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.launch import serve
    from repro_torch.models.common import QuantCtx
    from repro_torch.models.model import Model
    from repro_torch.models.quantize import quantize_params
    cfg = get_config("tinyllama-1.1b").replace(n_layers=2,
                                               dtype=torch.float32)
    codec = serve.SPARQ_PRESETS["5opt"]
    cc = serve.make_cache_config("sparq", codec)
    ctx = QuantCtx(mode="quantized", cfg=codec)
    gpu = Model(cfg, device=dev)
    params = quantize_params(gpu.init_params(seed=1), codec.weight_bits)
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                              global_batch=4, seed=1))
    scales = gpu.calibrate(params, data.calib_batches(1))
    rng = np.random.default_rng(1)
    reqs = [serve.Request(rng.integers(0, cfg.vocab_size, L), 8)
            for L in (40, 100, 20, 70)]          # 100, 70 > chunk_seg 64
    scan_batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 48))}
    ps = 16
    kw = dict(page_size=ps, n_pages=40, max_active=3, max_seq_len=112,
              chunk_size=64, chunk_align=8)
    kw_wide = dict(page_size=128, n_pages=8, max_active=3, max_seq_len=128,
                   chunk_size=64, chunk_align=16)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    def same(a, b, what):
        if not np.array_equal(a, b):
            raise AssertionError(f"parity, {what}: tokens differ: "
                                 f"{np.asarray(a).tolist()} vs "
                                 f"{np.asarray(b).tolist()}")

    out, wide, scan = {}, {}, {}
    for name, model, p, sc in (
            ("cuda", gpu, params, scales),
            ("cpu", Model(cfg, device="cpu"), to_cpu(params),
             to_cpu(scales))):
        eng = serve.ContinuousBatchingEngine(
            model, cc, ctx, sc, device=model.device, prefill="chunked", **kw)
        out[name], _ = eng.run(p, reqs)
        eng = serve.ContinuousBatchingEngine(
            model, cc, ctx, sc, device=model.device, prefill="chunked",
            **kw_wide)
        wide[name], _ = eng.run(p, reqs)
        scan[name], _ = serve.DecodeEngine(model, cc, ctx, sc).generate(
            p, scan_batch, 8, warmup=False)
    for rid in out["cpu"]:
        same(out["cuda"][rid], out["cpu"][rid],
             f"paged chunked, request {rid}, kernels vs plain")
        same(wide["cuda"][rid], wide["cpu"][rid],
             f"paged chunked at chunk-align 16 and page size 128, request "
             f"{rid}, kernels vs plain")
    same(scan["cuda"], scan["cpu"], "scan engine, kernels vs plain")
    seq, _ = serve.ContinuousBatchingEngine(
        gpu, cc, ctx, scales, device=dev, prefill="sequential",
        **kw).run(params, reqs)
    alone = serve.DecodeEngine(gpu, dataclasses.replace(cc, attn_bk=ps),
                               ctx, scales)
    for rid, r in enumerate(reqs):
        toks, _ = alone.generate(params, {"tokens": r.tokens[None]}, r.gen,
                                 warmup=False)
        same(seq[rid], toks[0], f"request {rid}, paged sequential vs scan "
                                f"(attn_bk = {ps}) on the card")
    results["parity"] = {str(r): out["cuda"][r].tolist() for r in out["cpu"]}
    results["parity_wide"] = {str(r): wide["cuda"][r].tolist()
                              for r in wide["cpu"]}
    results["parity_scan"] = scan["cuda"].tolist()
    log(f"parity 2-layer full-width f32: kernels == plain versions on "
        f"{len(reqs)} paged requests "
        f"({sum(len(t) for t in out['cpu'].values())} tokens; again at "
        f"chunk-align 16 and page size 128) and a scan "
        f"batch of {scan['cpu'].shape[0]}; paged sequential == scan "
        f"(attn_bk {ps}) on the card for all {len(reqs)} requests")


# opcodes that must (True) or must not (False) appear in a kernel
# library's SASS: K1 runs on the int8 tensor cores and dp4a is gone; K3
# runs on the f64 tensor cores
SASS_CHECKS = {"sparq_matmul.cu": {"IMMA": True, "IDP4A": False},
               "sparq_chunked_prefill_attn.cu": {"DMMA": True}}


def sass_counts(source, opcodes):
    """Count the SASS lines of a built kernel library that hold each
    opcode (cuobjdump -sass)."""
    from repro_torch.kernels import build
    cuobjdump = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build._lib_path(source))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    return {op: sum(op in line for line in sass.splitlines())
            for op in opcodes}


def check_sass():
    counts = {}
    for source, want in SASS_CHECKS.items():
        got = sass_counts(source, want)
        log(f"SASS {source}: " + ", ".join(f"{n} {op}"
                                           for op, n in got.items()))
        if any((n > 0) != want[op] for op, n in got.items()):
            raise AssertionError(f"SASS of {source}: expected {want} "
                                 f"(True: present), got {got}")
        counts[source] = got
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="build,kernels,serve,scan,sequential,cli,wide,"
                            "parity")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops  # noqa: F401  (registers)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = smi_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")
    results = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    results["build_s"] = time.perf_counter() - t0
    for src, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                log(f"ptxas {src}: {line.strip()}")
    log(f"build: {len(logs)} kernel libraries in {results['build_s']:.1f} s")
    results["sass"] = check_sass()
    if "kernels" in phases:
        for check in (check_k1, check_k2, check_k3, check_k4, check_k5,
                      check_k6):
            check(dev, results)
    by_path = {}
    paths = (("serve", serve_full_width), ("scan", scan_full_width),
             ("sequential", sequential_full_width), ("cli", cli_reduced),
             ("wide", cli_wide))
    for name, run in paths:
        if name in phases:
            by_path[name] = run(dev, results)
    counts = {k: sum(c.get(k, 0) for c in by_path.values())
              for k in build.KERNELS}
    if len(by_path) == len(paths):
        idle = [k for k, n in counts.items() if n == 0]
        if idle:
            raise AssertionError(f"kernels never launched on any path: "
                                 f"{idle}")
    results["launches_by_path"] = by_path
    if "parity" in phases:
        parity_two_layers(dev, results)
    if "profile" in phases:
        profile_serve(dev, results)
    results["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    kernels = []
    for name, k in build.KERNELS.items():
        r = results.get(name, {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": counts.get(name, 0),
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"), "shape": r.get("shape")})
    log(f"total {results['total_s']:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
