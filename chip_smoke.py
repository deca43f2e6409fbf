"""Smoke run of the PyTorch/CUDA port on one GPU (the quickest proof that
the port still starts on the card).

    python3 chip_smoke.py            # every phase, as the acceptance run
    python3 chip_smoke.py --phases build,kernels

Phases (each one that fails makes the script exit non-zero):
  build    nvcc-build the three hand-written kernels from src/repro_torch/csrc
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes the main path gives it: K1 sparq_matmul bit-exact, K2
           paged decode and K3 chunked prefill within 1e-4 absolute (f32
           sums in another order), without and with a sliding window;
           times of the kernel, the plain version
           and one PyTorch library call, and each kernel's least possible
           time from its bytes and operations
  serve    tinyllama-1.1b at full width (22 layers, bf16, 5opt, int8
           weights, one calibration batch) serves 8 ragged requests through
           the paged chunked-prefill engine; launch counters reset just
           before and read just after prove every kernel ran
  parity   a 2-layer full-width f32 model serves 4 requests on the card
           (kernels) and on the CPU (plain versions): equal greedy tokens
  profile  (not run by default) the serve workload once more under
           torch.profiler: device time by kernel and the device's idle
           share of the run

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
L2_BYTES = 50 * 2 ** 20


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def bench(fn, arg_sets, iters=50, warmup=5):
    """Mean ms per call on the card (CUDA events), cycling through input
    sets large enough together to defeat the 50 MB L2 cache."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
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
            for M in (8, 256):
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
                want = mm.ref_sparq_matmul(x, w, a, c, **kw)
                torch.cuda.synchronize()
                exact = torch.equal(got, want)
                err = float((got - want).abs().max())
                worst = max(worst, err)
                if not exact:
                    raise AssertionError(
                        f"K1 {codec_name} {proj} M={M}: not bit-exact "
                        f"(max abs err {err})")
                ms = bench(lambda *s: mm.sparq_matmul_cuda(*s, **kw), sets)
                plain_ms = bench(lambda *s: mm.ref_sparq_matmul(*s, **kw),
                                 sets, iters=5, warmup=1)
                lib_ms = None
                if M > 16:   # torch._int_mm takes M > 16
                    qs = [(quantize_codes(s[0], s[2], True, 127)
                           .to(torch.int8), s[1], s[2], s[3]) for s in sets]
                    lib_ms = bench(lambda xq, w_, a_, c_: (torch._int_mm(
                        xq, w_).float() * a_) * c_, qs)
                nbytes = M * K * 2 + K * N + N * 4 + M * N * 4
                bound = max(nbytes / H100_BYTES_S,
                            2 * M * N * K / H100_INT8_OPS_S) * 1e3
                row = dict(codec=codec_name, proj=proj, M=M, K=K, N=N,
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound,
                           bound_by="bytes" if nbytes / H100_BYTES_S
                           >= 2 * M * N * K / H100_INT8_OPS_S
                           else "operations", exact=exact)
                rows.append(row)
                log(f"K1 sparq_matmul {codec_name} {proj:7s} M={M:3d} "
                    f"K={K} N={N}: bit-exact, {ms:.4f} ms (plain "
                    f"{plain_ms:.3f} ms, _int_mm "
                    f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} ms, "
                    f"bound {bound:.4f} ms)")
    # the JSON line's representative: one prefill-chunk gate/up projection
    # (torch._int_mm, the yardstick, needs M > 16); every shape is in rows
    rep = next(r for r in rows if r["codec"] == "5opt"
               and r["proj"] == "gate/up" and r["M"] == 256)
    results["sparq_matmul"] = dict(
        max_abs_err=worst, ms=rep["ms"], plain_ms=rep["plain_ms"],
        bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
        library_ms=rep["library_ms"],
        shape="5opt gate/up M=256 K=2048 N=5632", rows=rows)


def _pools(gen, dev, P, ps, KV, hd):
    data = torch.randint(-15, 16, (P, ps, KV, hd), generator=gen,
                         device=dev, dtype=torch.int8)
    meta = torch.randint(0, 128, (P, ps, KV, hd), generator=gen,
                         device=dev, dtype=torch.int8)
    return data, meta


def _dequant_pages(data, meta, pages, scale):
    from repro_torch.kernels.ref import _meta_decode32
    return _meta_decode32(data[pages], meta[pages], scale)


# window > 0 cases: K2's skips the first blocks of long slots and masks
# inside a page; K3's cuts into slot 0's history pages and its chunk keys
K2_WINDOW, K3_WINDOW = 100, 64


def check_k2(dev, results):
    import torch.nn.functional as F
    from repro_torch.kernels import sparq_decode_attn as dec
    gen = torch.Generator(device=dev).manual_seed(2)
    S, KV, G, hd, ps = 8, 4, 8, 64, 16
    curs = [599, 433, 17, 300, -1, 511, 64, 250]     # slot 4 inactive
    NB = 40
    P = sum(c // ps + 1 for c in curs if c >= 0) + 8

    def make():
        kd, km = _pools(gen, dev, P + 1, ps, KV, hd)
        vd, vm = _pools(gen, dev, P + 1, ps, KV, hd)
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
    sets = [make() for _ in range(n_sets(4 * (P + 1) * ps * KV * hd))]
    args = sets[0]
    got = dec.sparq_paged_decode_attn_cuda(*args)
    want = dec.ref_sparq_paged_decode_attn(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert torch.all(got[4] == 0), "K2: inactive slot is not exactly zero"
    assert torch.isfinite(got).all()
    if err > 1e-4:
        raise AssertionError(f"K2 paged decode: max abs err {err} > 1e-4")
    # sliding window (the kernel skips whole blocks below cur - window)
    got_w = dec.sparq_paged_decode_attn_cuda(*args, window=K2_WINDOW)
    want_w = dec.ref_sparq_paged_decode_attn(*args, window=K2_WINDOW)
    torch.cuda.synchronize()
    err_w = float((got_w - want_w).abs().max())
    assert torch.all(got_w[4] == 0) and torch.isfinite(got_w).all()
    if err_w > 1e-4:
        raise AssertionError(
            f"K2 paged decode, window {K2_WINDOW}: max abs err {err_w} "
            f"> 1e-4")
    err = max(err, err_w)
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
        >= flops / H100_F32_FLOPS_S else "operations",
        shape=f"S={S} KV={KV} G={G} hd={hd} ps={ps} cur={curs}")
    log(f"K2 sparq_paged_decode_attn: max abs err {err:.2e}, {ms:.4f} ms "
        f"(plain {plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound "
        f"{bound:.5f} ms, {tokens} cached tokens)")


def check_k3(dev, results):
    import torch.nn.functional as F
    from repro_torch.kernels import sparq_prefill_attn as pre
    gen = torch.Generator(device=dev).manual_seed(3)
    S, KV, G, hd, ps, C, bq = 8, 4, 8, 64, 16, 256, 8
    NB = 34
    # slot 0: second segment of a 400-token prompt (positions 256..399,
    # hist 256: 16 packed pages of history); slot 1: a fresh 96-token
    # prompt; 16 rows of padding
    runs = [(0, 256, 144, 256), (1, 0, 96, 0)]
    P = 40

    def make():
        kd, km = _pools(gen, dev, P + 1, ps, KV, hd)
        vd, vm = _pools(gen, dev, P + 1, ps, KV, hd)
        bt = torch.full((S, NB), -1, dtype=torch.int32, device=dev)
        bt[0, :25] = torch.randperm(P, generator=gen, device=dev)[:25] \
            .to(torch.int32)
        bt[1, :6] = torch.arange(30, 36, dtype=torch.int32, device=dev)
        seq_id = torch.full((C,), -1, dtype=torch.int32, device=dev)
        pos = torch.zeros((C,), dtype=torch.int32, device=dev)
        hist = torch.zeros((C,), dtype=torch.int32, device=dev)
        tile_seq = torch.full((C // bq,), -1, dtype=torch.int32, device=dev)
        at = 0
        for slot, start, n, h in runs:
            seq_id[at:at + n] = slot
            pos[at:at + n] = torch.arange(start, start + n, device=dev)
            hist[at:at + n] = h
            tile_seq[at // bq:(at + n) // bq] = slot
            at += n
        q = torch.randn((C, KV, G, hd), generator=gen, device=dev)
        kc = torch.randn((C, KV, hd), generator=gen, device=dev)
        vc = torch.randn((C, KV, hd), generator=gen, device=dev)
        ks = torch.rand((S,), generator=gen, device=dev) * 0.02 + 0.005
        vs = torch.rand((S,), generator=gen, device=dev) * 0.02 + 0.005
        return (q, kc, vc, kd, km, ks, vd, vm, vs, bt, seq_id, pos, hist,
                tile_seq)
    sets = [make() for _ in range(n_sets(4 * (P + 1) * ps * KV * hd))]
    args = sets[0]
    got = pre.sparq_chunked_prefill_attn_cuda(*args)
    want = pre.ref_sparq_chunked_prefill_attn(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert torch.all(got[args[10] < 0] == 0), \
        "K3: padding rows are not exactly zero"
    assert torch.isfinite(got).all()
    if err > 1e-4:
        raise AssertionError(f"K3 chunked prefill: max abs err {err} > 1e-4")
    # sliding window, masking in both the page and the chunk stage
    got_w = pre.sparq_chunked_prefill_attn_cuda(*args, window=K3_WINDOW)
    want_w = pre.ref_sparq_chunked_prefill_attn(*args, window=K3_WINDOW)
    torch.cuda.synchronize()
    err_w = float((got_w - want_w).abs().max())
    assert torch.all(got_w[args[10] < 0] == 0) and torch.isfinite(got_w).all()
    if err_w > 1e-4:
        raise AssertionError(
            f"K3 chunked prefill, window {K3_WINDOW}: max abs err {err_w} "
            f"> 1e-4")
    err = max(err, err_w)
    ms = bench(pre.sparq_chunked_prefill_attn_cuda, sets)
    plain_ms = bench(pre.ref_sparq_chunked_prefill_attn, sets, iters=5,
                     warmup=1)
    # library yardstick: one SDPA call over [dequantized history of slot 0
    # ; the chunk's float K/V] with the same mask (decode excluded)
    q, kc, vc, kd, km, ks, vd, vm, vs, bt, sid, pos, hist, _ = args
    Th = 256
    pages = bt[0, :Th // ps].long()
    kh = _dequant_pages(kd, km, pages, ks[0]).reshape(Th, KV, hd)
    vh = _dequant_pages(vd, vm, pages, vs[0]).reshape(Th, KV, hd)
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
    bound = max(nbytes / H100_BYTES_S, flops / H100_F32_FLOPS_S) * 1e3
    results["sparq_chunked_prefill_attn"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound, bound_by="bytes" if nbytes / H100_BYTES_S
        >= flops / H100_F32_FLOPS_S else "operations",
        shape=f"C={C} bq={bq} KV={KV} G={G} hd={hd} ps={ps} "
              f"runs(slot,start,n,hist)={runs}")
    log(f"K3 sparq_chunked_prefill_attn: max abs err {err:.2e}, "
        f"{ms:.4f} ms (plain {plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, "
        f"bound {bound:.5f} ms)")


# ----------------------------------------------------------------------
# phase: the main path end to end, full width
# ----------------------------------------------------------------------

def _serve_setup(dev):
    """The serve phase's workload: tinyllama-1.1b at full width and depth
    (22 layers), random weights (seed 0) as int8 codes, one calibration
    batch, 8 requests of seeded ragged lengths 64-512 and gen 32, and the
    paged chunked-prefill engine (page 16, chunk 256) sized to hold them."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.launch import serve
    from repro_torch.models.common import QuantCtx
    from repro_torch.models.model import Model
    from repro_torch.models.quantize import quantize_params
    cfg = get_config("tinyllama-1.1b")
    model = Model(cfg, device=dev)
    params = model.init_params(seed=0)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 8)
    gen = 32
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                              global_batch=8, seed=0))
    scales = model.calibrate(params, data.calib_batches(1))
    codec = serve.SPARQ_PRESETS["5opt"]
    params = quantize_params(params, codec.weight_bits)
    reqs = [serve.Request(rng.integers(0, cfg.vocab_size, int(L)), gen)
            for L in lens]
    ps = 16
    max_seq = -(-(int(lens.max()) + gen - 1) // ps) * ps
    n_pages = sum(math.ceil((int(L) + gen - 1) / ps) for L in lens) + 8
    engine = serve.ContinuousBatchingEngine(
        model, serve.make_cache_config("sparq", codec),
        QuantCtx(mode="quantized", cfg=codec), scales, page_size=ps,
        n_pages=n_pages, max_active=8, max_seq_len=max_seq,
        prefill="chunked", chunk_size=256, chunk_align=8, device=dev)
    return cfg, engine, params, reqs, lens, gen, n_pages


def serve_full_width(dev, results):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    cfg, engine, params, reqs, lens, gen, n_pages = _serve_setup(dev)
    n_layers = cfg.n_layers
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    engine.run(params, reqs)                       # warm-up, untimed
    build.reset_launch_counts()
    out, stats = engine.run(params, reqs)
    counts = build.launch_counts()
    for rid, r in enumerate(reqs):
        toks = out[rid]
        assert len(toks) == gen, (rid, len(toks))
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), rid
    assert stats["free_pages_after"] == n_pages, "pages leaked"
    for name, n in counts.items():
        assert n > 0, f"kernel {name} never launched on the main path"
    per_step = 7 * n_layers
    assert counts["sparq_matmul"] >= per_step * stats["decode_steps"], \
        counts
    assert counts["sparq_paged_decode_attn"] == \
        n_layers * stats["decode_steps"], counts
    assert counts["sparq_chunked_prefill_attn"] == \
        n_layers * stats["prefill_chunks"], counts
    results["serve"] = dict(
        arch=cfg.name, n_layers=n_layers, dtype=str(cfg.dtype),
        prompt_lens=[int(L) for L in lens], gen=gen, chunk_size=256,
        setup_s=t_setup, launches=counts,
        **{k: v for k, v in stats.items() if not isinstance(v, dict)})
    log(f"serve {cfg.name} x{n_layers} layers bf16 5opt int8-weights: "
        f"prefill {stats['prefill_s']:.3f} s over {stats['prefill_chunks']} "
        f"chunks | decode {stats['decode_tok_s']:.1f} tok/s "
        f"({stats['decode_steps']} steps) | peak pages "
        f"{stats['peak_pages_used']}/{n_pages} | launches {counts}")
    del params, engine
    torch.cuda.empty_cache()
    return counts


# Device-time groups of the profile phase: the three kernels by their
# __global__ names in csrc/, everything else (PyTorch's own kernels and
# copies) as "other".
KERNEL_GROUPS = (("sparq_matmul", "sparq_matmul_kernel"),
                 ("sparq_paged_decode_attn", "paged_decode_kernel"),
                 ("sparq_chunked_prefill_attn", "chunked_prefill_kernel"))


def profile_serve(dev, results):
    """The serve phase's workload once more under torch.profiler (warm):
    device time by kernel, grouped into the three SPARQ kernels and the
    rest, and the device's idle share of the run's wall time."""
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
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.launch import serve
    from repro_torch.models.common import QuantCtx
    from repro_torch.models.model import Model
    from repro_torch.models.quantize import quantize_params
    cfg = get_config("tinyllama-1.1b").replace(n_layers=2,
                                               dtype=torch.float32)
    codec = serve.SPARQ_PRESETS["5opt"]
    gpu = Model(cfg, device=dev)
    params = quantize_params(gpu.init_params(seed=1), codec.weight_bits)
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                              global_batch=4, seed=1))
    scales = gpu.calibrate(params, data.calib_batches(1))
    rng = np.random.default_rng(1)
    reqs = [serve.Request(rng.integers(0, cfg.vocab_size, L), 8)
            for L in (40, 100, 20, 70)]          # 100, 70 > chunk_seg 64
    kw = dict(page_size=16, n_pages=40, max_active=3, max_seq_len=112,
              prefill="chunked", chunk_size=64, chunk_align=8)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    out = {}
    for name, model, p, sc in (
            ("cuda", gpu, params, scales),
            ("cpu", Model(cfg, device="cpu"), to_cpu(params),
             to_cpu(scales))):
        eng = serve.ContinuousBatchingEngine(
            model, serve.make_cache_config("sparq", codec),
            QuantCtx(mode="quantized", cfg=codec), sc,
            device=model.device, **kw)
        out[name], _ = eng.run(p, reqs)
    for rid in out["cpu"]:
        if not np.array_equal(out["cuda"][rid], out["cpu"][rid]):
            raise AssertionError(
                f"parity: request {rid} tokens differ: kernels "
                f"{out['cuda'][rid].tolist()} vs plain "
                f"{out['cpu'][rid].tolist()}")
    results["parity"] = {str(r): out["cuda"][r].tolist() for r in out["cpu"]}
    log(f"parity 2-layer full-width f32: kernels == plain versions on "
        f"{len(reqs)} requests ({sum(len(t) for t in out['cpu'].values())} "
        f"tokens)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,kernels,serve,parity")
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
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")
    log(f"build: {len(logs)} kernel libraries in {results['build_s']:.1f} s")
    if "kernels" in phases:
        check_k1(dev, results)
        check_k2(dev, results)
        check_k3(dev, results)
    counts = {}
    if "serve" in phases:
        counts = serve_full_width(dev, results)
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
