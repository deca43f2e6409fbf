"""Smoke run of the PyTorch/CUDA port on one GPU (the quickest proof that
the port still starts on the card).

    python3 chip_smoke.py            # every phase, as the acceptance run
    python3 chip_smoke.py --phases build,kernels

Phases (each one that fails makes the script exit non-zero):
  build       nvcc-build the six hand-written kernels from
              src/repro_torch/csrc, one nvcc per source, all at once;
              cuobjdump -sass of K1's library must show IMMA (integer
              tensor cores) with S8 x S8 and with U8 x S8 operands and no
              IDP4A, and K3's DMMA (f64 tensor cores)
  kernels     each kernel against its plain PyTorch version on the card, at
              the shapes the main paths give it: K1 sparq_matmul (M = 8,
              256, 445, 2048 on the four projections, 5opt and a8w8, each
              shape run twice: both runs equal and bit-exact; its tile
              plan logged per row; and in its unsigned mode, uint8 x
              int8, for every codec of the paper's Tables 1, 2 and 4 at
              the cnn path's im2col shapes, K 216 / N 24, ragged K and
              split-K, on post-ReLU data with codes above 127; and 5opt
              at granite-20b's and starcoder2-3b's projections, M 8 and
              256, FAMILY_PROJ);
              K4 sparq_quant bit-exact in its rows
              mode and in every KV-write mode (paged decode, chunk,
              contiguous) at every K4_WRITES shape, against its plain
              version (every pool byte but the trash page's, every scale
              and position); K6
              sparq_dequant bit-exact in codes and float modes (f32 and
              bf16 out), `CachedTensor.read` profiled as one K6 launch;
              K2 paged decode and K5 contiguous decode (the split-key
              body) at their serving shapes and at hd 16 / G 4, hd 128
              at G 8 and G 12 and misaligned planes, and (check_f3) K5
              at bk 128 and K2 at page size 128 at F3_SHAPES (G 48 hd 128,
              G 8 and G 16 hd 256: a tile of 128 in chunks of 64 keys;
              G 12 hd 128 in one layout), within 1e-4 of
              f64 and PLAIN_TOL of the plain version, timed beside SDPA
              and the byte bound; K3 chunked prefill at every
              K3_SHAPES shape (hd 64 G 8, the serving shape; hd 16, hd 128
              at G 8, at G 48 (also at page 128 and 16-token query
              tiles) and at G 12 over 2 and 8 KV heads, bq * G = 128,
              page size 128, hd 256, hd 10, misaligned tensors, and the
              exact shapes of the cli and wide paths, a 32-token chunk
              over a long history, each at the
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
              at every KV write (22 per decode step, 2 x 22 per chunk);
              the first decode update and chunk write of the warm-up run,
              replayed alone on their own inputs under the profiler,
              launch K4 and nothing else (`WriteCapture`); then once more
              with `Telemetry.tracing()`: tokens and launches equal the
              untraced run's, the Prometheus text parses back to the stats
              dict, the trace's B/E spans balance on every request's
              track, the host overhead logged
  preempt     the serve phase's requests through a pool of half the
              uncontended peak: requeue under sequential admission (a
              victim re-prefills alone and replays its tokens through K5
              at bk 16), swap and auto under chunked; each run's tokens
              equal the uncontended run's, every mode preempts, swap
              bytes out = in = the swapped pages' planes plus two f32
              scales a layer, exact K2 / K3 / K4 / K5 counts
  prefix      a 256-token system prompt shared by 8 requests (tails of
              16-128 tokens, 3 decode steps apart), chunked, page 16,
              prefix cache off and on: equal tokens, 7 hits, K3 launches
              down by 22 a hit, exact K2 / K3 / K4 counts
  scan        the same model, `DecodeEngine.generate` on batch 8, prompt
              256, gen 32 over the contiguous sparq cache: K1 = 7*22*32,
              K4 = 22*(2 + 31), K5 = 22*31, K2 = K3 = K6 = 0; the first
              prefill slab and decode append replayed alone: K4 only; then
              every
              layer's K/V read back through `CacheStore.kv()` (K6, 44
              launches and no other device kernel), equal to the plain
              dequant of the same bytes
  sequential  the serve phase's 8 requests through the paged engine with
              sequential admission (prefill alone, adopt into pages): K1,
              K2, K4 at every write (2 x 22 per prefill), K3 = K5 = 0;
              the first prefill slab and decode update replayed alone: K4
              only
  dense_family
              granite-20b (52 layers), starcoder2-3b (30) and
              mistral-large-123b (12 of 88: 122 GB of int8 codes at full
              depth) at full width, weights drawn in bf16, calibrated on
              one batch of 8 x 128 and quantized slice by slice, through
              the serve phase's 8 requests on the paged chunked engine;
              granite also at page 128 with --chunk-align 16 (K2's tile of
              128 at G 48 walked in chunks of 64 keys): exact K2 / K3 / K4
              counts, K5 = K6 = 0, every request's tokens, no page leaked;
              decode tok/s, prefill s, peak pages and peak GB logged
  cli         `python -m repro_torch.launch.serve` (CLI_ARGS: the reduced
              tinyllama, paged chunked engine, sparq KV, 5opt) through its
              `main`: every request returns its tokens; K3 at every chunk's
              layer (hd 16 G 4), K2 every decode step; then the same with
              --preempt swap --oversubscribe 0.5 --prefix-cache; then
              granite-20b and starcoder2-3b reduced with --metrics-dump and
              --trace-out under build/ (the dump parses back to the stats,
              the trace balances)
  wide        the same CLI at full width with --chunk-align 16
              --page-size 128 (WIDE_ARGS: 22 layers, K3 at 128 query rows
              a tile in two row blocks, two key tiles a page): the same
              checks
  cnn         the paper's PTQ path (`repro_torch.launch.cnn_eval`):
              paper-resnet at full width (width 32, stages (2, 2, 2), 32 x
              32, 16 classes), seeded, untrained; BN recalibrated and
              min-max site scales on 2 x 128 images; 3072 images at batch
              256 through the 16 codecs of Tables 1, 2 and 4 and an ACIQ
              A4W8, each conv but the stem through K1 (unsigned): K1 =
              14 x 12 x 17 and no other kernel; on one batch a codec the
              logits equal the plain K1's on the card; top-1 agreement
              with the float network and logit_err per codec; then
              Table 6's STC codecs on a 2:4-pruned copy, 32 images, no
              kernel launched
  train       the LLM trainer (`repro_torch.launch.train`): (a) a 2-layer
              full-width f32 tinyllama, 3 steps of `build_train_step` with
              `GradCompressor` (batch 2 x 64) on the card and on the CPU
              from the same weights: losses within 1e-4 relative, params
              to `train_params_close`; (b) a 2-layer full-width model, 4
              steps against 2, a checkpoint, a restore and 2 more, under
              deterministic algorithms: losses and params bit-equal; (c)
              the main path, `train.main` on the full 22-layer model,
              batch 8 x 128, 10 steps, without and with --compress-grads:
              finite losses and grad norms, the last loss below the
              first, no kernel launched (the reference's training path
              reaches no Pallas kernel); median ms a step, tokens/s, peak
              GB logged
  cnn_train   the CNN float trainer (`launch/cnn_train.py`): train_cnn()
              and train_cnn(prune_2_4=True) on the card; float top-1 >
              0.85 and pruned > 0.80 at stage-0 w1 sparsity 0.5 (the
              reference's thresholds), then the paper's 16 quantizers of
              Tables 1, 2, 4 and ACIQ A4W8 on the trained network (3072
              images, K1 unsigned: K1 = 8 sites x (12 x 17 + 1), no other
              kernel; every quantizer's logits equal the plain K1's on
              batch 0), top-1, delta and logit_err logged; Table 6 on the
              pruned network (A8W8 through K1, STC rows, 256 images); the
              claims of tests/test_paper_claims.py logged beside their
              margins
  parity      2-layer full-width f32 models on the card (kernels) and on
              the CPU (plain versions): the paged chunked engine (also at
              chunk-align 16 and page size 128) and the scan engine give
              equal greedy tokens; on the card, the paged
              sequential engine equals the scan engine serving each request
              alone with attn_bk = page_size; a 2-layer full-width f32
              granite-20b's paged chunked engine, card against CPU
  train_profile (not run by default) a full-width compressed train step
              split into forward + backward, compression and AdamW (host
              clock between synchronizations), then one plain and one
              compressed step under torch.profiler: device busy, idle
              share, kernels, the ops with the most device time
  profile     (not run by default) the serve workload once more under
              torch.profiler: device time by kernel, the device's idle
              share of the run, device kernels per decode step and each KV
              write's kernels and device time, counted between marker
              kernels on the device timeline (every decode update one K4
              launch, every chunk write two, nothing else)

Each of serve, preempt, prefix, scan, sequential, dense_family, cli,
wide, cnn, train (its part c) and cnn_train resets the launch counters
just before it drives its path (each of its runs) and reads them just
after; the plain versions of the KV codec must not run there at all.
With all eleven, every
kernel must have launched on some
path. The plain versions of the KV path
(codec, `sparq_pack`, the three writes, the dequantizers) must not run on
any path.

Output: progress lines, then the card's name and power limit, one JSON line
of per-kernel results, and last `{"ok": true, "device": {...}}`. Full
results also go to chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
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
# training: the tolerance on parameters after a few optimizer steps
# ----------------------------------------------------------------------

# Adam's first steps are close to sign(g) element by element: where a
# gradient element sits near 0, or a compressed gradient code at a
# rounding boundary, a last-bit difference in g changes that element's
# step by up to 2 lr. Two runs whose losses agree can then part there by
# up to 2 lr a step, while everywhere else they agree to f32 noise. The
# CPU parity tests (JAX against the port) and the train phase (card
# against CPU) hold parameters to this rule: every element within
# TRAIN_STEP_BOUND x the steps' summed learning rates, and at most
# TRAIN_OUTLIER_SHARE of the elements beyond TRAIN_ATOL.
TRAIN_STEP_BOUND = 2.0
TRAIN_ATOL = 1e-5
TRAIN_OUTLIER_SHARE = 0.01


def train_params_close(want, got, lr_sum: float, what: str) -> dict:
    """Hold two lists of parameter leaves (tensors or arrays, in leaf
    order) to the rule above; returns the largest difference, its ratio
    to lr_sum and the share of elements beyond TRAIN_ATOL."""
    def f64(x):
        if torch.is_tensor(x):
            return x.detach().to("cpu", torch.float64)
        return torch.from_numpy(np.array(x, dtype=np.float64))

    worst, beyond, n = 0.0, 0, 0
    for a, b in zip(want, got, strict=True):
        d = (f64(a) - f64(b)).abs()
        worst = max(worst, float(d.max()))
        beyond += int((d > TRAIN_ATOL).sum())
        n += d.numel()
    out = dict(max_abs=worst, max_over_lr_sum=worst / lr_sum,
               share_beyond_atol=beyond / n)
    if worst > TRAIN_STEP_BOUND * lr_sum or beyond > TRAIN_OUTLIER_SHARE * n:
        raise AssertionError(f"{what}: parameters differ beyond the train "
                             f"tolerance: {out} (lr sum {lr_sum})")
    return out


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


# (K, N) of the four projections of granite-20b (MQA: k/v N 128; a
# non-gated GELU, so one up projection) and starcoder2-3b, at decode and
# chunk M, 5opt (the dense_family phase's codec)
FAMILY_PROJ = {"granite-20b": {"wq/wo": (6144, 6144), "wk/wv": (6144, 128),
                               "up": (6144, 24576), "down": (24576, 6144)},
               "starcoder2-3b": {"wq/wo": (3072, 3072),
                                 "wk/wv": (3072, 256),
                                 "up": (3072, 12288),
                                 "down": (12288, 3072)}}
FAMILY_MS = (8, 256)


def _k1_row(mm, kw, cfg, gen, dev, codec_name, proj, M, K, N):
    """K1 at one shape: run twice, both bit-exact against the plain
    version; timed beside the plain version, `_int_mm` on the codes plus
    the scaling, and the bound. Returns the row."""
    from repro_torch.kernels.ref import quantize_codes

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
    # yardstick: torch._int_mm on the codes + the scaling; _int_mm takes
    # M > 16 and M a multiple of 8, so the codes are zero-padded to lib_m
    # rows where M is not
    lib_m = max(24, -(-M // 8) * 8)

    def codes(s):
        q = torch.zeros((lib_m, K), dtype=torch.int8, device=dev)
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
               else "operations", exact=exact, max_abs_err=err,
               plan=dict(bm=p.bm, bn=p.bn, split_k=p.split_k,
                         blocks=p.blocks))
    log(f"K1 sparq_matmul {codec_name} {proj:7s} M={M:4d} "
        f"K={K} N={N} [BM {p.bm} BN {p.bn} split {p.split_k} "
        f"blocks {p.blocks}]: bit-exact x2, {ms:.4f} ms (plain "
        f"{plain_ms:.3f} ms, _int_mm {lib_ms:.4f} ms"
        f"{f' padded to M={lib_m}' if lib_m != M else ''}, "
        f"bound {bound:.4f} ms)")
    return row


def check_k1(dev, results):
    from repro_torch.core.sparq import SparqConfig
    from repro_torch.kernels import sparq_matmul as mm
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
                rows.append(_k1_row(mm, kw, cfg, gen, dev, codec_name, proj,
                                    M, K, N))
                worst = max(worst, rows[-1]["max_abs_err"])
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
    cfg = SparqConfig.opt5(signed=True)
    kw = dict(bits=cfg.bits, opts_shifts=cfg.shifts, rounding=cfg.rounding,
              vsparq=cfg.vsparq, signed=cfg.signed, max_val=cfg.max_val,
              enabled=cfg.enabled)
    family = []
    for arch, projs in FAMILY_PROJ.items():
        for proj, (K, N) in projs.items():
            for M in FAMILY_MS:
                family.append(dict(_k1_row(mm, kw, cfg, gen, dev, "5opt",
                                           f"{arch} {proj}", M, K, N),
                                   arch=arch))
    results["sparq_matmul_family"] = family
    for arch in FAMILY_PROJ:
        layer = {k: sum(n * r[k] for r in family for p_, n in (
            ("wq/wo", 2), ("wk/wv", 2), ("up", 1), ("down", 1))
            if r["arch"] == arch and r["M"] == 8
            and r["proj"] == f"{arch} {p_}")
            for k in ("ms", "library_ms", "bound_ms")}
        results.setdefault("sparq_matmul_layer_m8", {})[arch] = layer
        log(f"K1 5opt one {arch} layer's six projections at M=8: "
            f"{layer['ms']:.4f} ms (_int_mm padded {layer['library_ms']:.4f}"
            f" ms, bound {layer['bound_ms']:.4f} ms)")
    rows += family
    rows += k1_unsigned_rows(dev, gen, results)
    worst = max(worst, results["sparq_matmul_unsigned"]["max_abs_err"])
    # the JSON line's representative: one prefill-chunk gate/up
    # projection; every shape is in rows
    rep = next(r for r in rows if r["codec"] == "5opt"
               and r["proj"] == "gate/up" and r["M"] == 256)
    results["sparq_matmul"] = dict(
        max_abs_err=worst, ms=rep["ms"], plain_ms=rep["plain_ms"],
        bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
        library_ms=rep["library_ms"],
        shape="5opt gate/up M=256 K=2048 N=5632", rows=rows)


# K1's unsigned (uint8 x int8) calls on the cnn path: paper-resnet at full
# width, batch 256, each conv's im2col product (M = 256 * H * W, K = 9 *
# cin, N = cout), and the trained config's shape in the reference's
# benchmarks (width 24 at 24 x 24: K 216, N 24, not a multiple of 16)
K1_CNN_SHAPES = {"s0 conv": (262144, 288, 32),
                 "s1 conv1/proj": (65536, 288, 64),
                 "s1 conv2": (65536, 576, 64),
                 "s2 conv1/proj": (16384, 576, 128),
                 "s2 conv2": (16384, 1152, 128),
                 "trained w24": (147456, 216, 24)}


def _relu_inputs(gen, dev, M, K, N, cfg):
    """Post-ReLU-like f32 patches (about 40% zeros), int8 weight codes at
    the codec's weight bits, a min-max activation scale (the largest
    value's code is max_val) and per-channel scales."""
    x = torch.relu(torch.randn((M, K), generator=gen, device=dev) + 0.25)
    qw = (1 << (cfg.weight_bits - 1)) - 1
    w = torch.randint(-qw, qw + 1, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    c = torch.rand((N,), generator=gen, device=dev) * 1e-3
    a = (x.amax() / cfg.max_val).reshape(1)
    return x, w, a, c


def k1_unsigned_rows(dev, gen, results):
    """K1 in its unsigned mode at the cnn path's shapes, for every codec of
    the paper's Tables 1, 2 and 4: bit-exact against the plain version and
    two runs equal, with codes above 127 present; then ragged K, N % 16 !=
    0 and split-K at small M. Every row logs the kernel's, the plain
    version's and the library yardstick's times and the bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparq_matmul as mm
    from repro_torch.kernels.ref import quantize_codes
    from repro_torch.launch.cnn_eval import PAPER_CODECS
    rows, worst = [], 0.0
    for shape, (M, K, N) in K1_CNN_SHAPES.items():
        for name, cfg in PAPER_CODECS.items():
            kw = ops._codec_kw(cfg)
            sets = [_relu_inputs(gen, dev, M, K, N, cfg)]
            x, w, a, c = sets[0]
            q = quantize_codes(x, a, False, cfg.max_val)
            zeros = float((q == 0).float().mean())
            if cfg.max_val == 255 and not (q > 127).any():
                raise AssertionError(f"K1 u8 {name} {shape}: no code > 127")
            got = mm.sparq_matmul_cuda(x, w, a, c, **kw)
            again = mm.sparq_matmul_cuda(x, w, a, c, **kw)
            want = mm.ref_sparq_matmul(x, w, a, c, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 u8 {name} {shape} M={M} K={K} "
                                     f"N={N}: not bit-exact (max abs err "
                                     f"{err})")
            if not torch.equal(got, again):
                raise AssertionError(f"K1 u8 {name} {shape}: two runs "
                                     f"differ")
            p = mm.plan(M, N, K, mm.sm_count(dev))
            ms = bench(lambda *s_: mm.sparq_matmul_cuda(*s_, **kw), sets)
            nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
            ops_s = 2 * M * N * K / H100_INT8_OPS_S
            row = dict(codec="u:" + name, proj=shape, M=M, K=K, N=N, ms=ms,
                       bound_ms=max(nbytes / H100_BYTES_S, ops_s) * 1e3,
                       bound_by="bytes" if nbytes / H100_BYTES_S >= ops_s
                       else "operations", exact=True, zero_share=zeros,
                       plan=dict(bm=p.bm, bn=p.bn, split_k=p.split_k,
                                 blocks=p.blocks))
            row["plain_ms"] = bench(
                lambda *s_: mm.ref_sparq_matmul(*s_, **kw), sets, iters=5,
                warmup=1)

            # yardstick: torch._int_mm on the codes shifted to int8 (q -
            # 128), plus the rank-one correction 128 * sum_k w, then the
            # scaling
            def lib_set(s_):
                qs = (quantize_codes(s_[0], s_[2], False, cfg.max_val)
                      - 128).to(torch.int8)
                corr = 128 * s_[1].to(torch.int32).sum(0)
                return qs, s_[1], corr, s_[2], s_[3]
            row["library_ms"] = bench(
                lambda qs, w_, corr, a_, c_: (
                    (torch._int_mm(qs, w_) + corr).float() * a_) * c_,
                [lib_set(s_) for s_ in sets])
            rows.append(row)
            log(f"K1 sparq_matmul u8 {name:13s} {shape:13s} M={M:6d} K={K:4d}"
                f" N={N:3d} [BM {p.bm} BN {p.bn} split {p.split_k}]: "
                f"bit-exact x2, zeros {zeros:.2f}, {ms:.4f} ms (plain "
                f"{row['plain_ms']:.3f} ms, _int_mm {row['library_ms']:.4f} "
                f"ms, bound {row['bound_ms']:.4f} ms)")
            del sets, x, w, a, c, q, got, again, want
    for M, K, N in ((37, 70, 40), (8, 1030, 200)):
        for name, cfg in PAPER_CODECS.items():
            kw = ops._codec_kw(cfg)
            x, w, a, c = _relu_inputs(gen, dev, M, K, N, cfg)
            got = mm.sparq_matmul_cuda(x, w, a, c, **kw)
            again = mm.sparq_matmul_cuda(x, w, a, c, **kw)
            want = mm.ref_sparq_matmul(x, w, a, c, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(again, want)):
                raise AssertionError(
                    f"K1 u8 {name} ragged M={M} K={K} N={N}: not bit-exact "
                    f"(max abs err {float((got - want).abs().max())})")
        p = mm.plan(M, N, K, mm.sm_count(dev))
        log(f"K1 sparq_matmul u8 ragged M={M} K={K} N={N} [BM {p.bm} BN "
            f"{p.bn} split {p.split_k}]: {len(PAPER_CODECS)} codecs "
            f"bit-exact x2")
    torch.cuda.empty_cache()
    rep = next(r for r in rows if r["codec"] == "u:5opt_R"
               and r["proj"] == "s0 conv")
    results["sparq_matmul_unsigned"] = dict(
        max_abs_err=worst, shape="u:5opt_R s0 conv M=262144 K=288 N=32",
        **{k: rep[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")})
    return rows


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
                 "hd 128 G 12": (12, 128, False),
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
             "hd 128 G 48 KV 1 ps 128": ((1, 48, 128, 128, 16, False, 256),
                                         (128, 32, 64, 12)),
             "hd 128 G 12 KV 2": ((2, 12, 128, 16, 8, False, 256),
                                  (128, 32, 64, 2)),
             "hd 128 G 12 KV 8": ((8, 12, 128, 16, 8, False, 256),
                                  (128, 32, 64, 2)),
             "bq*G 128": ((4, 8, 64, 16, 16, False, 256), (64, 64, 64, 2)),
             "ps 128": ((4, 8, 64, 128, 8, False, 256), (64, 64, 64, 1)),
             "hd 256 G 8": ((4, 8, 256, 16, 8, False, 256),
                            (256, 16, 32, 2)),
             "hd 10 G 4": ((4, 4, 10, 16, 8, False, 256), (16, 64, 32, 1)),
             "hd 64 G 8 misaligned": ((4, 8, 64, 16, 8, True, 256),
                                      (64, 64, 64, 1)),
             "cli": ((2, 4, 16, 16, 8, False, 32), (16, 64, 32, 1)),
             "cli granite": ((1, 8, 16, 16, 8, False, 32), (16, 64, 64, 1)),
             "wide": ((4, 8, 64, 128, 16, False, 32), (64, 64, 64, 2))}
# the shapes timed, on the timed layout where it fits the chunk, else on
# the long history (the serving shape is the JSON line's row)
K3_TIMED = ("hd 64 G 8", "hd 16 G 4", "hd 128 G 8", "hd 128 G 48 KV 1",
            "hd 128 G 48 KV 1 ps 128", "hd 128 G 12 KV 2", "hd 128 G 12 KV 8",
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


# K4's write modes at the shapes the driven paths give them, and at hd 128
# (granite, one KV head; mistral-large, eight) and hd 10 (rows of 10 or 30 lanes: the kernel's
# scalar lane pairs): (mode, dims, K/V dtype, calibrated). Paged cases
# cover inactive slots, unallocated blocks, calibrated and uncalibrated
# slots; chunks mix first- and later-segment runs with padding; an
# uncalibrated contiguous decode makes the one-launch mode reduce the slab.
K4_WRITES = {
    "serve decode": ("paged", dict(S=8, KV=4, hd=64, ps=16, NB=34),
                     torch.bfloat16, None),
    "serve chunk": ("chunk", dict(S=8, C=256, KV=4, hd=64, ps=16, NB=34),
                    torch.bfloat16, None),
    "scan prefill": ("contiguous", dict(B=8, T=256, Tmax=296, KV=4, hd=64),
                     torch.bfloat16, False),
    "scan decode": ("contiguous", dict(B=8, T=1, Tmax=296, KV=4, hd=64),
                    torch.bfloat16, True),
    "scan decode, uncalibrated": ("contiguous", dict(B=8, T=1, Tmax=296,
                                                     KV=4, hd=64),
                                  torch.bfloat16, False),
    "sequential prefill": ("contiguous", dict(B=1, T=445, Tmax=480, KV=4,
                                              hd=64), torch.bfloat16, False),
    "cli decode": ("paged", dict(S=4, KV=2, hd=16, ps=16, NB=6),
                   torch.bfloat16, None),
    "cli chunk": ("chunk", dict(S=4, C=32, KV=2, hd=16, ps=16, NB=6),
                  torch.bfloat16, None),
    "wide decode": ("paged", dict(S=4, KV=4, hd=64, ps=128, NB=2),
                    torch.bfloat16, None),
    "wide chunk": ("chunk", dict(S=4, C=32, KV=4, hd=64, ps=128, NB=2),
                   torch.bfloat16, None),
    "hd 128 decode": ("paged", dict(S=8, KV=1, hd=128, ps=16, NB=34),
                      torch.float32, None),
    "hd 128 chunk": ("chunk", dict(S=8, C=256, KV=1, hd=128, ps=16, NB=34),
                     torch.float32, None),
    "hd 128 prefill": ("contiguous", dict(B=8, T=256, Tmax=296, KV=1,
                                          hd=128), torch.float32, False),
    "hd 128 KV 8 decode": ("paged", dict(S=8, KV=8, hd=128, ps=16, NB=34),
                           torch.bfloat16, None),
    "hd 128 KV 8 chunk": ("chunk", dict(S=8, C=256, KV=8, hd=128, ps=16,
                                        NB=34), torch.bfloat16, None),
    "hd 10 decode": ("paged", dict(S=8, KV=1, hd=10, ps=16, NB=34),
                     torch.float32, None),
    "hd 10 chunk": ("chunk", dict(S=8, C=64, KV=3, hd=10, ps=16, NB=34),
                    torch.bfloat16, None),
    # K/V and pools a lane pair past a 16-byte boundary: lane pairs only
    "serve decode, unaligned": ("paged", dict(S=8, KV=4, hd=64, ps=16,
                                              NB=34), torch.bfloat16, None),
    "scan prefill, unaligned": ("contiguous", dict(B=8, T=256, Tmax=296,
                                                   KV=4, hd=64),
                                torch.float32, False),
}
# the case whose numbers stand for K4 in the kernels line: the serve path's
# decode write, K4's most frequent launch on the main path
K4_REP = "serve decode"


def _kv_slab(gen, dev, shape, dtype):
    x = torch.randn(shape, generator=gen, device=dev) * 2
    x = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.2, 0.0,
                    x)
    return x.to(dtype)


def _offset_copy(t, elems):
    """t's values in a buffer that starts `elems` elements past a 16-byte
    boundary."""
    buf = torch.empty((t.numel() + 16,), dtype=t.dtype, device=t.device)
    view = buf[elems:elems + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _bytes(gen, dev, shape):
    return [torch.randint(-8, 8, shape, generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(4)]


def k4_write_case(gen, dev, mode, d, dtype, calibrated):
    """Inputs of one K4 write: (x args, state tensors the write changes in
    place, other args). Paged: slot 1 inactive, slot 2's current block
    unallocated, odd slots uncalibrated; chunk: runs per slot, even slots
    first segments (uncalibrated but slot 4, whose stored scale wins), odd
    slots later segments (calibrated), the last eighth padding, slot 3's
    last block unallocated."""
    i32 = dict(dtype=torch.int32, device=dev)
    if mode == "contiguous":
        B, T, Tmax, KV, hd = (d[k] for k in ("B", "T", "Tmax", "KV", "hd"))
        x = [_kv_slab(gen, dev, (B, T, KV, hd), dtype) for _ in range(2)]
        planes = _bytes(gen, dev, (B, Tmax, KV, hd))
        sc = [torch.full((), 0.02 * (i + 1) if calibrated else 0.0,
                         device=dev) for i in range(2)]
        pos = torch.tensor(0 if T > 1 else Tmax - 6, **i32)
        return x, planes, sc + [pos]
    S, KV, hd, ps, NB = (d[k] for k in ("S", "KV", "hd", "ps", "NB"))
    P = S * NB + 3
    bt = torch.randperm(P, generator=gen, device=dev)[:S * NB].to(
        torch.int32).reshape(S, NB)
    pools = _bytes(gen, dev, (P + 1, ps, KV, hd))
    sc = [torch.rand((S,), generator=gen, device=dev) * 0.03 + 0.005
          for _ in range(2)]
    if mode == "paged":
        pos = torch.randint(0, NB * ps, (S,), generator=gen, **i32)
        pos[1] = -1
        bt[2, int(pos[2]) // ps] = -1
        for s_ in sc:
            s_[1::2] = 0.0
        x = [_kv_slab(gen, dev, (S, 1, KV, hd), dtype) for _ in range(2)]
        return x, pools, sc + [bt, pos]
    C = d["C"]
    live = C - C // 8
    cuts = sorted(torch.randperm(live - 1, generator=gen, device=dev)
                  [:S - 1].add(1).tolist())
    sid = torch.full((C,), -1, **i32)
    pos = torch.zeros((C,), **i32)
    hist = torch.zeros((C,), **i32)
    after = torch.full((S,), -1, **i32)
    for s_, (a, b) in enumerate(zip([0] + cuts, cuts + [live])):
        p0 = 0 if s_ % 2 == 0 else (s_ * 7) % max(NB * ps - (b - a), 1)
        sid[a:b] = s_
        pos[a:b] = torch.arange(p0, p0 + b - a, **i32)
        hist[a:b] = p0
        after[s_] = p0 + b - a
        if s_ == 3:                    # its last token's block: unallocated
            bt[3, (p0 + b - a - 1) // ps] = -1
    for s_ in sc:
        s_[0::2] = 0.0
        s_[4 % S] = 0.01
    x = [_kv_slab(gen, dev, (C, KV, hd), dtype) for _ in range(2)]
    return x, pools, sc + [bt, sid, pos, hist, after]


def k4_write_calls(mode, codec):
    """(kernel, plain) callables of a write mode: f(x, state, other) ->
    the new (k_scale, v_scale, positions)."""
    from repro_torch.kernels import sparq_quant as qk
    from repro_torch.kernels.ops import _codec_kw
    kw = _codec_kw(codec)
    kern = {"paged": qk.kv_write_paged_cuda, "chunk": qk.kv_write_chunk_cuda,
            "contiguous": qk.kv_write_contiguous_cuda}[mode]
    plain = {"paged": qk.ref_kv_write_paged, "chunk": qk.ref_kv_write_chunk,
             "contiguous": qk.ref_kv_write_contiguous}[mode]
    return (lambda x, st, o: kern(*x, *st, *o, **kw),
            lambda x, st, o: plain(*x, *st, *o, **kw))


def k4_write_bytes(mode, d, dtype, other):
    """Bytes a write must move on this case's data, and its operations (one
    f32 division a value). Bytes: K/V read once in their dtype, codes and
    meta written once (2 B a value), scales and positions read and written
    once, the block-table entries the data addresses read once (one a live
    slot at decode, one a distinct (slot, block) of a chunk's tokens), and
    the scale pass's maxima (an int a token of a chunk, a plane's 8 rows of
    a contiguous slab), written once and read back once."""
    vals = 2 * math.prod(d[k] for k in (("B", "T", "KV", "hd")
                                         if mode == "contiguous" else
                                         ("S", "KV", "hd") if mode == "paged"
                                         else ("C", "KV", "hd")))
    moved = vals * (torch.finfo(dtype).bits // 8 + 2)
    if mode == "contiguous":
        rows = d["B"] * d["T"]
        small = 2 * 4 * 2 + 4 * 2                  # scales, pos in and out
        if d["T"] > 1:
            small += 2 * 2 * -(-rows // 8) * 4     # maxima out and back
    elif mode == "paged":
        pos = other[3]
        small = d["S"] * (2 * 4 * 2 + 4 * 2) + int((pos >= 0).sum()) * 4
    else:
        sid, pos = other[3], other[4]
        live = sid >= 0
        blocks = torch.unique(sid[live].long() * d["NB"]
                              + (pos[live] // d["ps"]).long()).numel()
        small = (d["C"] * 3 * 4 + d["S"] * (2 * 4 * 2 + 4 * 2)
                 + blocks * 4 + 2 * 2 * d["C"] * 4)
    return moved + small, vals


def _k4_writes(dev, rows):
    from repro_torch.core.sparq import SparqConfig
    gen = torch.Generator(device=dev).manual_seed(44)
    for name, (mode, d, dtype, calibrated) in K4_WRITES.items():
        for codec_name, cfg in (("5opt", SparqConfig.opt5(signed=True)),
                                ("a8w8", SparqConfig(enabled=False,
                                                     signed=True))):
            kern, plain = k4_write_calls(mode, cfg)
            x, st, other = k4_write_case(gen, dev, mode, d, dtype,
                                         calibrated)
            if "unaligned" in name:
                x = [_offset_copy(t, 2) for t in x]
                st = [_offset_copy(t, 2) for t in st]
            st_plain = [t.clone() for t in st]
            got = kern(x, st, other)
            want = plain(x, st_plain, other)
            torch.cuda.synchronize()
            live = (slice(None),) if mode == "contiguous" \
                else (slice(0, -1),)              # the trash page is free
            for what, g, w in zip(("k_data", "k_meta", "v_data", "v_meta"),
                                  st, st_plain):
                if not torch.equal(g[live], w[live]):
                    raise AssertionError(
                        f"K4 {name} {codec_name}: {what} differs from the "
                        f"plain write ({int((g[live] != w[live]).sum())} "
                        f"bytes)")
            for what, g, w in zip(("k_scale", "v_scale", "positions"), got,
                                  want):
                if not torch.equal(g, w.to(g.dtype)):
                    raise AssertionError(
                        f"K4 {name} {codec_name}: {what} {g.tolist()} != "
                        f"plain {w.tolist()}")
            nbytes, ops = k4_write_bytes(mode, d, dtype, other)
            sets = [k4_write_case(gen, dev, mode, d, dtype, calibrated)
                    for _ in range(n_sets(nbytes))]
            ms = bench(kern, sets)
            plain_ms = bench(plain, sets[:1], iters=5, warmup=1)
            bound = max(nbytes / H100_BYTES_S, ops / H100_F32_FLOPS_S) * 1e3
            rows.append(dict(codec=codec_name, case=name, mode=mode,
                             dims=d, dtype=str(dtype), ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, exact=True))
            log(f"K4 {mode} write {codec_name} {name:26s} "
                f"{str(dtype)[6:]:8s}: bit-exact, {ms:.4f} ms (plain "
                f"{plain_ms:.3f} ms, bound {bound:.3e} ms)")


def check_k4(dev, results):
    """K4's rows mode (the Pallas contract) at the old per-write shapes,
    5opt and a8w8, bit-exact; then every write mode at K4_WRITES against
    its plain version on the card from the same inputs: every pool byte
    but the trash page's, every scale and position equal. That each write
    of a path launches K4 alone is checked on the path's own writes
    (`WriteCapture`)."""
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
            rows.append(dict(codec=codec_name, case=case, mode="rows", M=M,
                             K=K, per_row=per_row, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, exact=True))
            log(f"K4 rows {codec_name} {case:12s} M={M:5d} K={K}"
                f"{' per-row' if per_row else ''}: bit-exact, {ms:.4f} ms "
                f"(plain {plain_ms:.3f} ms, bound {bound:.3e} ms)")
    _k4_writes(dev, rows)
    rep = next(r for r in rows if r["codec"] == "5opt"
               and r["case"] == K4_REP)
    results["sparq_quant"] = dict(
        max_abs_err=0.0, ms=rep["ms"], plain_ms=rep["plain_ms"],
        bound_ms=rep["bound_ms"], bound_by="bytes", library_ms=None,
        shape=f"5opt {K4_REP} write, bf16 K/V (8 slots x 4 KV heads x "
              f"64, both planes)", rows=rows)


# small kernels queued around a profile's markers: on some H100 hosts
# a profile lost its first few device activities (the first marker and
# the kernels after it: 3 or 4 of them), so the bracketed records are
# kept away from both ends
PROFILE_PAD = 1024


def profiled_kernels(fn, fresh=None, attempts=10):
    """Run fn under torch.profiler; the names of the device kernels it
    launched, in order (memory copies and sets included). PROFILE_PAD
    small kernels, a MARK kernel, fn, a MARK kernel and PROFILE_PAD small
    kernels run in turn, each step synchronised: a profile can lose
    device activity, and one that does not hold both markers is no
    observation, so it is taken again, up to `attempts` times. With
    `fresh`, each attempt runs fn(fresh()) on inputs made outside the
    profile."""
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros((1,), device="cuda")

    def padding():
        for _ in range(PROFILE_PAD):
            pad.zero_()
        torch.cuda.synchronize()
    for _ in range(attempts):
        arg = fresh() if fresh is not None else None
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            padding()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            fn() if fresh is None else fn(arg)
            torch.cuda.synchronize()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            padding()
        evs = device_kernels(prof)
        marks = [i for i, e in enumerate(evs) if MARK in e.name]
        if len(marks) == 2:
            return [e.name for e in evs[marks[0] + 1:marks[1]]]
        log(f"profile without its two markers ({len(marks)} found, "
            f"{len(evs)} device activities): taken again")
    raise AssertionError(f"torch.profiler lost the markers around the "
                         f"profiled call in {attempts} attempts")


def check_k6(dev, results):
    """K6 at the read-back shape of the scan cache (8 x 296 slots x 4 KV
    heads, hd 64), every int8 byte in store and meta: bit-exact in codes
    mode and in float mode (f32 and bf16 out); `CachedTensor.read` is one
    K6 launch and no other device kernel."""
    from repro_torch.core.sparq import SparqConfig
    from repro_torch.kernels import sparq_dequant as dq
    from repro_torch.models.cache import CachedTensor
    gen = torch.Generator(device=dev).manual_seed(6)
    M, K = 8 * 296 * 4, 64

    def make():
        return tuple(torch.randint(-128, 128, (M, K), generator=gen,
                                   device=dev, dtype=torch.int8)
                     for _ in range(2)) + (
            torch.rand((), generator=gen, device=dev) * 0.05 + 0.001,)
    sets = [make() for _ in range(n_sets(3 * M * K))]
    store, meta, scale = sets[0]
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
    def off_by_one(t):                 # one byte past a 16-byte boundary
        buf = torch.empty((t.numel() + 1,), dtype=torch.int8, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    for dtype in (None, torch.bfloat16):
        for s_, m_ in ((st, mt), (store, meta), (off_by_one(st),
                                                  off_by_one(mt)),
                       (st[:3, :10].contiguous(), mt[:3, :10].contiguous())):
            g = dq.sparq_dequant_cuda(s_, m_, scale, dtype)
            w = dq.ref_sparq_dequant_float(s_, m_, scale, dtype)
            if not torch.equal(g, w):
                raise AssertionError(
                    f"K6 float mode ({dtype or 'f32'}): not bit-exact on "
                    f"{tuple(s_.shape)} ({int((g != w).sum())} differ)")
    ms = bench(lambda s_, m_, a_: dq.sparq_dequant_cuda(s_, m_), sets)
    plain_ms = bench(lambda s_, m_, a_: dq.ref_sparq_dequant(s_, m_), sets,
                     iters=5, warmup=1)
    float_ms = bench(dq.sparq_dequant_cuda, sets)
    float_plain_ms = bench(dq.ref_sparq_dequant_float, sets, iters=5,
                           warmup=1)
    bound = 3 * M * K / H100_BYTES_S * 1e3
    float_bound = 6 * M * K / H100_BYTES_S * 1e3
    plane = CachedTensor(store.reshape(8, 296, 4, 64),
                         meta.reshape(8, 296, 4, 64), scale, layout="sparq",
                         codec=SparqConfig.opt5(signed=True))
    plane.read()
    names = profiled_kernels(plane.read)
    if len(names) != 1 or "sparq_dequant_kernel" not in names[0]:
        raise AssertionError(f"CachedTensor.read launched {names}, "
                             f"expected one K6 kernel")
    results["sparq_dequant"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", library_ms=None, float_ms=float_ms,
        float_plain_ms=float_plain_ms, float_bound_ms=float_bound,
        shape=f"M={M} K={K} (8 x 296 slots x 4 KV heads), codes mode")
    log(f"K6 sparq_dequant M={M} K={K}: bit-exact in codes and float modes "
        f"(and on all 256 x 256 byte pairs), codes {ms:.4f} ms (plain "
        f"{plain_ms:.3f} ms, bound {bound:.5f} ms); f32 out {float_ms:.4f} "
        f"ms (plain {float_plain_ms:.3f} ms, bound {float_bound:.5f} ms); "
        f"read() = {names}")


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


# The head shapes (G, hd, one KV head) at a 128-key tile, K5 at bk 128
# and K2 at page size 128: those whose tile the split-key body walks in
# chunks (`sparq_decode_attn.sub_keys`, F3), and G 12 / hd 128
# (starcoder2-3b and mistral-large-123b), whose tile fits one layout
F3_SHAPES = {"granite-20b": (48, 128), "paligemma-3b": (8, 256),
             "recurrentgemma-9b": (16, 256), "G 12 hd 128": (12, 128)}


def _decode_yardsticks(q, k, v, live, n_keys_live, extra_bytes):
    """SDPA's time over the decoded keys (decode excluded) under the live
    mask, and the byte / operation bound of one decode call: q and out f32,
    4 bytes per live key and head dim (K and V data + meta)."""
    import torch.nn.functional as F
    B, KV, G, hd = q.shape
    qh = q.reshape(B, KV * G, 1, hd)
    kk = k.transpose(1, 2).repeat_interleave(G, 1)
    vv = v.transpose(1, 2).repeat_interleave(G, 1)
    mask = live[:, None, None, :]
    lib_ms = bench(lambda: F.scaled_dot_product_attention(
        qh, kk, vv, attn_mask=mask), [()])
    nbytes = B * KV * G * hd * 4 * 2 + n_keys_live * KV * hd * 4 + extra_bytes
    flops = 4 * n_keys_live * KV * G * hd
    bound = max(nbytes / H100_BYTES_S, flops / H100_F32_FLOPS_S) * 1e3
    by = "bytes" if nbytes / H100_BYTES_S >= flops / H100_F32_FLOPS_S \
        else "operations"
    return lib_ms, bound, by


def check_f3(dev, results):
    """K5 at bk 128 (the scan decode's 8 x 296 planes, cur 286, a ragged
    last tile) and K2 at page size 128 (check_k2's slots) at F3_SHAPES,
    without and with a window: within 1e-4 of decode_f64_reference and
    PLAIN_TOL of the plain version; times beside SDPA's and the bound."""
    from repro_torch.kernels import sparq_decode_attn as dec
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    for arch, (G, hd) in F3_SHAPES.items():
        k5s = [k5_case(gen, dev, G=G, hd=hd, KV=1)
               for _ in range(n_sets(4 * 8 * 296 * hd))]
        k2s = [k2_case(gen, dev, G=G, hd=hd, KV=1, ps=128, NB=5)
               for _ in range(n_sets(4 * 20 * 128 * hd))]
        k5, k2 = k5s[0], k2s[0]
        errs = {}
        for window in (0, K2_WINDOW):
            got = dec.sparq_decode_attn_cuda(*k5, window=window, bk=128)
            want = dec.ref_sparq_decode_attn(*k5, window=window, bk=128)
            exact = decode_f64_reference(k5[0], *contig_keys(
                *k5[1:], window=window))
            errs[f"K5 window {window}"] = hold(
                f"K5 {arch} bk 128, window {window}", got, want, exact,
                PLAIN_TOL)
            got = dec.sparq_paged_decode_attn_cuda(*k2, window=window)
            want = dec.ref_sparq_paged_decode_attn(*k2, window=window)
            exact = decode_f64_reference(k2[0], *paged_keys(
                *k2[1:], window=window))
            errs[f"K2 window {window}"] = hold(
                f"K2 {arch} ps 128, window {window}", got, want, exact,
                PLAIN_TOL)
        timed = [("K5", lambda *x: dec.sparq_decode_attn_cuda(*x, bk=128),
                  k5s, contig_keys(*k5[1:])),
                 ("K2", dec.sparq_paged_decode_attn_cuda, k2s,
                  paged_keys(*k2[1:]))]
        if hd == 128:
            # the dense family's head shapes at their serving page size
            k2p = [k2_case(gen, dev, G=G, hd=hd, KV=1)
                   for _ in range(n_sets(4 * 300 * 16 * hd))]
            got = dec.sparq_paged_decode_attn_cuda(*k2p[0])
            errs["K2 ps 16 window 0"] = hold(
                f"K2 {arch} ps 16", got,
                dec.ref_sparq_paged_decode_attn(*k2p[0]),
                decode_f64_reference(k2p[0][0], *paged_keys(*k2p[0][1:])),
                PLAIN_TOL)
            timed.append(("K2 ps 16", dec.sparq_paged_decode_attn_cuda, k2p,
                          paged_keys(*k2p[0][1:])))
        _log_decode(f"F3 {arch} (G {G}, hd {hd})", errs)
        row = dict(G=G, hd=hd, sub=dec.sub_keys(G, hd, 128),
                   smem=dec.smem_bytes(G, hd, 128), errors=errs)
        for name, fn, a, keys in timed:
            ms = bench(fn, a)
            a = a[0]
            live = keys[2]
            extra = a[7].numel() * 4 + 12
            lib_ms, bound, by = _decode_yardsticks(
                a[0], keys[0], keys[1], live, int(live.sum()), extra)
            row[name] = dict(ms=ms, library_ms=lib_ms, bound_ms=bound,
                             bound_by=by)
            err64 = max(e["f64"] for k, e in errs.items()
                        if k.startswith(name + " w"))
            row[name].update(max_abs_err_f64=err64)
            tile = 16 if name == "K2 ps 16" else 128
            log(f"F3 {arch} {name} (G {G}, hd {hd}, tile {tile} in chunks "
                f"of {dec.sub_keys(G, hd, tile)}): {ms:.4f} ms (SDPA "
                f"{lib_ms:.4f} ms, bound "
                f"{bound:.5f} ms, {int(live.sum())} live keys), max abs "
                f"err vs f64 {err64:.2e}")
        rows[arch] = row
    results["f3"] = rows


# ----------------------------------------------------------------------
# phase: the main path end to end, full width
# ----------------------------------------------------------------------

def _full_width(dev, arch="tinyllama-1.1b", n_layers=None, dtype=None):
    """`arch` at full width (and full depth unless `n_layers` cuts it),
    bf16 compute, random weights (seed 0) drawn in `dtype` (default the
    config's param_dtype) as int8 codes, one calibration batch of 8 x 128,
    5opt. The float tree is dropped once the codes exist."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.models.quantize import quantize_params
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg, device=dev)
    params = model.init_params(seed=0, dtype=dtype)
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                              global_batch=8, seed=0))
    scales = model.calibrate(params, data.calib_batches(1))
    codec = serve.SPARQ_PRESETS["5opt"]
    qparams = quantize_params(params, codec.weight_bits)
    del params
    return cfg, model, qparams, scales, codec


def _serve_requests(cfg):
    """The serve phase's 8 requests: seeded ragged lengths 64-512, gen 32.
    Returns (requests, lengths, gen)."""
    from repro_torch.launch import serve
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 8)
    gen = 32
    reqs = [serve.Request(rng.integers(0, cfg.vocab_size, int(L)), gen)
            for L in lens]
    return reqs, lens, gen


def _serve_engine(model, codec, scales, dev, lens, gen, prefill="chunked",
                  ps=16, align=8, telemetry=None):
    """The paged engine (chunk 256) with pages of `ps`, sized to hold the
    requests of `lens` uncontended. Returns (engine, n_pages)."""
    from repro_torch.launch import serve
    from repro_torch.models.common import QuantCtx
    max_seq = -(-(int(lens.max()) + gen - 1) // ps) * ps
    n_pages = sum(math.ceil((int(L) + gen - 1) / ps) for L in lens) + 8
    engine = serve.ContinuousBatchingEngine(
        model, serve.make_cache_config("sparq", codec),
        QuantCtx(mode="quantized", cfg=codec), scales, page_size=ps,
        n_pages=n_pages, max_active=8, max_seq_len=max_seq,
        prefill=prefill, chunk_size=256, chunk_align=align, device=dev,
        telemetry=telemetry)
    return engine, n_pages


def _serve_setup(dev, prefill="chunked"):
    """The serve phase's workload: the full-width model, 8 requests of
    seeded ragged lengths 64-512 and gen 32, and the paged engine (page
    16, chunk 256) sized to hold them, with `prefill` admission."""
    cfg, model, params, scales, codec = _full_width(dev)
    reqs, lens, gen = _serve_requests(cfg)
    engine, n_pages = _serve_engine(model, codec, scales, dev, lens, gen,
                                    prefill)
    return cfg, engine, params, reqs, lens, gen, n_pages


class PlainCodecSpy:
    """Counts calls of the KV path's plain versions while a path runs on
    the card, where every KV write must go through K4 and every read-back
    through K6 instead: the plain codec, `sparq_pack`, the three plain
    writes and the plain dequantizers."""

    NAMES = (("ref", "ref_sparq_quant"), ("sparq_quant", "ref_sparq_quant"),
             ("ref", "sparq_pack"), ("ops", "sparq_pack"),
             ("sparq_quant", "ref_kv_write_paged"),
             ("sparq_quant", "ref_kv_write_chunk"),
             ("sparq_quant", "ref_kv_write_contiguous"),
             ("sparq_dequant", "ref_sparq_dequant"),
             ("sparq_dequant", "ref_sparq_dequant_float"))

    def __enter__(self):
        import importlib
        self.calls = {}
        self._orig = []
        for mod, name in self.NAMES:
            m = importlib.import_module(f"repro_torch.kernels.{mod}")
            orig = getattr(m, name)
            self._orig.append((m, name, orig))

            def spy(*a, _orig=orig, _name=name, **k):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _orig(*a, **k)
            setattr(m, name, spy)
        return self

    def __exit__(self, *exc):
        for m, name, orig in self._orig:
            setattr(m, name, orig)


def _clone_state(obj):
    """A copy of a cache store (or plane) whose tensors are fresh clones."""
    c = copy.copy(obj)
    for name, v in vars(obj).items():
        if isinstance(v, torch.Tensor):
            setattr(c, name, v.clone())
        elif dataclasses.is_dataclass(v) and any(
                isinstance(t, torch.Tensor) for t in vars(v).values()):
            setattr(c, name, _clone_state(v))
    return c


class WriteCapture:
    """Keeps the first call of each KV write a path makes through the store
    API: a copy of the store as it was, and the K/V and chunk metadata as
    the model passed them (their dtype, strides and alignment), so that
    `replay_alone` can run that very write again under the profiler."""

    WRITES = (("paging", "PagedCacheStore", "update"),
              ("paging", "PagedCacheStore", "write_chunk"),
              ("cache", "CacheStore", "update"))
    # K4 launches of each write: one at decode, two for a chunk or a
    # contiguous prefill slab (scale pass, write pass)
    LAUNCHES = {"PagedCacheStore.update": 1,
                "PagedCacheStore.write_chunk": 2,
                "CacheStore.update (decode)": 1,
                "CacheStore.update (prefill slab)": 2}

    def __enter__(self):
        import importlib
        self.calls, self._orig = {}, []
        for mod, cls_name, meth in self.WRITES:
            cls = getattr(importlib.import_module(
                f"repro_torch.models.{mod}"), cls_name)
            orig = getattr(cls, meth)
            self._orig.append((cls, meth, orig))

            def spy(st, *a, _orig=orig, _name=f"{cls_name}.{meth}", **k):
                if _name == "CacheStore.update":
                    _name += " (decode)" if a[0].shape[1] == 1 else \
                        " (prefill slab)"
                if _name not in self.calls:
                    self.calls[_name] = (_clone_state(st), _orig, a, k)
                return _orig(st, *a, **k)
            setattr(cls, meth, spy)
        return self

    def __exit__(self, *exc):
        for cls, meth, orig in self._orig:
            setattr(cls, meth, orig)

    def replay_alone(self, want):
        """Run each captured write once more, profiled, on a fresh copy of
        its store: it must launch K4 and no other device kernel, once at
        decode and twice for a chunk or a prefill slab. `want` names the
        writes the path must have made. Returns the kernels seen."""
        if sorted(self.calls) != sorted(want):
            raise AssertionError(f"captured writes {sorted(self.calls)}, "
                                 f"expected {sorted(want)}")
        out = {}
        for what, (saved, fn, a, k) in self.calls.items():
            n = self.LAUNCHES[what]
            names = profiled_kernels(lambda st: fn(st, *a, **k),
                                     fresh=lambda: _clone_state(saved))
            out[what] = names
            if len(names) != n or not all("sparq_quant_" in x
                                          for x in names):
                raise AssertionError(f"{what} on the path's own inputs "
                                     f"launched {names}, expected {n} K4 "
                                     f"kernel(s) and nothing else")
        log("K4 alone on the path's writes: " + "; ".join(
            f"{w}: {len(v)} launch(es), K4 only" for w, v in out.items()))
        return out


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
        raise AssertionError(f"plain versions of the KV path ran on the "
                             f"card: {spy.calls}")
    return out, counts


def _check_requests(cfg, reqs, out, gen):
    for rid in range(len(reqs)):
        toks = out[rid]
        assert len(toks) == gen, (rid, len(toks))
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), rid


def _paged_full_width(dev, results, prefill):
    t0 = time.perf_counter()
    cfg, model, params, scales, codec = _full_width(dev)
    reqs, lens, gen = _serve_requests(cfg)
    engine, n_pages = _serve_engine(model, codec, scales, dev, lens, gen,
                                    prefill)
    L = cfg.n_layers
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    with WriteCapture() as cap:
        engine.run(params, reqs)                   # warm-up, untimed
    (out, stats), counts = _drive(lambda: engine.run(params, reqs))
    _check_requests(cfg, reqs, out, gen)
    alone = cap.replay_alone(
        ["PagedCacheStore.update"] + (
            ["PagedCacheStore.write_chunk"] if prefill == "chunked" else
            ["CacheStore.update (prefill slab)"]))
    assert stats["free_pages_after"] == n_pages, "pages leaked"
    steps = stats["decode_steps"]
    chunks = stats["prefill_chunks"]
    # sequential: one prefill per request (7 matmuls per layer); K4 is one
    # launch a layer per decode step and two (scale pass, write pass) per
    # chunk or per contiguous prefill slab
    prefills = chunks if prefill == "chunked" else len(reqs)
    assert counts["sparq_matmul"] >= 7 * L * (steps + prefills), counts
    assert counts["sparq_paged_decode_attn"] == L * steps, counts
    assert counts["sparq_quant"] == L * (2 * prefills + steps), counts
    assert counts["sparq_chunked_prefill_attn"] == L * chunks, counts
    assert counts["sparq_decode_attn"] == 0, counts
    assert counts["sparq_dequant"] == 0, counts
    if prefill == "chunked":
        assert chunks > 0, "no prefill chunk ran"
    else:
        assert chunks == 0 and counts["sparq_chunked_prefill_attn"] == 0
    name = "serve" if prefill == "chunked" else "sequential"
    traced = None
    if prefill == "chunked":
        from repro_torch.obs import Telemetry
        traced = _traced_serve(
            _serve_engine(model, codec, scales, dev, lens, gen, prefill,
                          telemetry=Telemetry.tracing())[0],
            engine, params, reqs, out, stats, counts)
    results[name] = dict(
        arch=cfg.name, n_layers=L, dtype=str(cfg.dtype),
        prompt_lens=[int(x) for x in lens], gen=gen, chunk_size=256,
        setup_s=t_setup, launches=counts, k4_alone=alone, traced=traced,
        **{k: v for k, v in stats.items() if not isinstance(v, dict)})
    log(f"{name} {cfg.name} x{L} layers bf16 5opt int8-weights, "
        f"{prefill} prefill: prefill {stats['prefill_s']:.3f} s "
        f"({chunks} chunks) | decode {stats['decode_tok_s']:.1f} tok/s "
        f"({steps} steps) | peak pages {stats['peak_pages_used']}/"
        f"{n_pages} | launches {counts}")
    del params, engine
    torch.cuda.empty_cache()
    return counts


def _traced_serve(engine, plain, params, reqs, out, stats, counts):
    """The serve run once more on an engine with `Telemetry.tracing()`
    (kernels built, so no warm-up): tokens and every launch count equal
    the untraced run's; the registry's Prometheus text parses back with
    the port's `parse_prometheus` and its counters equal the stats dict;
    the trace is valid JSON whose B/E spans balance on every request's
    track. The host overhead is the traced run's wall time over the
    untraced one's, each the mean of two runs taken in turns (untraced,
    traced, traced, untraced) on the engines `plain` and `engine`."""
    from repro_torch.obs import export
    (tout, tstats), tcounts = _drive(lambda: engine.run(params, reqs))
    for rid in out:
        if not np.array_equal(tout[rid], out[rid]):
            raise AssertionError(f"traced serve: request {rid}'s tokens "
                                 f"differ from the untraced run's")
    if tcounts != counts:
        raise AssertionError(f"traced serve launches {tcounts}, untraced "
                             f"{counts}")
    reg = engine.telemetry.registry
    parsed = export.parse_prometheus(export.prometheus_text(reg))
    for metric, key in (("engine_decode_steps_total", "decode_steps"),
                        ("engine_decode_tokens_total", "decode_tokens"),
                        ("engine_prefill_chunks_total", "prefill_chunks"),
                        ("engine_resumes_total", "resumes"),
                        ("pool_pages_peak", "peak_pages_used")):
        if parsed[(metric, "")] != tstats[key]:
            raise AssertionError(f"traced serve: {metric} "
                                 f"{parsed[(metric, '')]} != stats[{key!r}]"
                                 f" {tstats[key]}")
    if tstats["decode_steps"] != stats["decode_steps"] or \
            parsed[("engine_step_phase_seconds_count", 'phase="decode"')] \
            != tstats["decode_steps"]:
        raise AssertionError("traced serve: step counts differ")
    blob = json.loads(json.dumps(export.trace_json(engine.telemetry.tracer)))
    depth, tids = {}, set()
    for e in blob["traceEvents"]:
        if e["ph"] == "B":
            depth[e["tid"]] = depth.get(e["tid"], 0) + 1
            tids.add(e["tid"])
        elif e["ph"] == "E":
            depth[e["tid"]] = depth.get(e["tid"], 0) - 1
            if depth[e["tid"]] < 0:
                raise AssertionError(f"trace: E without B on {e['tid']}")
    if any(depth.values()) or tids != {rid + 1 for rid in out}:
        raise AssertionError(f"trace: open spans {depth}, request tracks "
                             f"{sorted(tids)}")
    runs = {"untraced": [], "traced": []}
    for which in ("untraced", "traced", "traced", "untraced"):
        eng = plain if which == "untraced" else engine
        runs[which].append(eng.run(params, reqs)[1]["run_s"])
    t_run, u_run = (sum(runs[k]) / 2 for k in ("traced", "untraced"))
    overhead = t_run / u_run - 1
    log(f"serve traced (Telemetry.tracing()): tokens and launches equal the "
        f"untraced run's; {len(blob['traceEvents'])} trace events, "
        f"{len(parsed)} Prometheus samples; in turns, run {t_run:.3f} s "
        f"traced against {u_run:.3f} s untraced ({overhead:+.1%}; runs "
        f"{runs})")
    return dict(run_s=t_run, untraced_run_s=u_run, runs=runs,
                host_overhead=overhead, decode_tok_s=tstats["decode_tok_s"],
                prefill_s=tstats["prefill_s"],
                trace_events=len(blob["traceEvents"]),
                prometheus_samples=len(parsed))


def serve_full_width(dev, results):
    return _paged_full_width(dev, results, "chunked")


def sequential_full_width(dev, results):
    return _paged_full_width(dev, results, "sequential")


# ----------------------------------------------------------------------
# phase: the rest of the dense family, full width
# ----------------------------------------------------------------------

# arch: (layers served, None for all; the (page size, chunk alignment) of
# each run). Granite-20b runs at page 16 and at page 128 with 16-token
# query tiles: at page 128 K2's 128-key tile at G 48 / hd 128 does not fit
# one block and is walked in chunks of 64 keys (F3's repair). Mistral-
# large-123b keeps 12 of its 88 layers: its int8 codes alone take 122 GB
# at full depth, 12 layers 16.6 GB beside 33 GB of bf16 weights.
DENSE_FAMILY = {"granite-20b": (None, ((16, 8), (128, 16))),
                "starcoder2-3b": (None, ((16, 8),)),
                "mistral-large-123b": (12, ((16, 8),))}


def dense_k3_shape(cfg, ps, align):
    """K3's shape on a dense_family run, as K3_SHAPES writes it."""
    return (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, ps,
            align, False, 256)


def dense_family(dev, results):
    """Each DENSE_FAMILY model at full width, weights drawn in bf16 (f32
    granite-20b would take 80 GB) and calibrated in bf16 on one batch of 8
    x 128, quantized slice by slice to int8 codes, the float tree dropped;
    then the serve phase's 8 requests through the paged chunked engine
    (5opt, sparq KV, chunk 256) at each of its (page size, alignment): a
    warm-up run, then the timed run with exact counts (K2 = L x steps, K3
    = L x chunks, K4 = L x (2 x chunks + steps), K5 = K6 = 0), every
    request's tokens, no page leaked. Logs decode tok/s, prefill s, peak
    pages and peak GB (`max_memory_allocated` from the model's init)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import sparq_decode_attn as dec
    from repro_torch.kernels import sparq_prefill_attn as pre
    from repro_torch.models.ffn import GATED
    total = {k: 0 for k in build.KERNELS}
    rows = {}
    for arch, (depth, runs) in DENSE_FAMILY.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, model, params, scales, codec = _full_width(
            dev, arch, depth, torch.bfloat16)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        setup_gb = torch.cuda.max_memory_allocated() / 1e9
        reqs, lens, gen = _serve_requests(cfg)
        L, G, hd = cfg.n_layers, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
        n_proj = 7 if cfg.mlp_type in GATED else 6
        for ps, align in runs:
            name = f"{arch} ps {ps}"
            k3 = dense_k3_shape(cfg, ps, align)
            if not any(v[0] == k3 for v in K3_SHAPES.values()):
                raise AssertionError(f"{name}: K3 runs at {k3}, which "
                                     f"check_k3 does not hold")
            engine, n_pages = _serve_engine(model, codec, scales, dev, lens,
                                            gen, ps=ps, align=align)
            engine.run(params, reqs)                 # warm-up, untimed
            (out, stats), counts = _drive(lambda: engine.run(params, reqs))
            _check_requests(cfg, reqs, out, gen)
            if stats["free_pages_after"] != n_pages:
                raise AssertionError(f"{name}: pages leaked")
            steps, chunks = stats["decode_steps"], stats["prefill_chunks"]
            want = {"sparq_paged_decode_attn": L * steps,
                    "sparq_chunked_prefill_attn": L * chunks,
                    "sparq_quant": L * (2 * chunks + steps),
                    "sparq_decode_attn": 0, "sparq_dequant": 0}
            got = {k: counts[k] for k in want}
            # K1 at every projection of every layer, each step and chunk
            want["sparq_matmul"] = n_proj * L * (steps + chunks)
            got = {k: counts[k] for k in want}
            if got != want or chunks == 0:
                raise AssertionError(f"{name}: launches {counts} ({steps} "
                                     f"steps, {chunks} chunks), expected "
                                     f"{want}")
            for k, v in counts.items():
                total[k] += v
            sub = dec.sub_keys(G, hd, ps)
            rows[name] = dict(
                arch=arch, n_layers=L, of_layers=get_config(arch).n_layers,
                param_dtype="bfloat16", chunk_align=align,
                k2_sub_keys=sub, k2_smem=dec.smem_bytes(G, hd, ps),
                k3_shape=list(k3),
                k3_traits=pre.k3_traits(hd, G, align, ps)._asdict(),
                setup_s=t_setup, setup_peak_gb=setup_gb,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=counts,
                **{k: v for k, v in stats.items()
                   if not isinstance(v, dict)})
            log(f"dense_family {name}: {L} of {get_config(arch).n_layers} "
                f"layers, G {G} hd {hd} KV {cfg.n_kv_heads}, {cfg.mlp_type}"
                f" {cfg.norm_type}: prefill {stats['prefill_s']:.3f} s "
                f"({chunks} chunks) | decode {stats['decode_tok_s']:.1f} "
                f"tok/s ({steps} steps) | peak pages "
                f"{stats['peak_pages_used']}/{n_pages} | K2 tile {ps} in "
                f"chunks of {sub} keys | setup {t_setup:.1f} s, peak "
                f"{setup_gb:.1f} GB at setup, "
                f"{rows[name]['peak_gb']:.1f} GB | launches {counts}")
            del engine
        del params, model, scales
    results["dense_family"] = rows
    return total


# ----------------------------------------------------------------------
# phases: preemption and the prefix cache, full width
# ----------------------------------------------------------------------

class SwapPagesSpy:
    """Counts the pages each swap-out gathers (`paging.gather_slot_pages`
    is called once per layer a swap)."""

    def __enter__(self):
        from repro_torch.models import paging
        self.pages, self._orig = [], paging.gather_slot_pages

        def spy(store, slot, pages, _orig=self._orig):
            self.pages.append(int(pages.numel()))
            return _orig(store, slot, pages)
        paging.gather_slot_pages = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import paging
        paging.gather_slot_pages = self._orig


def _paged_engine(model, codec, scales, dev, prefill, n_pages, max_seq,
                  policy=None, **kw):
    from repro_torch.launch import serve
    from repro_torch.models.common import QuantCtx
    return serve.ContinuousBatchingEngine(
        model, serve.make_cache_config("sparq", codec),
        QuantCtx(mode="quantized", cfg=codec), scales, page_size=16,
        n_pages=n_pages, max_active=8, max_seq_len=max_seq, policy=policy,
        prefill=prefill, chunk_size=256, chunk_align=8, device=dev, **kw)


def _same_tokens(what, got, want):
    for rid in want:
        if not np.array_equal(got[rid], want[rid]):
            raise AssertionError(f"{what}: request {rid}'s tokens differ "
                                 f"from the uncontended run's")


def preempt_full_width(dev, results):
    """The serve phase's 8 requests through an oversubscribed pool (half
    the uncontended peak): requeue under sequential admission, swap and
    auto under chunked. Tokens equal the uncontended runs'; every mode
    preempts; swap bytes out = in = the swapped pages' planes plus their
    scales; exact launch counts, K5 = 22 a replay step."""
    from repro_torch.launch import serve
    from repro_torch.models import paging
    cfg, model, params, scales, codec = _full_width(dev)
    L = cfg.n_layers
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 8)
    gen = 32
    reqs = [serve.Request(rng.integers(0, cfg.vocab_size, int(n)), gen)
            for n in lens]
    max_seq = -(-(int(lens.max()) + gen - 1) // 16) * 16
    full = sum(math.ceil((int(n) + gen - 1) / 16) for n in lens) + 8
    ref, peak = {}, {}
    for prefill in ("sequential", "chunked"):
        eng = _paged_engine(model, codec, scales, dev, prefill, full,
                            max_seq)
        ref[prefill], st = eng.run(params, reqs)
        peak[prefill] = st["peak_pages_used"]
    n_pages = max(peak.values()) // 2
    page_bytes = 4 * L * 16 * cfg.n_kv_heads * cfg.head_dim
    total, rows = {}, {}
    for mode, prefill in (("requeue", "sequential"), ("swap", "chunked"),
                          ("auto", "chunked")):
        eng = _paged_engine(model, codec, scales, dev, prefill, n_pages,
                            max_seq, serve.SchedulerPolicy(preempt=mode))
        with SwapPagesSpy() as spy:
            (out, st), counts = _drive(lambda: eng.run(params, reqs))
        _check_requests(cfg, reqs, out, gen)
        _same_tokens(f"preempt {mode} ({prefill})", out, ref[prefill])
        steps, chunks = st["decode_steps"], st["prefill_chunks"]
        replays = st["replay_steps"]
        if st["preemptions"] <= 0:
            raise AssertionError(f"preempt {mode}: the pool of {n_pages} "
                                 f"pages preempted nothing")
        swapped = sum(spy.pages) // L
        want_bytes = swapped * page_bytes + 8 * L * st["preempt_swap"]
        if not st["swap_bytes_out"] == st["swap_bytes_in"] == want_bytes:
            raise AssertionError(
                f"preempt {mode}: swap bytes out {st['swap_bytes_out']}, "
                f"in {st['swap_bytes_in']}, expected {want_bytes} "
                f"({swapped} pages x {page_bytes} + scales)")
        if mode == "swap" and st["preempt_swap"] == 0:
            raise AssertionError("preempt swap: no victim was swapped")
        assert st["free_pages_after"] == n_pages, "pages leaked"
        if prefill == "sequential":
            # prefills: every admission and every requeue resume; a replay
            # step is one contiguous decode (K4 append, K5 at bk = 16)
            prefills = len(reqs) + st["preempt_requeue"]
            want = {"sparq_paged_decode_attn": L * steps,
                    "sparq_decode_attn": L * replays,
                    "sparq_chunked_prefill_attn": 0,
                    "sparq_quant": L * (2 * prefills + steps + replays)}
            if replays <= 0:
                raise AssertionError("preempt requeue: nothing replayed")
        else:
            # chunked: re-prefills stream as chunks, replays ride the
            # decode steps
            prefills = chunks
            want = {"sparq_paged_decode_attn": L * steps,
                    "sparq_decode_attn": 0,
                    "sparq_chunked_prefill_attn": L * chunks,
                    "sparq_quant": L * (2 * chunks + steps)}
        want["sparq_dequant"] = 0
        for k, v in want.items():
            if counts[k] != v:
                raise AssertionError(f"preempt {mode}: {k} launched "
                                     f"{counts[k]} times, expected {v} "
                                     f"({counts})")
        # a sequential replay step is a decode of its own; a chunked one
        # rides a decode step
        seq_replays = replays if prefill == "sequential" else 0
        if counts["sparq_matmul"] < 7 * L * (steps + prefills + seq_replays):
            raise AssertionError(f"preempt {mode}: K1 {counts}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        rows[mode] = dict(prefill=prefill, swapped_pages=swapped,
                          launches=counts,
                          **{k: v for k, v in st.items()
                             if not isinstance(v, dict)})
        log(f"preempt {mode} ({prefill}, {n_pages} of {full} pages, "
            f"uncontended peak {peak[prefill]}): {st['preemptions']} "
            f"preemptions ({st['preempt_requeue']} requeue, "
            f"{st['preempt_swap']} swap), {replays} replay steps, swap "
            f"{st['swap_bytes_out']} B out / {st['swap_bytes_in']} B in "
            f"({swapped} pages), {steps} decode steps, {chunks} chunks, "
            f"resume {st['resume_s']:.3f} s, decode "
            f"{st['decode_tok_s']:.1f} tok/s; tokens equal the "
            f"uncontended run's; launches {counts}")
    results["preempt"] = dict(uncontended_peak=peak, runs=rows)
    del params
    torch.cuda.empty_cache()
    return total


def prefix_full_width(dev, results):
    """A shared system prompt: a 256-token preamble (one prefix quantum:
    16 pages, one chunk segment) and ragged 16-128-token tails, 8 requests
    arriving 3 decode steps apart (each prefills alone), gen 32, chunked,
    page 16. Tokens with --prefix-cache equal tokens without; every later
    request hits; each hit skips exactly the preamble's chunk, so K3
    launches drop by 22 a hit; exact K2, K3, K4 counts."""
    from repro_torch.launch import serve
    cfg, model, params, scales, codec = _full_width(dev)
    L = cfg.n_layers
    rng = np.random.default_rng(1)
    pre = rng.integers(0, cfg.vocab_size, 256)
    tails = rng.integers(16, 129, 8)
    gen = 32
    reqs = [serve.Request(np.concatenate(
        [pre, rng.integers(0, cfg.vocab_size, int(t))]), gen,
        arrive_at=3 * i) for i, t in enumerate(tails)]
    lens = [len(r.tokens) for r in reqs]
    max_seq = -(-(max(lens) + gen - 1) // 16) * 16
    n_pages = sum(math.ceil((n + gen - 1) / 16) for n in lens) + 8
    out, stats, counts = {}, {}, {}
    for on in (False, True):
        eng = _paged_engine(model, codec, scales, dev, "chunked", n_pages,
                            max_seq, prefix_cache=on)
        (out[on], stats[on]), counts[on] = _drive(
            lambda: eng.run(params, reqs))
        _check_requests(cfg, reqs, out[on], gen)
        st, c = stats[on], counts[on]
        steps, chunks = st["decode_steps"], st["prefill_chunks"]
        want = {"sparq_paged_decode_attn": L * steps,
                "sparq_chunked_prefill_attn": L * chunks,
                "sparq_quant": L * (2 * chunks + steps),
                "sparq_decode_attn": 0, "sparq_dequant": 0}
        for k, v in want.items():
            if c[k] != v:
                raise AssertionError(f"prefix cache {on}: {k} launched "
                                     f"{c[k]} times, expected {v} ({c})")
        assert st["free_pages_after"] == n_pages, "pages leaked"
    _same_tokens("prefix cache on", out[True], out[False])
    hits = stats[True]["prefix_hits"]
    if hits != len(reqs) - 1 or stats[True]["prefix_hit_tokens"] != \
            256 * hits or stats[True]["preemptions"]:
        raise AssertionError(f"prefix cache: {hits} hits, "
                             f"{stats[True]['prefix_hit_tokens']} tokens "
                             f"from cache; expected {len(reqs) - 1} hits "
                             f"of 256 tokens")
    if stats[False]["prefill_chunks"] != 2 * len(reqs):
        raise AssertionError(f"prefix cache off: "
                             f"{stats[False]['prefill_chunks']} chunks, "
                             f"expected 2 a request (each alone)")
    drop = counts[False]["sparq_chunked_prefill_attn"] - \
        counts[True]["sparq_chunked_prefill_attn"]
    if drop != L * hits:
        raise AssertionError(f"prefix cache: K3 launches dropped by {drop}, "
                             f"expected {L} x {hits} skipped chunks")
    results["prefix"] = {str(on): dict(launches=counts[on], **{
        k: v for k, v in stats[on].items() if not isinstance(v, dict)})
        for on in (False, True)}
    log(f"prefix {cfg.name} x{L}: 8 requests, 256-token shared preamble, "
        f"tails {[int(t) for t in tails]}: {hits} hits, "
        f"{stats[True]['prefix_shared_pages']} pages shared, chunks "
        f"{stats[False]['prefill_chunks']} -> "
        f"{stats[True]['prefill_chunks']}, K3 launches "
        f"{counts[False]['sparq_chunked_prefill_attn']} -> "
        f"{counts[True]['sparq_chunked_prefill_attn']}, prefill "
        f"{stats[False]['prefill_s']:.3f} s -> "
        f"{stats[True]['prefill_s']:.3f} s, decode steps "
        f"{stats[False]['decode_steps']} / {stats[True]['decode_steps']}; "
        f"tokens equal; launches off {counts[False]}, on {counts[True]}")
    del params
    torch.cuda.empty_cache()
    return {k: counts[False][k] + counts[True][k] for k in counts[True]}


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
    with WriteCapture() as cap:
        engine.generate(params, batch, gen, warmup=False)  # warm-up
    (toks, stats), counts = _drive(
        lambda: engine.generate(params, batch, gen, warmup=False))
    alone = cap.replay_alone(["CacheStore.update (prefill slab)",
                              "CacheStore.update (decode)"])
    assert toks.shape == (B, gen), toks.shape
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    # K4: two launches a layer at the prefill slab, one per decode step
    want = {"sparq_matmul": 7 * L * gen, "sparq_quant": L * (gen + 1),
            "sparq_decode_attn": L * (gen - 1), "sparq_paged_decode_attn": 0,
            "sparq_chunked_prefill_attn": 0, "sparq_dequant": 0}
    if counts != want:
        raise AssertionError(f"scan launches {counts}, expected {want}")
    caches = engine.last_caches
    planes, k6 = _drive(lambda: [st.kv() for st in caches])
    if k6["sparq_dequant"] != 2 * L or sum(k6.values()) != 2 * L:
        raise AssertionError(f"read-back launches {k6}, expected "
                             f"{2 * L} of sparq_dequant only")
    names = profiled_kernels(lambda: [st.kv() for st in caches])
    if len(names) != 2 * L or not all("sparq_dequant_kernel" in n
                                      for n in names):
        raise AssertionError(f"the read-back ran {len(names)} device "
                             f"kernels, expected {2 * L} K6 launches only")
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
        k4_alone=alone, readback_launches=k6, **stats)
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


# the oversubscribed, shared-prefix serve the CLI offers
CLI_PREEMPT_FLAGS = ["--preempt", "swap", "--oversubscribe", "0.5",
                     "--prefix-cache"]


def _family_cli_args(arch, tag):
    """CLI_ARGS for `arch`, reduced, with the registry and the trace
    written under the ignored build/ directory."""
    out = ROOT / "build" / "cli_telemetry"
    args = list(CLI_ARGS)
    args[args.index("--arch") + 1] = arch
    return args + ["--metrics-dump", str(out / f"{tag}.prom"),
                   "--trace-out", str(out / f"{tag}.trace.json")]


# the reduced granite-20b (MQA: K3 at hd 16, G 8, one KV head) and
# starcoder2-3b (the cli shape) through the CLI with its telemetry flags,
# by the K3_SHAPES case each drives
CLI_FAMILY = {"cli granite": _family_cli_args("granite-20b", "granite"),
              "cli": _family_cli_args("starcoder2-3b", "starcoder2")}


def _check_cli_telemetry(argv, stats):
    """The files `--metrics-dump` and `--trace-out` wrote: the dump parses
    back with the port's `parse_prometheus` to the stats dict's counts;
    the trace is JSON whose B/E spans balance, a track a request."""
    from repro_torch.obs import export
    arg = {f: argv[argv.index(f) + 1] for f in ("--metrics-dump",
                                                "--trace-out")}
    parsed = export.parse_prometheus(
        pathlib.Path(arg["--metrics-dump"]).read_text())
    for metric, key in (("engine_decode_steps_total", "decode_steps"),
                        ("engine_prefill_chunks_total", "prefill_chunks"),
                        ("pool_pages_peak", "peak_pages_used")):
        if parsed[(metric, "")] != stats[key]:
            raise AssertionError(f"{arg['--metrics-dump']}: {metric} "
                                 f"{parsed[(metric, '')]}, stats {key} "
                                 f"{stats[key]}")
    events = json.loads(pathlib.Path(arg["--trace-out"]).read_text())[
        "traceEvents"]
    depth = {}
    for e in events:
        if e["ph"] in "BE":
            depth[e["tid"]] = depth.get(e["tid"], 0) + (
                1 if e["ph"] == "B" else -1)
    if any(depth.values()) or len(depth) != len(stats["tokens"]):
        raise AssertionError(f"{arg['--trace-out']}: spans {depth}")
    return dict(prometheus_samples=len(parsed), trace_events=len(events))


def _cli(dev, results, name, argv, key=None):
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
    if "--metrics-dump" in argv:
        (ROOT / "build" / "cli_telemetry").mkdir(parents=True, exist_ok=True)
    stats, counts = _drive(lambda: serve.main(argv))
    toks = stats["tokens"]
    gen = 32                                  # the CLI's --gen default
    _check_requests(cfg, range(len(toks)), toks, gen)
    chunks, steps = stats["prefill_chunks"], stats["decode_steps"]
    want = {"sparq_chunked_prefill_attn": 2 * L * chunks,
            "sparq_paged_decode_attn": 2 * L * steps,
            "sparq_quant": 2 * L * (2 * chunks + steps),
            "sparq_decode_attn": 0, "sparq_dequant": 0}
    got = {k: counts[k] for k in want}
    if got != want or counts["sparq_matmul"] == 0 or chunks == 0:
        raise AssertionError(f"{name} launches {counts} (two runs of "
                             f"{chunks} chunks and {steps} steps), expected "
                             f"{want} and K1 > 0")
    telemetry = _check_cli_telemetry(argv, stats) \
        if "--metrics-dump" in argv else None
    results[key or name] = dict(
        argv=argv, arch=cfg.name, n_layers=L, head_dim=cfg.head_dim, G=G,
        k3_traits=tr._asdict(), launches=counts, telemetry=telemetry,
        **{k: v for k, v in stats.items() if not isinstance(v, dict)})
    log(f"{key or name} {' '.join(argv)}: {len(toks)} requests x {gen} "
        f"tokens | {stats['pool_pages']} pages, {stats['preemptions']} "
        f"preemptions, {stats['prefix_hits']} prefix hits | "
        f"prefill {stats['prefill_s']:.3f} s ({chunks} chunks) | decode "
        f"{stats['decode_tok_s']:.1f} tok/s | K3 {tr} | launches (warm-up + "
        f"timed run) {counts}")
    return counts


def cli_reduced(dev, results):
    """CLI_ARGS, then the same with CLI_PREEMPT_FLAGS (a pool of half the
    batch's pages, swap preemption, the prefix cache), then CLI_FAMILY
    (granite-20b and starcoder2-3b reduced, with --metrics-dump and
    --trace-out)."""
    runs = [_cli(dev, results, "cli", CLI_ARGS),
            _cli(dev, results, "cli", CLI_ARGS + CLI_PREEMPT_FLAGS,
                 key="cli_preempt")]
    for name, argv in CLI_FAMILY.items():
        runs.append(_cli(dev, results, name, argv,
                         key=f"cli_{_cli_config(argv).name}"))
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def cli_wide(dev, results):
    counts = _cli(dev, results, "wide", WIDE_ARGS)
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# path: the paper's PTQ of its CNN (K1 in its unsigned mode)
# ----------------------------------------------------------------------

# the cnn phase's STC batch: the sparse-tensor-core simulation rebuilds
# each conv's codes per output channel in chunks of 32 (stage 0: M * 32 *
# 288 int32 and a few temporaries of that size), so it takes one batch of
# 32 images where the dense codecs take 12 of 256
CNN_STC_BATCH = 32


def _logits(params, batches, cfg, ctx=None):
    from repro_torch.models import cnn
    return [cnn.forward(params, b["image"], cfg, ctx=ctx)[0]
            for b in batches]


def _compare(lq, lf, labels):
    """Top-1 agreement with the float logits, top-1 accuracy and the mean
    relative logit error (cnn_eval.logit_err's measure) over batches."""
    from repro_torch.launch.cnn_eval import relative_logit_err
    agree = sum(int((q.argmax(-1) == f.argmax(-1)).sum())
                for q, f in zip(lq, lf))
    right = sum(int((q.argmax(-1) == y).sum()) for q, y in zip(lq, labels))
    n = sum(q.shape[0] for q in lq)
    return dict(agree=agree / n, top1=right / n,
                logit_err=sum(relative_logit_err(q, f)
                              for q, f in zip(lq, lf)) / len(lq))


def cnn_full_width(dev, results):
    """paper-resnet at full width (width 32, stages (2, 2, 2), 32 x 32, 16
    classes), seeded and untrained: BatchNorm recalibrated and min-max
    site scales on 2 x 128 calibration images, then 3072 images at batch
    256 through every codec of Tables 1, 2 and 4 and Table 3's ACIQ A4W8,
    each conv but the stem through K1 (14 a forward). Gates: K1 launches
    exactly 14 x batches x codecs and no other kernel runs; on one batch a
    codec, the logits equal the plain K1's on the card; every logit is
    finite. Then Table 6's STC codecs on a 2:4-pruned copy (its BN
    recalibrated), one batch of CNN_STC_BATCH, with no kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.core.pruning import sparsity
    from repro_torch.core.sparq import SparqConfig
    from repro_torch.kernels import build, ops
    from repro_torch.launch import cnn_eval as ce
    t0 = time.perf_counter()
    cfg = get_config("paper-resnet")
    model = ce.init_model(cfg, device=dev)
    calib = ce.calib_batches(cfg, device=dev)
    scales = ce.calibrate_cnn(model, calib, device=dev)
    aciq = ce.aciq_scales(model, 4, calib, device=dev)
    evalb = ce.eval_batches(cfg, device=dev)
    params = model["params"]
    codecs = {name: (scales, c) for name, c in ce.PAPER_CODECS.items()}
    codecs["aciq_a4w8"] = (aciq, SparqConfig(enabled=False, act_bits=4))
    ctxs = {name: ce.quant_ctx(sc, c, device=dev)
            for name, (sc, c) in codecs.items()}
    lf = _logits(params, evalb, cfg)
    labels = [b["label"] for b in evalb]
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    def run():
        out = {}
        for name, ctx in ctxs.items():
            t = time.perf_counter()
            lq = _logits(params, evalb, cfg, ctx)
            torch.cuda.synchronize()
            out[name] = (lq, time.perf_counter() - t)
        return out
    out, counts = _drive(run)
    # quantized convs a forward: conv1 and conv2 of every block, and proj
    # where the width changes (14 at full width); the stem is never one
    sites = sum(2 * n + (si > 0) for si, n in enumerate(cfg.stages))
    assert len(scales) == sites, (sorted(scales), sites)
    want = sites * len(evalb) * len(ctxs)
    if counts["sparq_matmul"] != want or any(
            n for k, n in counts.items() if k != "sparq_matmul"):
        raise AssertionError(f"cnn: launches {counts}, expected "
                             f"sparq_matmul = {sites} x {len(evalb)} batches "
                             f"x {len(ctxs)} codecs = {want} and no other")
    rows = {}
    orig_route = ops._route
    ops._route = lambda t: "plain"        # K1's plain version, on the card
    try:
        build.reset_launch_counts()
        for name, ctx in ctxs.items():
            lq, secs = out[name]
            if not all(bool(torch.isfinite(q).all()) for q in lq):
                raise AssertionError(f"cnn {name}: non-finite logits")
            plain = _logits(params, evalb[:1], cfg, ctx)[0]
            if not torch.equal(plain, lq[0]):
                raise AssertionError(
                    f"cnn {name}: K1 logits differ from the plain version's "
                    f"(max abs {float((plain - lq[0]).abs().max())})")
            rows[name] = dict(**_compare(lq, lf, labels),
                              ms_per_batch=1e3 * secs / len(evalb))
            r = rows[name]
            log(f"cnn {name:13s}: == plain K1 on batch 0; agreement "
                f"{r['agree']:.4f}, logit_err {r['logit_err']:.5f}, top1 "
                f"{r['top1']:.4f}, {r['ms_per_batch']:.2f} ms a batch")
        if build.launch_counts()["sparq_matmul"]:
            raise AssertionError("cnn: the plain comparison launched K1")
    finally:
        ops._route = orig_route
    del out
    # Table 6: 2:4-pruned copy, STC simulation (plain PyTorch, no kernel)
    pruned = {"cfg": cfg, "params": ce.prune_cnn(params)}
    for stage in pruned["params"]["stages"]:
        for blk in stage:
            for k in ("w1", "w2", "proj"):
                if k in blk:
                    w = blk[k]
                    assert sparsity(w.reshape(-1, w.shape[-1])) == 0.5, k
    stc_scales = ce.calibrate_cnn(pruned, calib, device=dev)
    stc_b = ce.eval_batches(cfg, n=CNN_STC_BATCH, batch=CNN_STC_BATCH,
                            device=dev)
    lf_p = _logits(pruned["params"], stc_b, cfg)
    stc_ctxs = {name: ce.quant_ctx(stc_scales, c, stc=True, device=dev)
                for name, c in ce.STC_CODECS.items()}

    def run_stc():
        return {name: _logits(pruned["params"], stc_b, cfg, ctx)
                for name, ctx in stc_ctxs.items()}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    stc_out, stc_counts = _drive(run_stc)
    stc_s = time.perf_counter() - t
    if any(stc_counts.values()):
        raise AssertionError(f"cnn STC: kernels launched {stc_counts}")
    stc_rows = {}
    for name, lq in stc_out.items():
        if not all(bool(torch.isfinite(q).all()) for q in lq):
            raise AssertionError(f"cnn {name}: non-finite logits")
        stc_rows[name] = _compare(lq, lf_p, [b["label"] for b in stc_b])
        log(f"cnn {name:13s} (2:4-pruned, {CNN_STC_BATCH} images): "
            f"agreement {stc_rows[name]['agree']:.4f}, logit_err "
            f"{stc_rows[name]['logit_err']:.5f}")
    results["cnn"] = dict(
        arch=cfg.name, width=cfg.width, stages=list(cfg.stages),
        img=cfg.img_size, classes=cfg.num_classes,
        eval_images=sum(b["image"].shape[0] for b in evalb),
        batch=evalb[0]["image"].shape[0], calib_images=sum(b["image"].shape[0] for b in calib),
        setup_s=t_setup, launches=counts, codecs=rows,
        float_top1=_compare(lf, lf, labels)["top1"],
        stc=dict(batch=CNN_STC_BATCH, seconds=stc_s,
                 peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 codecs=stc_rows))
    log(f"cnn {cfg.name} width {cfg.width} stages {cfg.stages}: "
        f"{len(ctxs)} codecs x {len(evalb)} batches of "
        f"{evalb[0]['image'].shape[0]} | launches "
        f"{counts} | STC {len(stc_ctxs)} codecs in {stc_s:.1f} s")
    del model, params, pruned, evalb, calib, lf, lf_p, stc_out
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase: training (the LLM trainer, `repro_torch.launch.train`)
# ----------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "tinyllama-1.1b", "--steps", "10", "--batch", "8",
              "--seq", "128", "--log-every", "100", "--device", "cuda"]


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def train_card_vs_cpu(dev, results):
    """(a) A 2-layer full-width f32 tinyllama with the same weights and
    batches (2 x 64) on the card and on the CPU: 3 steps of
    `build_train_step` with `GradCompressor` and AdamW. The losses agree
    within 1e-4 relative, the parameters to `train_params_close`."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.distributed.collectives import GradCompressor
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    cfg = get_config("tinyllama-1.1b").replace(n_layers=2,
                                               dtype=torch.float32)
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                              global_batch=2, seed=2))
    opt = AdamW(lr=cosine_schedule(3e-4, 1, 3))
    gpu = Model(cfg, device=dev)
    p0 = gpu.init_params(seed=2)
    out = {}
    for name, model, params in (("cuda", gpu, p0),
                                ("cpu", Model(cfg, device="cpu"),
                                 _to_cpu(p0))):
        comp = GradCompressor()
        step = build_train_step(model, opt, comp)
        state, cstate = opt.init(params), comp.init(params)
        losses, lr_sum = [], 0.0
        t = time.perf_counter()
        for i in range(3):
            params, state, cstate, m = step(params, state, cstate,
                                            data.global_batch(i))
            losses.append(float(m["loss"]))
            lr_sum += float(m["lr"])
        out[name] = (losses, T.leaves(params), lr_sum,
                     time.perf_counter() - t)
        del state, cstate
    (lg, pg, lr_sum, sg), (lc, pc, _, sc) = out["cuda"], out["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    if rel > 1e-4:
        raise AssertionError(f"train card vs CPU: losses {lg} vs {lc}")
    close = train_params_close(pc, pg, lr_sum, "train card vs CPU")
    log(f"train (a) 2-layer full-width f32, 3 steps with GradCompressor: "
        f"losses card {lg} / CPU {lc} (max rel {rel:.2e}); params "
        f"{close} ({sum(p.numel() for p in pg)} elements); card "
        f"{sg:.1f} s, CPU {sc:.1f} s")
    results["train_parity"] = dict(losses_cuda=lg, losses_cpu=lc,
                                   loss_rel=rel, **close, cuda_s=sg,
                                   cpu_s=sc)
    del out, pg, pc, p0
    torch.cuda.empty_cache()


def train_restart_exact(dev, results):
    """(b) A 2-layer full-width tinyllama (bf16 compute), 4 steps straight
    through against 2 steps, a checkpoint (params, m, v) into a temporary
    directory, a restore and 2 more steps. Under deterministic algorithms
    (set here only, and undone) the resumed losses and final params equal
    the uninterrupted run's bit for bit."""
    import os
    import tempfile
    from repro_torch import tree as T
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        cfg = get_config("tinyllama-1.1b").replace(n_layers=2)
        model = Model(cfg, device=dev)
        opt = AdamW(lr=cosine_schedule(3e-4, 1, 4))
        step = build_train_step(model, opt)
        data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=2, seed=3))

        def run(params, state, steps):
            losses = []
            for i in steps:
                params, state, _, m = step(params, state, None,
                                           data.global_batch(i))
                losses.append(float(m["loss"]))
            return params, state, losses
        p0 = model.init_params(seed=3)
        p_full, _, full = run(p0, opt.init(p0), range(4))
        p_half, s_half, first = run(p0, opt.init(p0), range(2))
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 2, {"params": p_half, "m": s_half.m,
                             "v": s_half.v})
            del p_half, s_half
            tmpl = model.init_params(seed=4)
            blank = opt.init(tmpl)
            got = ckpt.restore(d, 2, {"params": tmpl, "m": blank.m,
                                      "v": blank.v}, dev)
        state = AdamWState(got["m"], got["v"], torch.tensor(
            2, dtype=torch.int32, device=dev))
        p_res, _, resumed = run(got["params"], state, range(2, 4))
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    if first != full[:2] or resumed != full[2:]:
        raise AssertionError(f"train restart: losses {first} + {resumed} "
                             f"vs uninterrupted {full}")
    for (path, a), b in zip(T.flatten_with_path(p_full), T.leaves(p_res)):
        if not torch.equal(a, b):
            raise AssertionError(f"train restart: {T.path_key(path)} "
                                 f"differs by {float((a - b).abs().max())}")
    log(f"train (b) 2-layer full-width restart at step 2 of 4: losses "
        f"{full} repeated bit for bit, params equal")
    results["train_restart"] = dict(losses=full)
    del p_full, p_res, got, p0
    torch.cuda.empty_cache()


def train_full_width(dev, results):
    """(a) and (b) above, then the main path: tinyllama-1.1b at full width
    and depth (22 layers, bf16 compute over f32 params, remat) through
    `launch.train.main`, batch 8 x 128, 10 steps, without and with
    --compress-grads. Gates: every loss and grad norm finite, the last
    loss below the first, and no kernel of the port launched (the
    reference's training path reaches no Pallas kernel). Logged: the
    median ms a step after the first, tokens/s, peak GB."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    n_layers = get_config(TRAIN_ARGS[1]).n_layers
    train_card_vs_cpu(dev, results)
    train_restart_exact(dev, results)

    def run():
        out = {}
        for name, extra in (("plain", []), ("compressed",
                                            ["--compress-grads"])):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            recs = []
            t = time.perf_counter()
            train.main(TRAIN_ARGS + extra, metrics=recs)
            torch.cuda.synchronize()
            out[name] = (recs, time.perf_counter() - t,
                         torch.cuda.max_memory_allocated() / 2 ** 30)
        return out
    out, counts = _drive(run)
    if any(counts.values()):
        raise AssertionError(f"train: kernels launched {counts}")
    batch, seq = int(TRAIN_ARGS[5]), int(TRAIN_ARGS[7])
    rows = {}
    for name, (recs, secs, peak) in out.items():
        losses = [r["loss"] for r in recs]
        norms = [r["grad_norm"] for r in recs]
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"train {name}: non-finite {recs}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train {name}: loss did not fall: "
                                 f"{losses}")
        ms = float(np.median([r["ms"] for r in recs[1:]]))
        rows[name] = dict(losses=losses, grad_norms=norms, step_ms=ms,
                          first_step_ms=recs[0]["ms"],
                          tokens_s=batch * seq / (ms / 1e3), peak_gb=peak,
                          seconds=secs)
        log(f"train {name:10s} {n_layers} layers, batch {batch} x {seq}: median "
            f"{ms:.1f} ms a step after the first ({recs[0]['ms']:.0f} ms), "
            f"{rows[name]['tokens_s']:.0f} tokens/s, peak {peak:.2f} GB; "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad norm "
            f"{norms[0]:.3f} -> {norms[-1]:.3f}")
    results["train"] = rows
    torch.cuda.empty_cache()
    return counts


def profile_train(dev, results):
    """(not a default phase) Where a full-width train step's time goes:
    tinyllama-1.1b, 22 layers, batch 8 x 128, the parts of a compressed
    step (forward + backward, compression, AdamW) each timed on the host
    clock between synchronizations over 3 steps after a warm-up; then one
    plain and one compressed `build_train_step` call under
    torch.profiler: wall ms, device busy ms, idle share, device kernels,
    and the ops with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.distributed.collectives import GradCompressor
    from repro_torch.launch.train import build_train_step, value_and_grad
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    cfg = get_config("tinyllama-1.1b")
    model = Model(cfg, device=dev)
    params = model.init_params(seed=0)
    opt, comp = AdamW(lr=cosine_schedule(3e-4, 1, 10)), GradCompressor()
    state, cstate = opt.init(params), comp.init(params)
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                              global_batch=8, seed=0))
    parts = {"forward+backward": [], "compress": [], "adamw": []}
    for i in range(4):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.global_batch(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, grads = value_and_grad(lambda p: model.loss(p, batch), params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads, cstate = comp.compress(grads, cstate)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, state, _ = opt.update(grads, state, params)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i:
            for k, a, b in (("forward+backward", t0, t1),
                            ("compress", t1, t2), ("adamw", t2, t3)):
                parts[k].append(1e3 * (b - a))
        del grads
    out = {"parts_ms": {k: float(np.median(v)) for k, v in parts.items()}}
    log(f"train profile, parts of a compressed step (median of 3, ms): "
        f"{out['parts_ms']}")
    for name, c in (("plain", None), ("compressed", comp)):
        step = build_train_step(model, opt, c)
        batch = data.global_batch(5)
        params, state, cstate, _ = step(params, state, cstate, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            params, state, cstate, _ = step(params, state, cstate, batch)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
        evs = device_kernels(prof)
        busy, end = 0.0, -math.inf
        for e in evs:
            s_, t_ = e.time_range.start, e.time_range.end
            if t_ > end:
                busy += (t_ - max(s_, end)) / 1e3
                end = t_
        ops = sorted(((a.key, a.self_device_time_total / 1e3, a.count)
                      for a in prof.key_averages()
                      if a.self_device_time_total > 0),
                     key=lambda r: -r[1])[:12]
        out[name] = dict(wall_ms=wall, device_busy_ms=busy,
                         idle_share=1 - busy / wall, device_kernels=len(evs),
                         top_ops_ms=ops)
        log(f"train profile {name}: wall {wall:.1f} ms, device busy "
            f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {len(evs)} "
            f"device kernels; top ops (ms, calls): "
            + "; ".join(f"{k} {ms:.1f} ({n})" for k, ms, n in ops))
    results["train_profile"] = out
    del params, state, cstate
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase: the CNN float trainer and the paper's quantizers on its network
# ----------------------------------------------------------------------

# tests/test_paper_claims.py's paired-evaluation margin
CLAIM_MARGIN = 0.012


def _paper_claims(top1, fp32, err, pruned):
    """The quantities of the reference's paper-claims tests, each beside
    its margin (findings, not gates: the port draws its own data)."""
    t = lambda name: top1[name]
    return {
        "T1 a8w8 top1 > fp32 - 0.01": (t("a8w8"), fp32 - 0.01),
        "T1 err(a8w4) > 4 err(a8w8)": (err["a8w4"], 4 * err["a8w8"]),
        "T1 err(5opt) < err(a8w4)": (err["5opt_R"], err["a8w4"]),
        "T1 a8w4 top1 > 0.85": (t("a8w4"), 0.85),
        "T2 5opt top1 > fp32 - 0.025": (t("5opt_R"), fp32 - 0.025),
        "T2 3opt top1 > fp32 - 0.025": (t("3opt_R"), fp32 - 0.025),
        **{f"T2 |{o}opt trim - fp32| < 0.08": (abs(t(f"{o}opt_trim") - fp32),
                                               0.08) for o in (5, 3, 2)},
        "T4 5opt >= 7opt - margin": (t("5opt_R"),
                                     t("2b_7opt") - CLAIM_MARGIN),
        "T4 7opt top1 > 0.5": (t("2b_7opt"), 0.5),
        "T4 7opt >= 7opt noVS - margin": (t("2b_7opt"),
                                          t("2b_7opt_noVS") - CLAIM_MARGIN),
        "T6 pruned top1 > 0.8": (pruned["top1"], 0.8),
        "T6 STC 5opt > pruned fp32 - 0.03": (pruned["stc_5opt_top1"],
                                             pruned["fp32_256"] - 0.03),
    }


def cnn_train_full(dev, results):
    """The paper's path on a trained network: `cnn_train.train_cnn()`
    (width 24, stages (1, 1, 1), 8 classes, 24 x 24; 420 steps of 96) and
    `train_cnn(prune_2_4=True)` (630 steps, 2:4 from step 157) on the card,
    then calibration (BN and min-max spans on one batch of 128, the
    reference's default) and 3072 images at batch 256 through the 16
    quantizers of Tables 1, 2 and 4 and ACIQ A4W8, each conv but the stem
    through K1 (unsigned); Table 6 on the pruned network: its A8W8 row
    (K1) and the STC rows on one batch of 256. Gates: float top-1 > 0.85
    and pruned top-1 > 0.80 with stage-0 w1 at sparsity 0.5 (the
    reference's thresholds for its trainer); K1 launched exactly sites x
    batches x quantized evaluations and no other kernel; K1's logits equal
    the plain K1's on batch 0 of every quantizer. The claims of
    tests/test_paper_claims.py are logged beside their margins."""
    from repro_torch.core.pruning import sparsity
    from repro_torch.core.sparq import SparqConfig
    from repro_torch.kernels import build, ops
    from repro_torch.launch import cnn_eval as ce
    from repro_torch.launch import cnn_train as ct

    def run():
        t0 = time.perf_counter()
        model = ct.train_cnn(device=dev)
        torch.cuda.synchronize()
        t_float = time.perf_counter() - t0
        pruned = ct.train_cnn(prune_2_4=True, device=dev)
        torch.cuda.synchronize()
        t_pruned = time.perf_counter() - t0 - t_float
        cfg = model["cfg"]
        calib = ce.calib_batches(cfg, 128, device=dev)
        evalb = ce.eval_batches(cfg, device=dev)
        scales = ce.calibrate_cnn(model, calib, device=dev)
        aciq = ce.aciq_scales(model, 4, calib, device=dev)
        codecs = {n: (scales, c) for n, c in ce.PAPER_CODECS.items()}
        codecs["aciq_a4w8"] = (aciq, SparqConfig(enabled=False, act_bits=4))
        ctxs = {n: ce.quant_ctx(sc, c, device=dev)
                for n, (sc, c) in codecs.items()}
        params = model["params"]
        lf = _logits(params, evalb, cfg)
        lq = {}
        for name, ctx in ctxs.items():
            t = time.perf_counter()
            lq[name] = (_logits(params, evalb, cfg, ctx),
                        time.perf_counter() - t)
        # Table 6: the pruned network, uncalibrated (as the reference
        # tests it), then calibrated for its A8W8 and STC rows
        p_top1 = ce.cnn_accuracy(pruned, batches=evalb, device=dev)
        stc_b = evalb[:1]
        stc_scales = ce.calibrate_cnn(pruned, calib, device=dev)
        p_lf = _logits(pruned["params"], stc_b, cfg)
        p_a8w8 = _logits(pruned["params"], stc_b, cfg, ce.quant_ctx(
            stc_scales, ce.PAPER_CODECS["a8w8"], device=dev))
        t = time.perf_counter()
        stc = {n: _logits(pruned["params"], stc_b, cfg, ce.quant_ctx(
            stc_scales, c, stc=True, device=dev))
            for n, c in ce.STC_CODECS.items()}
        t_stc = time.perf_counter() - t
        return dict(model=model, pruned=pruned, calib=calib, evalb=evalb,
                    ctxs=ctxs, lf=lf, lq=lq, p_top1=p_top1, p_lf=p_lf,
                    p_a8w8=p_a8w8, stc=stc, stc_b=stc_b,
                    stc_scales=stc_scales, t_float=t_float,
                    t_pruned=t_pruned, t_stc=t_stc)
    torch.cuda.reset_peak_memory_stats()
    out, counts = _drive(run)
    model, pruned, evalb = out["model"], out["pruned"], out["evalb"]
    cfg, params = model["cfg"], model["params"]
    sites = sum(2 * n + (si > 0) for si, n in enumerate(cfg.stages))
    want = sites * (len(evalb) * len(out["ctxs"]) + 1)
    if counts["sparq_matmul"] != want or any(
            n for k, n in counts.items() if k != "sparq_matmul"):
        raise AssertionError(f"cnn_train: launches {counts}, expected "
                             f"sparq_matmul = {sites} x ({len(evalb)} x "
                             f"{len(out['ctxs'])} + 1) = {want} and no "
                             f"other")
    labels = [b["label"] for b in evalb]
    fp32 = _compare(out["lf"], out["lf"], labels)["top1"]
    w = pruned["params"]["stages"][0][0]["w1"]
    w_sparsity = sparsity(w.reshape(-1, w.shape[-1]))
    log(f"cnn_train: float {len(model['losses'])} steps in "
        f"{out['t_float']:.1f} s (loss {model['losses'][0]:.4f} -> "
        f"{model['losses'][-1]:.2e}), 2:4 {len(pruned['losses'])} steps in "
        f"{out['t_pruned']:.1f} s; float top-1 {fp32:.4f}, pruned top-1 "
        f"{out['p_top1']:.4f} at stage-0 w1 sparsity {w_sparsity}")
    if not fp32 > 0.85:
        raise AssertionError(f"cnn_train: float top-1 {fp32} <= 0.85")
    if not (out["p_top1"] > 0.80 and w_sparsity == 0.5):
        raise AssertionError(f"cnn_train: pruned top-1 {out['p_top1']}, "
                             f"sparsity {w_sparsity}")
    rows = {}
    orig_route = ops._route
    ops._route = lambda t: "plain"        # K1's plain version, on the card
    try:
        build.reset_launch_counts()
        for name, ctx in out["ctxs"].items():
            lq, secs = out["lq"][name]
            if not all(bool(torch.isfinite(q).all()) for q in lq):
                raise AssertionError(f"cnn_train {name}: non-finite logits")
            plain = _logits(params, evalb[:1], cfg, ctx)[0]
            if not torch.equal(plain, lq[0]):
                raise AssertionError(
                    f"cnn_train {name}: K1 logits differ from the plain "
                    f"version's (max abs "
                    f"{float((plain - lq[0]).abs().max())})")
            r = _compare(lq, out["lf"], labels)
            rows[name] = dict(**r, delta=r["top1"] - fp32,
                              ms_per_batch=1e3 * secs / len(evalb))
            log(f"cnn_train {name:13s}: == plain K1 on batch 0; top-1 "
                f"{r['top1']:.4f} (delta {r['top1'] - fp32:+.4f}), "
                f"logit_err {r['logit_err']:.5f}, agreement "
                f"{r['agree']:.4f}, {rows[name]['ms_per_batch']:.2f} ms a "
                f"batch")
        plain = _logits(pruned["params"], out["stc_b"], cfg, ce.quant_ctx(
            out["stc_scales"], ce.PAPER_CODECS["a8w8"], device=dev))[0]
        if not torch.equal(plain, out["p_a8w8"][0]):
            raise AssertionError("cnn_train: pruned a8w8 K1 logits differ "
                                 "from the plain version's")
        if build.launch_counts()["sparq_matmul"]:
            raise AssertionError("cnn_train: the plain comparison launched "
                                 "K1")
    finally:
        ops._route = orig_route
    stc_labels = [b["label"] for b in out["stc_b"]]
    p_fp32 = _compare(out["p_lf"], out["p_lf"], stc_labels)["top1"]
    stc_rows = {"a8w8": _compare(out["p_a8w8"], out["p_lf"], stc_labels)}
    for name, lq in out["stc"].items():
        if not all(bool(torch.isfinite(q).all()) for q in lq):
            raise AssertionError(f"cnn_train {name}: non-finite logits")
        stc_rows[name] = _compare(lq, out["p_lf"], stc_labels)
    for name, r in stc_rows.items():
        r["delta"] = r["top1"] - p_fp32
        log(f"cnn_train T6 {name:12s} (2:4-pruned, 256 images): top-1 "
            f"{r['top1']:.4f} (delta {r['delta']:+.4f}), logit_err "
            f"{r['logit_err']:.5f}")
    claims = _paper_claims(
        {n: r["top1"] for n, r in rows.items()}, fp32,
        {n: r["logit_err"] for n, r in rows.items()},
        dict(top1=out["p_top1"], fp32_256=p_fp32,
             stc_5opt_top1=stc_rows["stc_4b_5opt"]["top1"]))
    for claim, (value, bound) in claims.items():
        log(f"cnn_train claim {claim}: {value:.5f} against {bound:.5f}")
    results["cnn_train"] = dict(
        arch=cfg.name, width=cfg.width, stages=list(cfg.stages),
        img=cfg.img_size, classes=cfg.num_classes,
        steps=len(model["losses"]), pruned_steps=len(pruned["losses"]),
        train_s=out["t_float"], pruned_train_s=out["t_pruned"],
        final_loss=model["losses"][-1], float_top1=fp32,
        pruned_top1=out["p_top1"], pruned_sparsity=w_sparsity,
        eval_images=sum(b["image"].shape[0] for b in evalb),
        launches=counts, codecs=rows,
        stc=dict(images=sum(b["image"].shape[0] for b in out["stc_b"]),
                 seconds=out["t_stc"], fp32_top1=p_fp32, codecs=stc_rows),
        claims={k: list(v) for k, v in claims.items()},
        peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    del out, model, pruned, params, evalb
    torch.cuda.empty_cache()
    return counts


# Device-time groups of the profile phase: the seven kernels by their
# __global__ names in csrc/ (K1's pre-pass and GEMM together), everything
# else (PyTorch's own kernels and copies) as "other".
KERNEL_GROUPS = (("sparq_matmul", "sparq_matmul_"),
                 ("sparq_paged_decode_attn", "paged_decode_kernel"),
                 ("sparq_chunked_prefill_attn", "chunked_prefill_kernel"),
                 ("sparq_quant", "sparq_quant_"),
                 ("sparq_decode_attn", "decode_attn_kernel"),
                 ("sparq_dequant", "sparq_dequant_kernel"))


# torch.cuda._sleep's kernel, queued at the start and at the end of every
# traced decode step and KV write: on the device timeline (one stream), the
# kernels between two markers are the step's or the write's, however they
# were launched. The host keeps the markers' order, so each device marker
# is matched to what it opened or closed.
MARK = "spin_kernel"
MARK_CYCLES = 1000
RANGES = ("decode_step", "kv_write")
WRITE_METHODS = ("update", "write_chunk")       # of PagedCacheStore


def device_kernels(prof):
    """A profile's device activities in time order, without the device
    copies of record_function ranges."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name not in RANGES
           and not getattr(e, "is_user_annotation", False)]
    return sorted(evs, key=lambda e: e.time_range.start)


def _ms(e):
    return (e.time_range.end - e.time_range.start) / 1e3


def range_kernels(prof, name):
    """The non-SPARQ device kernels the profiler attributes to the
    record_function ranges `name` through the CPU ops that launched them:
    (ranges, {(kernel, launching op): count})."""
    from torch.autograd import DeviceType
    n_ranges, seen = 0, {}
    for ev in prof.events():
        if ev.name != name or ev.device_type != DeviceType.CPU:
            continue
        n_ranges += 1
        todo = [ev]
        while todo:
            e = todo.pop()
            for k in e.kernels:
                if MARK not in k.name and not any(
                        sym in k.name for _, sym in KERNEL_GROUPS):
                    key = f"{k.name[:80]} <- {e.name}"
                    seen[key] = seen.get(key, 0) + 1
            todo.extend(e.cpu_children)
    return n_ranges, seen


def profile_summary(prof, wall_ms, marks):
    """Device time by group, busy time and idle share, device kernels per
    decode step, and each KV write's device kernels (K4 and others, by
    write method), all read between MARK kernels on the device timeline;
    `marks` lists what each marker opened or closed, in launch order. Also
    the kernels the profiler's CPU-side attribution puts in the kv_write
    ranges, for comparison."""
    evs = device_kernels(prof)
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    by_name, busy_ms, end = {}, 0.0, -math.inf
    n_marks = sum(MARK in e.name for e in evs)
    if n_marks != len(marks):
        raise AssertionError(f"the profile holds {n_marks} marker kernels "
                             f"of the {len(marks)} launched")
    it, open_ = iter(marks), []
    steps = step_n = 0
    step_ms = 0.0
    writes = []                            # [method, K4 kernels, others]
    others, write_ms = {}, 0.0
    for e in evs:
        if MARK in e.name:
            what = next(it)
            if open_ and open_[-1] == what:
                open_.pop()
            else:
                open_.append(what)
                steps += what == "decode_step"
                if what in WRITE_METHODS:
                    writes.append([what, 0, 0])
            continue
        s, t = e.time_range.start, e.time_range.end
        if t > end:                                # union of device spans
            busy_ms += (t - max(s, end)) / 1e3
            end = t
        g = next((g for g, sym in KERNEL_GROUPS if sym in e.name), "other")
        groups[g] += _ms(e)
        by_name[e.name] = by_name.get(e.name, 0.0) + _ms(e)
        if "decode_step" in open_:
            step_n += 1
            step_ms += _ms(e)
        if open_ and open_[-1] in WRITE_METHODS:
            write_ms += _ms(e)
            if "sparq_quant_" in e.name:
                writes[-1][1] += 1
            else:
                writes[-1][2] += 1
                others[e.name[:80]] = others.get(e.name[:80], 0) + 1
    shapes = {}                    # method -> {"K4 n + other m": writes}
    for meth, k4, other in writes:
        key = f"K4 {k4} + other {other}"
        shapes.setdefault(meth, {})
        shapes[meth][key] = shapes[meth].get(key, 0) + 1
    n_ranges, attributed = range_kernels(prof, "kv_write")
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms, device_ms_by_group=groups,
        top_kernels_ms=sorted(by_name.items(), key=lambda kv: -kv[1])[:12],
        device_kernels=len(evs) - n_marks, decode_steps=steps,
        kernels_per_decode_step=step_n / max(steps, 1),
        decode_step_device_ms=step_ms / max(steps, 1), kv_writes=len(writes),
        kv_write_kernels=sum(w[1] + w[2] for w in writes),
        kv_write_k4=sum(w[1] for w in writes),
        kv_write_other=others, kv_write_device_ms=write_ms,
        kv_write_shapes=shapes,
        kv_write_ranges=n_ranges, kv_write_range_attributed=attributed)


def traced_serve_run(engine, params, reqs):
    """One serve run under torch.profiler, every decode step and every KV
    write between two MARK kernels and in a named range. Returns
    (profile_summary, stats)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models.paging import PagedCacheStore
    step, orig, marks = engine._step, {}, []

    def traced(name, fn, what):
        def run(*a, **k):
            with record_function(name):
                torch.cuda._sleep(MARK_CYCLES)
                marks.append(what)
                out = fn(*a, **k)
                torch.cuda._sleep(MARK_CYCLES)
                marks.append(what)
                return out
        return run
    engine._step = traced("decode_step", step, "decode_step")
    for meth in WRITE_METHODS:
        orig[meth] = getattr(PagedCacheStore, meth)
        setattr(PagedCacheStore, meth, traced("kv_write", orig[meth], meth))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(MARK_CYCLES)        # the tracer is live
            marks.append("start")
            torch.cuda._sleep(MARK_CYCLES)
            marks.append("start")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, stats = engine.run(params, reqs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        engine._step = step
        for meth, fn in orig.items():
            setattr(PagedCacheStore, meth, fn)
    return profile_summary(prof, wall_ms, marks), stats


def profile_serve(dev, results):
    """The serve phase's workload once more under torch.profiler (warm):
    device time by kernel, grouped into the SPARQ kernels and the rest, the
    device's idle share of the run's wall time, the device kernels of a
    decode step and those of each KV write: every decode update must be
    one K4 launch and every chunk write two, with no other kernel."""
    cfg, engine, params, reqs, _, _, _ = _serve_setup(dev)
    L = cfg.n_layers
    engine.run(params, reqs)                       # warm-up, unprofiled
    torch.cuda.synchronize()
    r, stats = traced_serve_run(engine, params, reqs)
    r.update(decode_tok_s=stats["decode_tok_s"], prefill_s=stats["prefill_s"],
             prefill_chunks=stats["prefill_chunks"])
    results["profile"] = r
    log(f"profile: wall {r['wall_ms']:.1f} ms, device busy "
        f"{r['device_busy_ms']:.1f} ms (idle share {r['idle_share']:.3f}) | "
        f"device ms by group " + ", ".join(
            f"{g} {ms:.1f}" for g, ms in r["device_ms_by_group"].items()))
    log(f"profile: {r['device_kernels']} device kernels; "
        f"{r['decode_steps']} decode steps between markers (the engine "
        f"ran {stats['decode_steps']}), "
        f"{r['kernels_per_decode_step']:.1f} device kernels and "
        f"{r['decode_step_device_ms']:.3f} device ms a step; "
        f"{r['kv_writes']} KV writes, {r['kv_write_kernels']} device "
        f"kernels ({r['kv_write_k4']} K4, others {r['kv_write_other']}), "
        f"{r['kv_write_device_ms']:.2f} device ms; by write "
        f"{r['kv_write_shapes']}")
    log(f"profile: the profiler's CPU-side attribution puts in the "
        f"{r['kv_write_ranges']} kv_write ranges "
        f"{sum(r['kv_write_range_attributed'].values())} non-SPARQ kernels: "
        f"{r['kv_write_range_attributed']}")
    for name, ms in r["top_kernels_ms"]:
        log(f"profile:   {ms:9.2f} ms  {name[:100]}")
    want = {"update": {"K4 1 + other 0": L * stats["decode_steps"]},
            "write_chunk": {"K4 2 + other 0": L * stats["prefill_chunks"]}}
    if r["kv_write_shapes"] != want:
        raise AssertionError(f"KV writes on the device timeline "
                             f"{r['kv_write_shapes']}, expected {want}")


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

    def same(a, b, what):
        if not np.array_equal(a, b):
            raise AssertionError(f"parity, {what}: tokens differ: "
                                 f"{np.asarray(a).tolist()} vs "
                                 f"{np.asarray(b).tolist()}")

    out, wide, scan = {}, {}, {}
    for name, model, p, sc in (
            ("cuda", gpu, params, scales),
            ("cpu", Model(cfg, device="cpu"), _to_cpu(params),
             _to_cpu(scales))):
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
    parity_granite(dev, results)


def parity_granite(dev, results):
    """A 2-layer full-width f32 granite-20b (MQA, G 48, hd 128, LayerNorm,
    GELU, tied head) with the same weights on the card and on the CPU: the
    paged chunked engine gives equal greedy tokens on both."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.launch import serve
    from repro_torch.models.common import QuantCtx
    from repro_torch.models.model import Model
    from repro_torch.models.quantize import quantize_params
    cfg = get_config("granite-20b").replace(n_layers=2, dtype=torch.float32)
    codec = serve.SPARQ_PRESETS["5opt"]
    cc = serve.make_cache_config("sparq", codec)
    ctx = QuantCtx(mode="quantized", cfg=codec)
    gpu = Model(cfg, device=dev)
    params = gpu.init_params(seed=1)
    scales = gpu.calibrate(params, Batcher(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
        seed=1)).calib_batches(1))
    params = quantize_params(params, codec.weight_bits)
    rng = np.random.default_rng(1)
    reqs = [serve.Request(rng.integers(0, cfg.vocab_size, L), 8)
            for L in (40, 100, 20, 70)]
    out = {}
    for name, model, p, sc in (
            ("cuda", gpu, params, scales),
            ("cpu", Model(cfg, device="cpu"), _to_cpu(params),
             _to_cpu(scales))):
        out[name], _ = serve.ContinuousBatchingEngine(
            model, cc, ctx, sc, device=model.device, prefill="chunked",
            page_size=16, n_pages=40, max_active=3, max_seq_len=112,
            chunk_size=64, chunk_align=8).run(p, reqs)
    for rid in out["cpu"]:
        if not np.array_equal(out["cuda"][rid], out["cpu"][rid]):
            raise AssertionError(
                f"parity granite-20b, request {rid}: kernels "
                f"{out['cuda'][rid].tolist()} vs plain "
                f"{out['cpu'][rid].tolist()}")
    results["parity_granite"] = {str(r): out["cuda"][r].tolist()
                                 for r in out["cpu"]}
    log(f"parity 2-layer full-width f32 granite-20b: kernels == plain "
        f"versions on {len(reqs)} paged chunked requests "
        f"({sum(len(t) for t in out['cpu'].values())} tokens)")


# opcodes that must (True) or must not (False) appear in a kernel
# library's SASS: K1 runs on the integer tensor cores, with int8 codes
# (S8 x S8) and the paper's unsigned codes (U8 x S8), and dp4a is gone; K3
# runs on the f64 tensor cores
SASS_CHECKS = {"sparq_matmul.cu": {"IMMA": True, "IMMA.16832.S8.S8": True,
                                   "IMMA.16832.U8.S8": True,
                                   "IDP4A": False},
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
                    default="build,kernels,serve,preempt,prefix,scan,"
                            "sequential,dense_family,cli,wide,cnn,train,"
                            "cnn_train,parity")
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
                      check_f3, check_k6):
            check(dev, results)
    by_path = {}
    paths = (("serve", serve_full_width), ("preempt", preempt_full_width),
             ("prefix", prefix_full_width), ("scan", scan_full_width),
             ("sequential", sequential_full_width),
             ("dense_family", dense_family), ("cli", cli_reduced),
             ("wide", cli_wide), ("cnn", cnn_full_width),
             ("train", train_full_width), ("cnn_train", cnn_train_full))
    for name, run in paths:
        if name in phases:
            t0 = time.perf_counter()
            by_path[name] = run(dev, results)
            results[f"{name}_phase_s"] = time.perf_counter() - t0
            log(f"phase {name}: {results[f'{name}_phase_s']:.1f} s")
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
    if "train_profile" in phases:
        profile_train(dev, results)
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
