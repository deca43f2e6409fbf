"""What bounds K2 and K5 on the card: two measurements that chip_smoke.py
does not make.

    python3 probes/decode_probe.py     # needs one CUDA card and nvcc

1. Time by split size: for each SPLIT_KEYS in SPLITS
   (`kernels/sparq_decode_attn.py`: the wrappers pass the keys per split
   to the kernels, so one build serves every size), on chip_smoke.py's
   inputs: K2 at check_k2's slots, K5 at check_k5's shape with bk 128 (the
   scan path's tile) and bk 16 (the parity phase's). Per row: ms per call
   (chip_smoke.bench), the grid, the blocks with live keys, and the max
   abs error against chip_smoke's decode_f64_reference (held to 1e-4).
2. Clocks by phase: a copy of csrc/sparq_decode_common.cuh with clock64()
   read between its phases (finding the split's rows, loading and decoding
   its bytes, the tiles, storing the partial and taking the arrival
   ticket, the combine) and %globaltimer at each block's start and end,
   built with the two kernels' sources into build/probes/, runs once on
   K2's and K5's timed inputs: per phase the median and the largest clocks
   over the blocks with live keys, the combine's clocks in the last
   blocks, the blocks' span on the global timer beside the kernel's time
   per call, and the SM clock.

Prints a line per result and writes them all to
chiprun_out/decode_probe.json. Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SPLITS = (16, 32, 64, 128)
OUT = ROOT / "build" / "probes"
PHASES = ("rows", "load", "scores", "softmax", "pv", "arrive", "fence",
          "combine_ml", "combine_acc")
NP = len(PHASES)
NREC = NP + 5  # per block: the phases, is_last, start and end ns, SM, live


def instrumented_header() -> str:
    """The split-key body with a per-block record in g_prof: thread 0
    writes its clocks per phase, whether it combined, %globaltimer at its
    start and end, its SM and whether its split held a live key."""
    from repro_torch.kernels.build import CSRC
    src = (CSRC / "sparq_decode_common.cuh").read_text()
    rec = ("  if (tid == 0) {{\n"
           "    long long* r_ = g_prof + ((size_t)(blockIdx.z * gridDim.y + "
           "blockIdx.y) * gridDim.x + blockIdx.x) * {n};\n"
           "    unsigned long long ge_; unsigned sm_;\n"
           "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ge_));\n"
           "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm_));\n"
           f"    P[{NP}] = clock64();\n"
           f"    for (int i_ = 0; i_ < {NP}; ++i_) r_[i_] = P[i_ + 1] - P[i_];"
           "\n"
           f"    r_[{NP}] = {{last}}; r_[{NP + 1}] = (long long)g0_;\n"
           f"    r_[{NP + 2}] = (long long)ge_; r_[{NP + 3}] = sm_;\n"
           f"    r_[{NP + 4}] = any_;\n  }}}}\n")
    tick = "    __syncthreads();\n    P[%d] = clock64();\n"
    edits = [
        ("namespace splitkey {\n",
         "__device__ long long g_prof[1 << 20];\nnamespace splitkey {\n"),
        ("  __shared__ int is_last;\n",
         f"  __shared__ int is_last;\n  long long P[{NP + 1}];\n"
         "  unsigned long long g0_;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0_));\n"
         "  P[0] = clock64();\n"),
        ("  if (__syncthreads_or(any)) {\n",
         "  const int any_ = __syncthreads_or(any);\n  P[1] = clock64();\n"
         "  if (any_) {\n"),
        ("      // scores of every key of the chunk at once",
         tick % 2 + "      // scores of every key of the chunk at once"),
        ("      // the online-softmax updates of the chunk's units",
         tick % 3
         + "      // the online-softmax updates of the chunk's units"),
        ("      // P V of every live unit",
         tick % 4 + "      // P V of every live unit"),
        ("  } else {\n    for (int g = tid; g < G; g += THREADS) part[g] = "
         "-CUDART_INF_F;\n  }\n",
         tick % 5 + "  } else {\n    for (int g = tid; g < G; g += THREADS) "
         "part[g] = -CUDART_INF_F;\n    P[2] = P[3] = P[4] = P[5] = P[1];\n"
         "  }\n"),
        ("  __syncthreads();\n  if (!is_last) return;\n",
         "  __syncthreads();\n  P[6] = clock64();\n  if (!is_last) {\n"
         "    P[7] = P[8] = P[9] = P[6];\n"
         + rec.format(n=NREC, last=0) + "    return;\n  }\n"),
        ("  if (tid == 0) counters[bh] = 0;\n",
         "  if (tid == 0) counters[bh] = 0;\n  P[7] = clock64();\n"),
        ("          G, hd, n_splits, part_len);\n}\n",
         "          G, hd, n_splits, part_len, P[8]);\n  __syncthreads();\n"
         + rec.format(n=NREC, last=1) + "}\n"),
        # the combine's own split: warp 0's clock after its m / l pass
        ("                                        size_t part_len) {\n",
         "                                        size_t part_len,\n"
         "                                        long long& t_ml) {\n"),
        ("      float lf[2];\n",
         "      if (g == 0 && d0 == 0) t_ml = clock64();\n      float lf[2];\n"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"split-key body changed: marker {old!r} not "
                               f"found once; update the probe")
        src = src.replace(old, new)
    return src + ("\nextern \"C\" int decode_prof_read(long long* host, "
                  "int n) {\n  return static_cast<int>(cudaMemcpyFromSymbol("
                  "\n      host, g_prof, sizeof(long long) * n));\n}\n")


def instrumented(source: str, symbol: str, argtypes):
    """Build `source` (a kernel over the split-key body) against the
    instrumented body; returns (launch fn, read fn)."""
    from repro_torch.kernels import build as b
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "sparq_decode_common.cuh").write_text(instrumented_header())
    src = OUT / source
    shutil.copy(b.CSRC / source, src)
    lib = OUT / f"lib{src.stem}_phases.so"
    r = subprocess.run([b.nvcc_path(), *b.ARCH_FLAGS, *b.NVCC_FLAGS, "-I",
                        str(b.CSRC), "-o", str(lib), str(src)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    fn = getattr(dll, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn, dll.decode_prof_read


def phase_profile(name, kernel, source, symbol, args, bk):
    """Run the instrumented copy of `kernel`'s wrapper once (after a warm
    run) and summarize its blocks' records."""
    fn, read = instrumented(source, symbol, kernel.argtypes)
    launch = kernel.launch

    def spy(*a):
        rc = fn(*a)
        if rc:
            raise RuntimeError(f"instrumented {name}: CUDA error {rc}")
    kernel.launch = spy
    try:
        for _ in range(2):
            out = bk(*args)
        torch.cuda.synchronize()
    finally:
        kernel.launch = launch
    B, KV, G, hd = args[0].shape
    n_keys = args[7].shape[1] * (args[1].shape[1] if "K2" in name else 1)
    tile = args[1].shape[1] if "K2" in name else 128
    from repro_torch.kernels import sparq_decode_attn as dec
    NS = dec.split_geometry(n_keys, tile).n_splits
    n = B * KV * NS * NREC
    buf = (ctypes.c_longlong * n)()
    if read(buf, n):
        raise RuntimeError("decode_prof_read failed")
    a = np.array(buf[:n], dtype=np.float64).reshape(-1, NREC)
    live = a[a[:, NP + 4] > 0]
    last = a[a[:, NP] > 0]
    start, end = a[:, NP + 1], a[:, NP + 2]
    span_ns = end.max() - start.min()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    nb = PHASES.index("fence")   # phases of every block / of the last
    row = dict(case=name, blocks=int(len(a)), live_blocks=int(len(live)),
               span_ns=float(span_ns),
               sms_used=int(len(np.unique(a[:, NP + 3]))),
               start_spread_ns=float(start.max() - start.min()),
               sm_clock_after=smi,
               median={p: float(np.median(live[:, i]))
                       for i, p in enumerate(PHASES[:nb])},
               max={p: float(live[:, i].max())
                    for i, p in enumerate(PHASES[:nb])},
               last_median={p: float(np.median(last[:, nb + i]))
                            for i, p in enumerate(PHASES[nb:])},
               last_max={p: float(last[:, nb + i].max())
                         for i, p in enumerate(PHASES[nb:])},
               out_finite=bool(torch.isfinite(out).all()))
    cs.log(f"{name} phases over {row['live_blocks']} live of {row['blocks']} "
           f"blocks on {row['sms_used']} SMs, clocks median / max: "
           + ", ".join(f"{p} {row['median'][p]:.0f} / {row['max'][p]:.0f}"
                       for p in PHASES[:nb])
           + "; the last blocks: " + ", ".join(
               f"{p} {row['last_median'][p]:.0f} / {row['last_max'][p]:.0f}"
               for p in PHASES[nb:])
           + f"; blocks span {span_ns / 1e3:.2f} us on the global timer, "
           f"starts spread over {row['start_spread_ns'] / 1e3:.2f} us (SM "
           f"clock, max: {smi})")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import sparq_decode_attn as dec
    dev = torch.device("cuda")
    card = cs.smi_line()
    cs.log(f"card: {card}")
    build.build_all()
    gen = torch.Generator(device=dev).manual_seed(2)
    k2_sets = [cs.k2_case(gen, dev) for _ in range(4)]
    k5_sets = [cs.k5_case(gen, dev) for _ in range(4)]
    k2_exact = cs.decode_f64_reference(k2_sets[0][0],
                                       *cs.paged_keys(*k2_sets[0][1:]))
    k5_exact = cs.decode_f64_reference(k5_sets[0][0],
                                       *cs.contig_keys(*k5_sets[0][1:]))
    k2_live = dec.paged_live(k2_sets[0][7].cpu().numpy(), cs.K2_CURS, 16)
    k5_live = dec.contig_live(k5_sets[0][7].cpu().numpy(),
                              k5_sets[0][8].cpu().numpy())
    rows = []
    default = dec.SPLIT_KEYS
    try:
        for sk in SPLITS:
            dec.SPLIT_KEYS = sk
            cases = (("K2 check_k2", dec.sparq_paged_decode_attn_cuda,
                      k2_sets, k2_exact, k2_live, 16, 40 * 16),
                     ("K5 bk 128", lambda *a: dec.sparq_decode_attn_cuda(
                         *a, bk=128), k5_sets, k5_exact, k5_live, 128, 296),
                     ("K5 bk 16", lambda *a: dec.sparq_decode_attn_cuda(
                         *a, bk=16), k5_sets, k5_exact, k5_live, 16, 296))
            for name, fn, sets, exact, live, tile, n_keys in cases:
                got = fn(*sets[0])
                torch.cuda.synchronize()
                err = float((got.double() - exact).abs().max())
                if err > 1e-4:
                    raise AssertionError(f"{name}, SPLIT_KEYS {sk}: max abs "
                                         f"err {err} against f64")
                ms = cs.bench(fn, sets, iters=200, warmup=10)
                geo = dec.split_geometry(n_keys, tile)
                blocks = 4 * sum(len(p) for p in dec.split_plan(live, tile))
                rows.append(dict(case=name, split_keys=sk, ms=ms,
                                 grid=[8, 4, geo.n_splits],
                                 live_blocks=blocks, f64_err=err))
                cs.log(f"{name:12s} SPLIT_KEYS {sk:3d}: {ms:.4f} ms, grid "
                       f"8x4x{geo.n_splits}, {blocks} blocks with live "
                       f"keys, max abs err vs f64 {err:.2e}")
    finally:
        dec.SPLIT_KEYS = default
    phases = [
        phase_profile("K2 check_k2", dec.KERNEL, "sparq_paged_decode_attn.cu",
                      "sparq_paged_decode_attn_launch", k2_sets[0],
                      dec.sparq_paged_decode_attn_cuda),
        phase_profile("K5 bk 128", dec.CONTIG_KERNEL, "sparq_decode_attn.cu",
                      "sparq_decode_attn_launch", k5_sets[0],
                      lambda *a: dec.sparq_decode_attn_cuda(*a, bk=128))]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_probe.json").write_text(json.dumps(
        dict(card=card, rows=rows, phases=phases), indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
