"""What bounds K7 (the absorbed-MLA packed decode) on the card: clocks by
phase and time per call, for the kernel in the tree and, with --parent,
for an earlier source of it, at the mla phase's shape and at a long cache
at its last slot and early in decode.

    python3 probes/k7_probe.py                      # needs one card, nvcc
    python3 probes/k7_probe.py --parent OLD.cu      # also the earlier K7
    python3 probes/k7_probe.py --variant NAME=ALT.cu  # and another version
                                                    # of the cluster design

Two designs are known by their C entry point:
- "ticket": a block per (batch row, split of 32 keys), f64 products, the
  partials through a workspace and the last block of a row combining them
  (the entry point takes `ws` and `counters`);
- "cluster": a cluster of blocks per (batch row, 16 heads), each block an
  online softmax over a run of key tiles on bf16 tensor cores, the
  combine over distributed shared memory (`n_splits`).
  A --variant of it is launched through the tree's wrapper (its plan and
  checks) with the launch swapped for the variant's library.

For each source:
1. Time per call (chip_smoke.bench, CUDA events, input sets past the L2
   cache) at SHAPES, the sources in turns (a, b, b, a), and the max abs
   error against chip_smoke.mla_f64_reference (held to 1e-4).
2. Clocks by phase: a copy of the source with clock64() read by thread 0
   after a __syncthreads() at each phase boundary (the ticket design: q
   and the split's load and decode, scores, softmax, P V, the ticket, the
   last block's combine; the cluster design: at each `// probe: <phase>`
   comment of the source, summed over the block's tiles), %globaltimer at
   each block's start and end and its SM, built into build/probes/ and run
   once (after a warm run) on the timed inputs: per phase the median and
   the largest clocks over the blocks with live keys, the first-starting
   and last-ending block's clocks, the blocks' span on the global timer,
   and the SM clock.
3. Cluster capacity: the card's cudaOccupancyMaxActiveClusters for
   clusters of 1-16 of the kernel's blocks at each shape's widths
   (`sparq_mla_decode.cluster_capacity`, the kernel library's own query).

Prints a line per result and writes them all to chiprun_out/k7_probe.json.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# (B, H, r, dr, Tk, pos): the mla phase's scan decode at its last step and
# an 8K cache at deepseek-v2-lite's widths, full and early in decode
SHAPES = {"mla": (8, 16, 512, 64, 296, 287),
          "long": (8, 16, 512, 64, 8192, 8191),
          "long_pos300": (8, 16, 512, 64, 8192, 300)}
OUT = ROOT / "build" / "probes"
TICKET_PHASES = ("load", "scores", "softmax", "pv", "ticket", "combine")
EXTRA = 6  # per block after the phases: flag, live, start ns, end ns, SM,
#            total clocks

PROBE_MACROS = r"""
__device__ long long g_prof[1 << 18];
#define PROBE_BEGIN                                                        \
  long long acc_[NPH] = {0};                                               \
  long long prev_ = clock64(), t00_ = prev_;                               \
  unsigned long long gs_;                                                  \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gs_));
#define PROBE_MARK(k)                                                      \
  do {                                                                     \
    __syncthreads();                                                       \
    if (threadIdx.x == 0) {                                                \
      const long long t_ = clock64();                                      \
      acc_[k] += t_ - prev_;                                               \
      prev_ = t_;                                                          \
    }                                                                      \
  } while (0)
#define PROBE_END(flag, live)                                              \
  do {                                                                     \
    if (threadIdx.x == 0) {                                                \
      long long* r_ = g_prof + ((size_t)(blockIdx.z * gridDim.y +          \
                                         blockIdx.y) * gridDim.x +         \
                                blockIdx.x) * (NPH + 6);                   \
      unsigned long long ge_;                                              \
      unsigned sm_;                                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ge_));              \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                     \
      for (int i_ = 0; i_ < NPH; ++i_) r_[i_] = acc_[i_];                  \
      r_[NPH] = (flag);                                                    \
      r_[NPH + 1] = (live);                                                \
      r_[NPH + 2] = (long long)gs_;                                        \
      r_[NPH + 3] = (long long)ge_;                                        \
      r_[NPH + 4] = sm_;                                                   \
      r_[NPH + 5] = clock64() - t00_;                                      \
    }                                                                      \
  } while (0)
"""

READER = """
extern "C" int k7_prof_read(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof,
                                               sizeof(long long) * n));
}
"""


def design(src: str) -> str:
    return "ticket" if "void* counters" in src else "cluster"


def _ticket_edits():
    """(old, new) text edits of the ticket design's source."""
    return [
        ("  __shared__ int is_last;\n",
         "  __shared__ int is_last;\n  PROBE_BEGIN\n"),
        ("    __syncthreads();\n\n    // scores: a thread per key",
         "    PROBE_MARK(0);\n\n    // scores: a thread per key"),
        ("    __syncthreads();\n\n    // the split's softmax statistics",
         "    PROBE_MARK(1);\n\n    // the split's softmax statistics"),
        ("    __syncthreads();\n\n    // P V over the tile's first rank",
         "    PROBE_MARK(2);\n\n    // P V over the tile's first rank"),
        ("  // the last block of this batch row to arrive combines the",
         "  PROBE_MARK(3);\n  // the last block of this batch row to arrive "
         "combines the"),
        ("  if (!is_last) return;\n",
         "  PROBE_MARK(4);\n  if (!is_last) {\n    PROBE_END(0, nk > 0);\n"
         "    return;\n  }\n"),
        ("reinterpret_cast<float*>(smem_raw));\n}\n",
         "reinterpret_cast<float*>(smem_raw));\n  PROBE_MARK(5);\n"
         "  PROBE_END(1, nk > 0);\n}\n"),
    ]


def cluster_phases(src: str):
    """The cluster design's phases: its `// probe: <name>` comments, in
    order of first appearance."""
    names = []
    for n in re.findall(r"// probe: (\w+)", src):
        if n not in names and n not in ("begin", "end"):
            names.append(n)
    return tuple(names)


def instrument(src: str):
    """(instrumented source, phase names)."""
    kind = design(src)
    if kind == "ticket":
        phases = TICKET_PHASES
        for old, new in _ticket_edits():
            if src.count(old) != 1:
                raise RuntimeError(f"K7 source changed: marker {old!r} not "
                                   f"found once; update the probe")
            src = src.replace(old, new)
    else:
        phases = cluster_phases(src)
        for k, n in enumerate(phases):
            src = src.replace(f"// probe: {n}\n", f"PROBE_MARK({k});\n")
        src = src.replace("// probe: begin\n", "PROBE_BEGIN\n")
        src = re.sub(r"// probe: end (.*)\n", r"PROBE_END(\1);\n", src)
        if "PROBE_BEGIN" not in src or "PROBE_END" not in src:
            raise RuntimeError("K7 source has no `// probe: begin` / "
                               "`// probe: end` comments")
    head = f"#define NPH {len(phases)}\n" + PROBE_MACROS
    first = src.index("namespace {")
    return src[:first] + head + src[first:] + READER, phases


def build(src_text: str, name: str):
    from repro_torch.kernels import build as b
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(src_text)
    lib = OUT / f"lib{name}.so"
    r = subprocess.run([b.nvcc_path(), *b.ARCH_FLAGS, *b.NVCC_FLAGS, "-I",
                        str(b.CSRC), "-o", str(lib), str(src)],
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(lib))


class Ticket:
    """The ticket design, launched through its own C entry point."""
    KPS = 32

    def __init__(self, dll):
        fn = dll.sparq_mla_decode_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.fn = fn
        self.ws = {}

    def n_blocks(self, a):
        return a[0].shape[0] * -(-a[2].shape[1] // self.KPS)

    def __call__(self, *a, sm_scale):
        from repro_torch.kernels import build as b
        q_lat, q_pe, cd, cm, cs_, pd, pm, ps, pos = a
        B, H, r = q_lat.shape
        dr, Tk = q_pe.shape[2], cd.shape[1]
        ns = -(-Tk // self.KPS)
        key = (B, H, r, Tk)
        if key not in self.ws:
            self.ws[key] = (torch.empty(B * ns * H * (r + 2),
                                        device=q_lat.device),
                            torch.zeros(B, dtype=torch.int32,
                                        device=q_lat.device))
        ws, cnt = self.ws[key]
        out = torch.empty((B, H, r), device=q_lat.device)
        rc = self.fn(*(b.ptr(t) for t in (q_lat, q_pe, cd, cm, cs_, pd, pm,
                                          ps, pos, out, ws, cnt)),
                     B, H, r, dr, Tk, self.KPS, 1, float(sm_scale),
                     b.stream_ptr(q_lat))
        if rc:
            raise RuntimeError(f"ticket K7: CUDA error {rc}")
        return out


class Cluster:
    """The cluster design through the tree's wrapper, its launch swapped
    for `fn` when one is given (the instrumented copy)."""

    def __init__(self, fn=None):
        from repro_torch.kernels import sparq_mla_decode as k7
        self.k7, self.fn = k7, fn
        if fn is not None:
            fn.argtypes, fn.restype = k7.KERNEL.argtypes, ctypes.c_int

    def n_blocks(self, a):
        B, H, r = a[0].shape
        dr = a[1].shape[2]
        p = self.k7.plan(B, H, r, dr, a[2].shape[1],
                         self.k7.cluster_capacity(a[0].device, r, dr))
        return B * p.head_groups * p.n_splits

    def __call__(self, *a, sm_scale):
        if self.fn is None:
            return self.k7.sparq_mla_decode_cuda(*a, sm_scale=sm_scale)
        kern = self.k7.KERNEL
        launch = kern.launch

        def spy(*args):
            rc = self.fn(*args)
            if rc:
                raise RuntimeError(f"instrumented K7: CUDA error {rc}")
        kern.launch = spy
        try:
            return self.k7.sparq_mla_decode_cuda(*a, sm_scale=sm_scale)
        finally:
            kern.launch = launch


def runner(kind, dll=None):
    if kind == "ticket":
        return Ticket(dll)
    return Cluster(None if dll is None else dll.sparq_mla_decode_launch)


def phase_profile(label, src_text, args, sm):
    text, phases = instrument(src_text)
    dll = build(text, f"k7_{label}_phases")
    run = runner(design(src_text), dll)
    for _ in range(2):
        out = run(*args, sm_scale=sm)
    torch.cuda.synchronize()
    nrec = len(phases) + EXTRA
    nb = run.n_blocks(args)
    n = nb * nrec
    buf = (ctypes.c_longlong * n)()
    if dll.k7_prof_read(buf, n):
        raise RuntimeError("k7_prof_read failed")
    a = np.array(buf[:n], dtype=np.float64).reshape(nb, nrec)
    k = len(phases)
    live = a[a[:, k + 1] > 0]
    start, end = a[:, k + 2], a[:, k + 3]
    first, last = int(np.argmin(start)), int(np.argmax(end))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    flagged = a[a[:, k] > 0]
    row = dict(
        source=label, blocks=int(nb), live_blocks=int(len(live)),
        sms_used=int(len(np.unique(a[:, k + 4]))),
        span_ns=float(end.max() - start.min()),
        start_spread_ns=float(start.max() - start.min()),
        median={p: float(np.median(live[:, i])) for i, p in
                enumerate(phases)} if len(live) else {},
        max={p: float(live[:, i].max()) for i, p in enumerate(phases)}
        if len(live) else {},
        first_block=dict(zip(phases + ("total",),
                             map(float, list(a[first, :k]) +
                                 [a[first, k + 5]]))),
        last_block=dict(zip(phases + ("total",),
                            map(float, list(a[last, :k]) +
                                [a[last, k + 5]]))),
        flagged_blocks=int(len(flagged)),
        total_median=float(np.median(a[:, k + 5])),
        sm_clock_after=smi, out_finite=bool(torch.isfinite(out).all()))
    cs.log(f"  {label} phases over {row['live_blocks']} live of {nb} blocks "
           f"on {row['sms_used']} SMs, clocks median / max: " + ", ".join(
               f"{p} {row['median'].get(p, 0):.0f} / "
               f"{row['max'].get(p, 0):.0f}" for p in phases)
           + f"; first block {row['first_block']}; last block "
           f"{row['last_block']}; blocks span {row['span_ns'] / 1e3:.2f} us, "
           f"starts spread over {row['start_spread_ns'] / 1e3:.2f} us (SM "
           f"clock: {smi})")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier K7 source to probe beside "
                                     "the tree's")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FILE: another source of the cluster design")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as b
    from repro_torch.kernels import sparq_mla_decode as k7
    dev = torch.device("cuda")
    card = cs.smi_line()
    cs.log(f"card: {card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    b.build(["sparq_quant.cu", "sparq_mla_decode.cu"])
    tree = (b.CSRC / "sparq_mla_decode.cu").read_text()
    sources = {"tree": tree}
    if args.parent:
        sources["parent"] = pathlib.Path(args.parent).read_text()
    for v in args.variant:
        name, path = v.split("=", 1)
        sources[name] = pathlib.Path(path).read_text()
    runs = {}
    for label, text in sources.items():
        if label == "tree" and design(text) == "cluster":
            runs[label] = runner("cluster")
        else:
            runs[label] = runner(design(text), build(text, f"k7_{label}"))
    res = dict(card=card, shapes={})
    gen = torch.Generator(device=dev).manual_seed(34)
    for shape, (B, H, r, dr, Tk, pos) in SHAPES.items():
        sm = (128 + dr) ** -0.5
        sets = [cs.k7_case(gen, dev, B, H, r, dr, Tk, pos, True)
                for _ in range(cs.n_sets(B * Tk * (r + dr) * 2))]
        exact = cs.mla_f64_reference(*sets[0], sm)
        cap = k7.cluster_capacity(dev, r, dr)
        cs.log(f"max active clusters of K7 blocks at r {r}, dr {dr}: "
               + ", ".join(f"{n}: {v}" for n, v in cap.items()))
        row = dict(shape=dict(B=B, H=H, r=r, dr=dr, Tk=Tk, pos=pos),
                   capacity=cap, ms={}, f64_err={}, phases={})
        for label, run in runs.items():
            got = run(*sets[0], sm_scale=sm)
            torch.cuda.synchronize()
            err = float((got.double() - exact).abs().max())
            row["f64_err"][label] = err
            if err > 1e-4:
                raise AssertionError(f"{label} K7 at {shape}: max abs err "
                                     f"{err} against f64")
        order = list(runs) + list(runs)[::-1]      # a, b, b, a
        times = {k: [] for k in runs}
        for label in order:
            run = runs[label]
            times[label].append(cs.bench(
                lambda *a, run=run: run(*a, sm_scale=sm), sets, iters=200,
                warmup=10))
        row["ms"] = times
        cs.log(f"{shape} (B {B}, H {H}, r {r}, dr {dr}, Tk {Tk}, pos {pos}):"
               + "; ".join(f" {k} {v} ms, max abs err vs f64 "
                           f"{row['f64_err'][k]:.2e}" for k, v in
                           times.items()))
        for label, text in sources.items():
            row["phases"][label] = phase_profile(f"{label}_{shape}", text,
                                                 sets[0], sm)
        res["shapes"][shape] = row
        del sets, exact
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k7_probe.json").write_text(json.dumps(res, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
