"""What bounds K3 on the card: three measurements that chip_smoke.py does
not make.

    python3 probes/k3_probe.py        # needs one CUDA card and nvcc

1. f64 tensor-core throughput by mma shape (probes/dmma_rate.cu): every SM
   runs 4 or 8 warps of 8 independent accumulator chains; TFLOP/s per shape.
2. K3's clocks by phase: a copy of csrc/sparq_chunked_prefill_attn.cu with
   clock64() read between its phases (prologue, wait for the tile's bytes,
   decode / widen, S = Q K^T, softmax and the pair exchanges, P V) runs on
   chip_smoke.py's timed layout; the slowest block's clocks, averaged over
   its warps, are printed per phase, beside the card's SM clock.
3. K3's error against its plain version and against an f64 evaluation
   (chip_smoke.k3_f64_reference), and the plain version's against the
   same, over four seeds of both chip_smoke.py layouts, with and without
   a window.

Builds into build/probes/. Prints a line per result and writes them all to
chiprun_out/k3_probe.json. Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "probes"
PHASES = ("prologue", "wait", "widen", "qk", "softmax", "pv")
MAX_BLOCKS = 1024


def nvcc(src: pathlib.Path, lib: pathlib.Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as b
    OUT.mkdir(parents=True, exist_ok=True)
    cmd = [b.nvcc_path(), *b.ARCH_FLAGS, *b.NVCC_FLAGS, "-Xptxas=-v", "-I",
           str(b.CSRC), "-o", str(lib), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{r.stdout}{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"ptxas {src.name}: {line.strip()}")
    return ctypes.CDLL(str(lib))


def dmma_rates():
    lib = nvcc(ROOT / "probes" / "dmma_rate.cu", OUT / "libdmma_rate.so")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flops = {"m8n8k4": 512, "m16n8k4": 1024, "m16n8k8": 2048}
    rows, iters = [], 4000
    for shape, (name, per) in enumerate(flops.items()):
        for warps in (4, 8):
            ms = ctypes.c_float()
            rc = lib.dmma_rate(shape, sms, 32 * warps, iters, ctypes.byref(ms))
            if rc:
                raise RuntimeError(f"dmma_rate {name}: CUDA error {rc}")
            tf = sms * warps * 8 * iters * per / (ms.value * 1e-3) / 1e12
            rows.append(dict(shape=name, warps_per_sm=warps, tflops=tf))
            cs.log(f"DMMA {name:8s} {warps} warps/SM, 8 chains a warp: "
                   f"{tf:.1f} TFLOP/s")
    return rows


def instrumented_source() -> str:
    """K3's source with clock64() phase timers; each warp's lane 0 writes
    its clocks per phase to g_prof[block][warp]."""
    from repro_torch.kernels.build import CSRC
    src = (CSRC / "sparq_chunked_prefill_attn.cu").read_text()
    tick = "{ long long n_ = clock64(); T[%d] += n_ - tc; tc = n_; }\n"
    edits = [
        ('#include "sparq_common.cuh"\n',
         '#include "sparq_common.cuh"\n__device__ long long g_prof['
         f'{MAX_BLOCKS} * 8 * 8];\n'),
        ("  const int qt = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;\n",
         "  const long long t0 = clock64();\n"
         "  const int qt = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;\n"),
        ("  const int nvisit = s_nvisit;\n",
         "  const int nvisit = s_nvisit;\n  long long T[8] = {0, 0, 0, 0, 0, "
         "0, 0, 0};\n  long long tc = clock64();\n  T[0] = tc - t0;\n"
         "  T[7] = nvisit;\n"),
        ("    __syncthreads();  // tile v landed; every warp is done with "
         "tile v - 1\n",
         "    __syncthreads();  // tile v landed; every warp is done with "
         "tile v - 1\n    " + tick % 1),
        ("    widen(v);\n    __syncthreads();\n",
         "    widen(v);\n    __syncthreads();\n    " + tick % 2),
        ("    // scores in f32 (rounded", "    " + tick % 3
         + "    // scores in f32 (rounded"),
        ("    // P V over all keys", "    " + tick % 4
         + "    // P V over all keys"),
        ("        acc[dt][i] = acc[dt][i] * corr[i >> 1] + "
         "static_cast<float>(o[dt][i]);\n  }\n",
         "        acc[dt][i] = acc[dt][i] * corr[i >> 1] + "
         "static_cast<float>(o[dt][i]);\n    " + tick % 5 + "  }\n"
         "  if (lane == 0) {\n    T[6] = clock64() - t0;\n"
         "    long long* d = g_prof + ((size_t)(blockIdx.y * gridDim.x + "
         "blockIdx.x) * WARPS + warp) * 8;\n"
         "    for (int i = 0; i < 8; ++i) d[i] = T[i];\n  }\n"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"K3 source changed: marker {old!r} not "
                               f"found once; update the probe")
        src = src.replace(old, new)
    return src + ("\nextern \"C\" int k3_prof_read(long long* host, int n) {\n"
                  "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                  "      host, g_prof, sizeof(long long) * n));\n}\n")


def _k3_caller(lib):
    from repro_torch.kernels import build as b
    from repro_torch.kernels import sparq_prefill_attn as pre
    fn = lib.sparq_chunked_prefill_attn_launch
    fn.argtypes = pre.KERNEL.argtypes
    fn.restype = ctypes.c_int

    def call(*a, window=0):
        q, kd, bt, ts = a[0], a[3], a[9], a[13]
        C, KV, G, hd = q.shape
        out = torch.empty_like(q)
        rc = fn(*[b.ptr(t) for t in a], b.ptr(out), C, KV, G, hd,
                kd.shape[1], bt.shape[1], C // ts.shape[0], window,
                float(hd ** -0.5), b.stream_ptr(q))
        if rc:
            raise RuntimeError(f"instrumented K3: CUDA error {rc}")
        return out
    return call


def phase_profile(dev):
    src = OUT / "k3_phases.cu"
    OUT.mkdir(parents=True, exist_ok=True)
    src.write_text(instrumented_source())
    lib = nvcc(src, OUT / "libk3_phases.so")
    args = cs.k3_case(torch.Generator(device=dev).manual_seed(3), dev,
                      "timed")
    call = _k3_caller(lib)
    call(*args)
    torch.cuda.synchronize()
    nt, KV = args[13].shape[0], args[0].shape[1]
    warps = 8
    n = nt * KV * warps * 8
    buf = (ctypes.c_longlong * n)()
    if lib.k3_prof_read(buf, n):
        raise RuntimeError("k3_prof_read failed")
    a = np.array(buf[:n], dtype=np.float64).reshape(KV, nt, warps, 8)
    total = a[..., 6].max(-1)
    h, qt = np.unravel_index(total.argmax(), total.shape)
    w = a[h, qt].mean(0)
    row = dict(block=dict(h=int(h), qt=int(qt)), visits=int(w[7]),
               total=float(w[6]),
               **{p: float(w[i]) for i, p in enumerate(PHASES)})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    row["sm_clock_after"] = smi
    cs.log(f"K3 phases, slowest block (KV head {h}, query tile {qt}, "
           f"{row['visits']} key tiles), clocks a warp: " + ", ".join(
               f"{p} {row[p]:.0f}" for p in PHASES)
           + f", total {row['total']:.0f} (SM clock, max: {smi})")
    return row


def error_study(dev):
    from repro_torch.kernels import sparq_prefill_attn as pre
    rows = []
    for layout in cs.K3_LAYOUTS:
        for seed in range(100, 104):
            args = cs.k3_case(torch.Generator(device=dev).manual_seed(seed),
                              dev, layout)
            for window in (0, cs.K3_WINDOW):
                got = pre.sparq_chunked_prefill_attn_cuda(*args,
                                                          window=window)
                want = pre.ref_sparq_chunked_prefill_attn(*args,
                                                          window=window)
                exact = cs.k3_f64_reference(*args, window=window)
                torch.cuda.synchronize()
                r = dict(layout=layout, seed=seed, window=window,
                         kernel_plain=float((got - want).abs().max()),
                         kernel_f64=float((got.double() - exact).abs().max()),
                         plain_f64=float((want.double() - exact).abs().max()),
                         max_out=float(exact.abs().max()))
                rows.append(r)
                cs.log(f"K3 error {layout:10s} seed {seed} window "
                       f"{window:2d}: kernel-plain {r['kernel_plain']:.2e}, "
                       f"kernel-f64 {r['kernel_f64']:.2e}, plain-f64 "
                       f"{r['plain_f64']:.2e} (max |out| "
                       f"{r['max_out']:.1f})")
    return rows


def main():
    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.smi_line()
    cs.log(f"card: {card}")
    results = dict(card=card, dmma=dmma_rates(), phases=phase_profile(dev),
                   errors=error_study(dev))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k3_probe.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
