"""What bounds K3 on the card: measurements that chip_smoke.py does not
make.

    python3 probes/k3_probe.py        # needs one CUDA card and nvcc
    python3 probes/k3_probe.py --parts phases,sweep

1. f64 tensor-core throughput by mma shape (probes/dmma_rate.cu): every SM
   runs 4 or 8 warps of 8 independent accumulator chains; TFLOP/s per shape.
2. K3's time at every chip_smoke.K3_TIMED shape (on the timed layout, or
   the long history at a 32-token chunk), by row groups a block (every
   instantiation of the shape's head dim), through the kernel's C entry
   point with the row groups given explicitly; the row k3_traits picks is
   marked.
3. K3's clocks by phase: a copy of csrc/sparq_chunked_prefill_attn.cu with
   clock64() read between its phases (prologue and walk, the wait for a
   decoded tile, S = Q K^T, softmax and the pair
   exchanges, P V and the output for the consumer warps; the wait for an
   emptied buffer and the decode for the producer warps) runs each
   K3_TIMED shape at the rule's choices; the slowest block's clocks,
   averaged over its consumer and its producer warps, are printed per
   phase, beside the card's SM clock.
4. K3's error against its plain version and against an f64 evaluation
   (chip_smoke.k3_f64_reference), and the plain version's against the
   same, over four seeds of both chip_smoke.py layouts, with and without
   a window, at hd 64 G 8 and hd 128 G 8.

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
PHASES = ("prologue", "wait", "decode", "qk", "softmax", "pv", "end")
MAX_BLOCKS = 2048
MAXW = 12  # warps a block at most: 8 consumers, 4 producers
NT = 9  # clock slots a warp: PHASES, total, visits


def nvcc(src: pathlib.Path, lib: pathlib.Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as b
    OUT.mkdir(parents=True, exist_ok=True)
    cmd = [b.nvcc_path(), *b.ARCH_FLAGS, *b.NVCC_FLAGS, "-Xptxas=-v", "-I",
           str(b.CSRC), "-o", str(lib), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
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
    its clocks per phase to g_prof[block][warp]. Consumer warps fill
    "wait" (for a decoded tile), "qk", "softmax", "pv" and "end" (the
    output); producer warps "wait" (for an emptied buffer) and "decode"."""
    from repro_torch.kernels.build import CSRC
    src = (CSRC / "sparq_chunked_prefill_attn.cu").read_text()
    tick = "{ long long n_ = clock64(); T[%d] += n_ - tc; tc = n_; }\n"
    dump = ("  if (lane == 0) {\n    T[7] = clock64() - t0;\n"
            "    long long* d_ = g_prof + (((size_t)blockIdx.z * gridDim.y + "
            "blockIdx.y) * gridDim.x + blockIdx.x) * MAXW * " + str(NT)
            + " + warp * " + str(NT) + ";\n"
            "    for (int i = 0; i < " + str(NT) + "; ++i) d_[i] = T[i];\n"
            "  }\n")
    edits = [
        ('#include "sparq_common.cuh"\n',
         '#include "sparq_common.cuh"\n#define MAXW ' + str(MAXW)
         + '\n__device__ long long g_prof[' + f'{MAX_BLOCKS} * MAXW * {NT}];\n'),
        ("  const int qt = blockIdx.x, h = blockIdx.y, rb = blockIdx.z;\n",
         "  const long long t0 = clock64();\n"
         "  const int qt = blockIdx.x, h = blockIdx.y, rb = blockIdx.z;\n"),
        ("  const int nvisit = s_nvisit;\n",
         "  const int nvisit = s_nvisit;\n  long long T[" + str(NT)
         + "] = {};\n  long long tc = clock64();\n  T[0] = tc - t0;\n"
         "  T[8] = nvisit;\n"),
        ("      if (k > 0) mbar_wait(&s_empty[b], (k - 1) & 1);\n",
         "      if (k > 0) mbar_wait(&s_empty[b], (k - 1) & 1);\n      "
         + tick % 1),
        ("      mbar_arrive(&s_full[b]);\n",
         "      " + tick % 2 + "      mbar_arrive(&s_full[b]);\n"),
        ("      if (v > 0) mbar_wait(&s_full[b], (k - b + 1) & 1);\n",
         "      if (v > 0) mbar_wait(&s_full[b], (k - b + 1) & 1);\n"
         "      " + tick % 1),
        ("      // scores in f32 (rounded", "      " + tick % 3
         + "      // scores in f32 (rounded"),
        ("      // P V over all keys", "      " + tick % 4
         + "      // P V over all keys"),
        ("      mbar_arrive(&s_empty[b]);  // done with buffer b\n",
         "      " + tick % 5 + "      mbar_arrive(&s_empty[b]);  // done with "
         "buffer b\n"),
        ("  }\n}\n\ntemplate <int HD, int NG>\nint launch(",
         "  }\n  " + tick % 6 + dump + "}\n\ntemplate <int HD, int NG>\n"
         "int launch("),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"K3 source changed: marker {old!r} not "
                               f"found once; update the probe")
        src = src.replace(old, new)
    return src + ("\nextern \"C\" int k3_prof_read(long long* host, int n) {\n"
                  "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                  "      host, g_prof, sizeof(long long) * n));\n}\n"
                  "extern \"C\" int k3_prof_clear() {\n"
                  "  static long long zero[" + str(MAX_BLOCKS * MAXW * NT)
                  + "];\n  return static_cast<int>(cudaMemcpyToSymbol(\n"
                  "      g_prof, zero, sizeof(zero)));\n}\n")


def _caller(lib):
    """K3's C entry point in `lib`, called with explicit row groups (the
    wrapper takes them from k3_traits)."""
    from repro_torch.kernels import build as b
    from repro_torch.kernels import sparq_prefill_attn as pre
    fn = lib.sparq_chunked_prefill_attn_launch
    fn.argtypes = pre.KERNEL.argtypes
    fn.restype = ctypes.c_int

    def call(*a, groups, window=0):
        q, kd, bt, ts = a[0], a[3], a[9], a[13]
        C, KV, G, hd = q.shape
        bq = C // ts.shape[0]
        tr = pre.k3_traits(hd, G, bq, kd.shape[1])
        out = torch.empty_like(q)
        rc = fn(*[b.ptr(t) for t in a], b.ptr(out), C, KV, G, hd,
                kd.shape[1], bt.shape[1], bq, window, tr.hd, groups,
                float(hd ** -0.5), b.stream_ptr(q))
        if rc:
            raise RuntimeError(f"K3 (groups {groups}): CUDA error {rc}")
        return out
    return call


def _shape_sets(dev, shape, n=None):
    """chip_smoke's timing inputs for a K3_TIMED shape."""
    KV, G, hd, ps, bq, _, C = cs.K3_SHAPES[shape][0]
    gen = torch.Generator(device=dev).manual_seed(3)
    kw = dict(KV=KV, G=G, hd=hd, ps=ps, bq=bq, C=C)
    n = n or cs.n_sets(4 * 41 * 16 * KV * hd)
    return [cs.k3_case(gen, dev, cs.k3_timed_layout(C), **kw)
            for _ in range(n)], kw


def _rule(shape):
    from repro_torch.kernels import sparq_prefill_attn as pre
    KV, G, hd, ps, bq, _, C = cs.K3_SHAPES[shape][0]
    return pre.k3_traits(hd, G, bq, ps)


def sweep(dev):
    """Time every row-group count at each timed shape."""
    from repro_torch.kernels import sparq_prefill_attn as pre
    from repro_torch.kernels import build as b
    pre.KERNEL._bind()
    lib = ctypes.CDLL(str(b._lib_path(pre.KERNEL.source)))
    call = _caller(lib)
    rows = []
    for shape in cs.K3_TIMED:
        sets, kw = _shape_sets(dev, shape)
        tr = _rule(shape)
        want = pre.ref_sparq_chunked_prefill_attn(*sets[0])
        for groups in pre.GROUPS[tr.hd]:
            got = call(*sets[0], groups=groups)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= cs.PLAIN_TOL:
                raise AssertionError(f"{shape} groups {groups}: max abs err "
                                     f"{err}")
            ms = cs.bench(lambda *a: call(*a, groups=groups), sets)
            chosen = groups == tr.rows // 16
            rows.append(dict(shape=shape, groups=groups, ms=ms, err=err,
                             rule=chosen))
            cs.log(f"K3 sweep {shape:18s} groups {groups}: {ms:.4f} ms (err "
                   f"vs plain {err:.1e})" + ("  <- rule" if chosen else ""))
    return rows


def phase_profile(dev):
    from repro_torch.kernels import sparq_prefill_attn as pre
    src = OUT / "k3_phases.cu"
    OUT.mkdir(parents=True, exist_ok=True)
    src.write_text(instrumented_source())
    lib = nvcc(src, OUT / "libk3_phases.so")
    call = _caller(lib)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rows = []
    for shape in cs.K3_TIMED:
        sets, _ = _shape_sets(dev, shape, n=1)
        tr = _rule(shape)
        if lib.k3_prof_clear():
            raise RuntimeError("k3_prof_clear failed")
        call(*sets[0], groups=tr.rows // 16)
        torch.cuda.synchronize()
        nt, KV = sets[0][13].shape[0], sets[0][0].shape[1]
        nblk = nt * KV * tr.row_blocks
        if nblk > MAX_BLOCKS:
            raise RuntimeError(f"{shape}: {nblk} blocks > {MAX_BLOCKS}")
        n = nblk * MAXW * NT
        buf = (ctypes.c_longlong * n)()
        if lib.k3_prof_read(buf, n):
            raise RuntimeError("k3_prof_read failed")
        a = np.array(buf[:n], dtype=np.float64).reshape(nblk, MAXW, NT)
        cw = tr.warps - pre.PRODUCER_WARPS
        cons, prod = a[:, :cw], a[:, cw:tr.warps]
        total = cons[..., 7].max(-1)
        blk = int(total.argmax())
        wc, wp = cons[blk].mean(0), prod[blk].mean(0)
        row = dict(shape=shape, traits=tr._asdict(),
                   block=blk, blocks_run=int((total > 0).sum()),
                   visits=int(wc[8]), total=float(wc[7]),
                   median_total=float(np.median(total[total > 0])),
                   consumers={p: float(wc[i]) for i, p in enumerate(PHASES)},
                   producers={p: float(wp[i]) for i, p in enumerate(PHASES)
                              if p in ("prologue", "wait", "decode")},
                   sm_clock_after=smi)
        rows.append(row)
        cs.log(f"K3 phases {shape}, slowest block {blk} "
               f"({row['visits']} key tiles; "
               f"{row['blocks_run']} blocks ran, median total "
               f"{row['median_total']:.0f}), clocks a consumer warp: "
               + ", ".join(f"{p} {v:.0f}" for p, v in row["consumers"].items())
               + "; a producer warp: "
               + ", ".join(f"{p} {v:.0f}" for p, v in row["producers"].items())
               + f"; total {row['total']:.0f} (SM clock, max: {smi})")
    return rows


def error_study(dev):
    from repro_torch.kernels import sparq_prefill_attn as pre
    rows = []
    for shape in ("hd 64 G 8", "hd 128 G 8"):
        KV, G, hd, ps, bq, _, C = cs.K3_SHAPES[shape][0]
        for layout in cs.k3_layouts(C, bq):
            for seed in range(100, 104):
                args = cs.k3_case(
                    torch.Generator(device=dev).manual_seed(seed), dev,
                    layout, KV=KV, G=G, hd=hd, ps=ps, bq=bq, C=C)
                for window in (0, cs.K3_WINDOW):
                    got = pre.sparq_chunked_prefill_attn_cuda(*args,
                                                              window=window)
                    want = pre.ref_sparq_chunked_prefill_attn(*args,
                                                              window=window)
                    exact = cs.k3_f64_reference(*args, window=window)
                    torch.cuda.synchronize()
                    r = dict(shape=shape, layout=layout, seed=seed,
                             window=window,
                             kernel_plain=float((got - want).abs().max()),
                             kernel_f64=float(
                                 (got.double() - exact).abs().max()),
                             plain_f64=float(
                                 (want.double() - exact).abs().max()),
                             max_out=float(exact.abs().max()))
                    rows.append(r)
                    cs.log(f"K3 error {shape} {layout:10s} seed {seed} "
                           f"window {window:2d}: kernel-plain "
                           f"{r['kernel_plain']:.2e}, kernel-f64 "
                           f"{r['kernel_f64']:.2e}, plain-f64 "
                           f"{r['plain_f64']:.2e} (max |out| "
                           f"{r['max_out']:.1f})")
    return rows


PARTS = {"dmma": lambda dev: dmma_rates(), "sweep": sweep,
         "phases": phase_profile, "errors": error_study}


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS))
    parts = ap.parse_args().parts.split(",")
    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.smi_line()
    cs.log(f"card: {card}")
    results = dict(card=card)
    for part in parts:
        results[part] = PARTS[part](dev)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k3_probe.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
