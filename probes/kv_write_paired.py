"""One layer's KV writes in two trees, on one card, in turns.

    python3 probes/kv_write_paired.py PARENT_DIR [CHANGE_DIR] [--rounds N]
        [--parts write,profile]

PARENT_DIR and CHANGE_DIR (default: this tree) are roots of checkouts of
the repository (e.g. a `git archive` of the parent commit unpacked into a
directory that .gitignore lists). Each turn runs one subprocess in one
tree, which imports that tree's `repro_torch` and builds its kernels.

write    (turns parent, change, change, parent, N rounds) times one
         layer's writes through the store API the model calls, at the
         serve and scan shapes (tinyllama-1.1b: 4 KV heads, hd 64, bf16
         K/V, 5opt): `PagedCacheStore.update` (8 slots, page 16) and
         `write_chunk` (a 256-token chunk over 8 slots), `CacheStore.update`
         at decode (8 x 1 into 296 slots) and at the prefill slab (8 x
         256), and K4's rows mode (`ops.sparq_quantize`, 8192 x 64 f32,
         one scale). For each: the host clock over 200 calls without a
         sync (the dispatch rate), the device time per call from CUDA
         events (50 calls queued behind a `torch.cuda._sleep`, so host
         gaps do not count), and the device kernels per call from
         torch.profiler.
profile  (turns parent, change) the serve workload of chip_smoke.py
         (`_serve_setup`: full width, 8 requests, chunked prefill) once
         warm, then once under torch.profiler with every decode step and
         every KV write in a named range (`chip_smoke.traced_serve_run` of
         this tree, driving the turn's tree): device kernels per decode
         step, the KV writes' kernels and device time, the "other" group.

Prints a line per turn and one JSON line with every number. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]

WRITE = r"""
import json, sys, time, torch
sys.path.insert(0, "src")
from repro_torch.core.sparq import SparqConfig
from repro_torch.kernels import build, ops
from repro_torch.models.cache import CacheConfig, CacheStore
from repro_torch.models.paging import ChunkMeta, PagedCacheStore
build.build_all()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(7)
cc = CacheConfig.sparq_cache(SparqConfig.opt5(signed=True))
S, KV, hd, ps, NB = 8, 4, 64, 16, 34
bf = torch.bfloat16
i32 = dict(dtype=torch.int32, device=dev)


def kv(*shape):
    return [torch.randn(shape, generator=gen, device=dev).to(bf)
            for _ in range(2)]


def paged():
    st = PagedCacheStore.init(S, S * NB, ps, NB, KV, hd, cc, dev)
    st.block_table = torch.arange(S * NB, **i32).reshape(S, NB)
    st.seq_pos = torch.full((S,), 300, **i32)
    st.k_scale.fill_(0.02)
    st.v_scale.fill_(0.03)
    return st


dec, x_dec = paged(), kv(S, 1, KV, hd)
chk, x_chk = paged(), kv(256, KV, hd)
sid = torch.arange(256, device=dev).div(32, rounding_mode="floor").to(
    torch.int32)
pos = torch.arange(256, **i32) % 32
meta = ChunkMeta(sid, pos, torch.zeros(256, **i32),
                 torch.zeros(32, **i32), torch.full((S,), 32, **i32))
c_dec = CacheStore.init((8, 296, KV, hd), cc, dev)
c_dec.update(*kv(8, 256, KV, hd))            # calibrates the planes
c_pre, x_pre = CacheStore.init((8, 296, KV, hd), cc, dev), kv(8, 256, KV, hd)
x_rows = torch.randn((8192, 64), generator=gen, device=dev)
a_rows = torch.full((1,), 0.02, device=dev)
cases = {
    "rows 8192": lambda: ops.sparq_quantize(x_rows, a_rows, cc.sparq),
    "paged update": lambda: dec.update(*x_dec),
    "write_chunk": lambda: chk.write_chunk(*x_chk, meta),
    "contiguous decode": (lambda x: lambda: c_dec.update(*x))(kv(8, 1, KV,
                                                                 hd)),
    "contiguous prefill": lambda: c_pre.update(*x_pre),
}
out = {}
for name, fn in cases.items():
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda._sleep(int(max(1e8, 8e6 * host_ms * 50)))
    start.record()
    for _ in range(50):
        fn()
    end.record()
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / 50
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    kernels = sum(e.device_type == DeviceType.CUDA
                  for e in prof.events()) / 10
    out[name] = dict(host_ms=host_ms, device_ms=dev_ms, kernels=kernels)
print(json.dumps(out))
"""

PROFILE = r"""
import json, sys, torch
sys.path.insert(0, "src")
import repro_torch                      # this tree's package, first
sys.path.insert(1, HERE)
import chip_smoke as cs
dev = torch.device("cuda")
from repro_torch.kernels import build
build.build_all()
_, engine, params, reqs, _, _, _ = cs._serve_setup(dev)
engine.run(params, reqs)
torch.cuda.synchronize()
r, stats = cs.traced_serve_run(engine, params, reqs)
r.update(decode_tok_s=stats["decode_tok_s"], prefill_s=stats["prefill_s"])
print(json.dumps(r))
"""


def turn(tree: pathlib.Path, script: str):
    script = script.replace("HERE", repr(str(HERE)))
    r = subprocess.run([sys.executable, "-c", script],
                       cwd=tree, capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"turn in {tree} failed:\n{r.stdout}{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=str(HERE))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts", default="write,profile")
    args = ap.parse_args()
    trees = {"parent": pathlib.Path(args.parent).resolve(),
             "change": pathlib.Path(args.change).resolve()}
    parts = args.parts.split(",")
    res = {"write": {"parent": [], "change": []}, "profile": {}}
    if "write" in parts:
        for _ in range(args.rounds):
            for name in ("parent", "change", "change", "parent"):
                r = turn(trees[name], WRITE)
                res["write"][name].append(r)
                print(f"{name}: " + " | ".join(
                    f"{w} host {v['host_ms']:.4f} ms, device "
                    f"{v['device_ms']:.4f} ms, {v['kernels']:.1f} kernels"
                    for w, v in r.items()), flush=True)
    if "profile" in parts:
        for name in ("parent", "change"):
            r = turn(trees[name], PROFILE)
            res["profile"][name] = r
            print(f"{name} profile: {r['kernels_per_decode_step']:.1f} "
                  f"device kernels a decode step "
                  f"({r['decode_step_device_ms']:.3f} device ms); KV writes "
                  f"{r['kv_writes']}, {r['kv_write_kernels']} kernels, "
                  f"{r['kv_write_device_ms']:.2f} device ms; other "
                  f"{r['device_ms_by_group']['other']:.1f} ms; "
                  f"{r['device_kernels']} kernels; wall {r['wall_ms']:.0f} "
                  f"ms", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
