"""The 22-layer dp-2 gap of the sharded trainer, measured apart:
tinyllama-1.1b at full width and all 22 layers, mesh 2 x 1 (dp 2, both
ranks on the one card over gloo), 4 steps of 8 x 128, against the
trainer on one device in this process, with the forward in bf16 (the
config's dtype) and again in f32 (`cfg.dtype`) on both sides.

    python3 probes/dp_depth_probe.py [--parts bf16,f32,state]

For each dtype: the one-device run's and the ranks' losses and grad
norms, their relative differences step by step, seconds and peak GB a
rank. `state`: chip_smoke's S2 and E1 runs (2 layers, mesh 1 x 2) for
one step each, their state a rank on the card against the dry run's
bytes (`chip_smoke._hold_state_bytes`). Prints the card's name and
power limit first. Needs a card; writes nothing but its temporary
directory.

Under torchrun the script is also a rank's entry point: `--rank-entry
--dtype float32 -- <trainer flags>` runs `repro_torch.launch.train.main`
with the forward in that dtype.
"""
import argparse
import contextlib
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

LAYERS, STEPS = 22, 4


def _rel(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


@contextlib.contextmanager
def _dtype(dtype):
    """The trainer with its forward in `dtype` (None: the config's)."""
    from repro_torch.launch import train
    get_config = train.get_config
    if dtype is not None:
        train.get_config = lambda name: get_config(name).replace(dtype=dtype)
    try:
        yield
    finally:
        train.get_config = get_config


def _one_device(dtype):
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recs = []
    t = time.perf_counter()
    with _dtype(dtype):
        train.main(cs._sharded_args(LAYERS, STEPS), metrics=recs)
    return {"losses": [x["loss"] for x in recs],
            "grad_norms": [x["grad_norm"] for x in recs],
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "seconds": time.perf_counter() - t}


def _dp2(name, dtype, tmp):
    args = cs._sharded_args(LAYERS, STEPS) + [
        "--metrics-out", f"{tmp}/{name}.{{rank}}.jsonl", "--share-cards"]
    probe = ["--dtype", str(dtype).split(".")[-1]] if dtype else []
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", str(pathlib.Path(__file__)),
           "--rank-entry"] + probe + ["--"] + args
    proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(
        os.environ, PYTHONPATH=str(ROOT / "src")), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    launched = (name, 2, tmp, proc, time.perf_counter())
    try:
        return cs._collect_ranks(launched)
    finally:
        cs._stop_ranks(launched)


def rank_entry(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank-entry", action="store_true")
    ap.add_argument("--dtype", default=None)
    cut = argv.index("--")
    args = ap.parse_args(argv[:cut])
    from repro_torch.launch import train
    with _dtype(getattr(torch, args.dtype) if args.dtype else None):
        train.main(argv[cut + 1:])
    return 0


def _state(tmp):
    """S2 and E1 for one step each; their state a rank against the dry
    run's bytes."""
    for name, arch in (("S2", "tinyllama-1.1b"), ("E1", cs.MOE_SHARDED_ARCH)):
        launched = cs._launch_ranks(
            name, 2, ["--model-parallel", "2", "--share-cards"], tmp,
            cs.SHARDED_LAYERS, 1, None, arch)
        recs, _, secs = cs._collect_ranks(launched)
        print(f"{name}: {secs:.1f} s, {cs._hold_state_bytes(name, recs, arch, cs.SHARDED_LAYERS, (1, 2))}",
              flush=True)


def main():
    if "--rank-entry" in sys.argv:
        return rank_entry(sys.argv[1:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="bf16,f32,state")
    parts = ap.parse_args().parts.split(",")
    if not torch.cuda.is_available():
        print("dp_depth_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for part, dtype in (("bf16", None), ("f32", torch.float32)):
            if part not in parts:
                continue
            one = _one_device(dtype)
            print(f"one device, {part} forward: {one}", flush=True)
            recs, _, secs = _dp2(f"dp2_{part}", dtype, tmp)
            loss = [x["loss"] for x in recs[0]]
            norm = [x["grad_norm"] for x in recs[0]]
            same = all([x["loss"] for x in r] == loss for r in recs)
            print(f"dp2 {part} forward: losses {loss}, grad norms {norm}, "
                  f"ranks equal {same}, {secs:.1f} s, ms a step "
                  f"{[x['ms'] for x in recs[0]]}, peak GB a rank "
                  f"{[max(x['peak_gb'] or 0.0 for x in r) for r in recs]}",
                  flush=True)
            print(f"dp2 vs one device, {part} forward: loss rel "
                  f"{_rel(loss, one['losses'])}, grad norm rel "
                  f"{_rel(norm, one['grad_norms'])}", flush=True)
        if "state" in parts:
            _state(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
