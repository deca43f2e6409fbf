"""The MoE runs of `chip_smoke.py`'s train_sharded phase, measured apart:
deepseek-v2-lite-16b at full width cut to 2 layers, 8 x 128, both ranks
on the one card over gloo, against the trainer on one device in this
process.

    python3 probes/moe_sharded_probe.py [--parts alone,witness,flips,f32]

`alone`: the one-device run (4 steps), then E1 (mesh 1 x 2, 4 steps, a
checkpoint every 2) alone, then E2 (mesh 2 x 1, one step) alone, each
with its seconds, ms a step, each rank's peak GB and its relative
differences from one device. `witness`: the one-device run again with
the experts' outputs summed in f32 and rounded once (what expert
parallelism does over the model axis), then E1 (4 steps, one checkpoint
at the end) and E2 (one step) launched together, each held to both
one-device runs. `flips`: E1 (4 steps) recording the experts each token
is routed to at every MoE call, against the one-device run and the
witness recording the same: a step's count of tokens whose top-k set
differs. `f32`: the one-device run and E1 with the forward computed in
f32 (`cfg.dtype`) instead of bf16, 4 steps each, their differences and
routing flips. The E1 runs of `flips` and `f32` run one after the other
(together they overrun the card).
Prints the card's name and power limit first. Needs a card; writes
nothing but its temporary directory.

Under torchrun the script is also a rank's entry point: `--rank-entry
[--dtype float32] [--routes-out PATH] -- <trainer flags>` runs
`repro_torch.launch.train.main` with those changes.
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

STEPS = 4


def _rel(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


@contextlib.contextmanager
def _patched(dtype=None, routes=None, f32_combine=False):
    """The trainer with its forward in `dtype`, every MoE call's sorted
    top-k expert ids appended to `routes`, and with `f32_combine` the
    experts' outputs summed in f32 and rounded once."""
    from repro_torch.launch import train
    from repro_torch.models import moe
    get_config, route, combine = train.get_config, moe.route, moe.combine
    if dtype is not None:
        train.get_config = lambda name: get_config(name).replace(dtype=dtype)
    if routes is not None:
        def record(x2, router, k):
            got = route(x2, router, k)
            routes.append(torch.sort(got[3], -1)[0].to(torch.int16).cpu())
            return got
        moe.route = record
    if f32_combine:
        def combine_f32(out_buf, gate_vals, expert_ids, slot, kept,
                        first=0, acc_dtype=None):
            return combine(out_buf, gate_vals, expert_ids, slot, kept,
                           first, torch.float32).to(out_buf.dtype)
        moe.combine = combine_f32
    try:
        yield
    finally:
        train.get_config, moe.route, moe.combine = get_config, route, combine


def _one_device(steps, **kw):
    """`chip_smoke._one_device_runs` of the MoE model at `steps` steps,
    changed as `_patched(**kw)` says, with its smallest routing margin."""
    with _patched(**kw), cs.RoutingMargin() as spy:
        got = cs._drive(lambda: cs._one_device_runs(
            arch=cs.MOE_SHARDED_ARCH, steps=steps,
            kinds=(("plain", []),)))[0]["plain"]
    got["routing_margin"] = spy.margin
    return got


def _flips(got, want, steps):
    """Per step, the tokens whose top-k set differs between two runs'
    recorded MoE calls (the calls of a step: its microbatches' forwards
    and the remat recomputes), and the first call that differs."""
    if len(got) != len(want):
        return f"calls differ: {len(got)} vs {len(want)}"
    per = len(got) // steps
    diff = [int((a != b).any(-1).sum()) for a, b in zip(got, want)]
    first = next((i for i, d in enumerate(diff) if d), None)
    return {"tokens_flipped_a_step": [sum(diff[s * per:(s + 1) * per])
                                      for s in range(steps)],
            "calls_a_step": per, "tokens_a_call": int(got[0].shape[0]),
            "first_call_with_a_flip": first}


def _report(runs, done, refs):
    for run, (recs, out, secs) in zip(runs, done):
        cs._log_ranks(run[0], recs, secs)
        loss = [x["loss"] for x in recs[0]]
        norm = [x["grad_norm"] for x in recs[0]]
        for name, ref in refs.items():
            print(f"{run[0]} vs {name}: loss rel "
                  f"{_rel(loss, ref['losses'])}, grad norm rel "
                  f"{_rel(norm, ref['grad_norms'])}", flush=True)
        print(f"{run[0]}: {secs:.1f} s, ms a step "
              f"{[x['ms'] for x in recs[0]]}, peak GB a rank "
              f"{[max(x['peak_gb'] or 0.0 for x in r) for r in recs]}",
              flush=True)


def _launch(runs, tmp):
    """Launch `runs` (name, ranks, steps, trainer flags, probe flags)
    together, under torchrun; the trainer's entry point itself where the
    probe flags are empty, else this script's rank entry."""
    t = time.perf_counter()
    launched = []
    for name, nproc, steps, extra, probe in runs:
        if not probe:
            launched.append(cs._launch_ranks(
                name, nproc, extra, tmp, cs.SHARDED_LAYERS, steps, None,
                cs.MOE_SHARDED_ARCH))
            continue
        args = cs._sharded_args(cs.SHARDED_LAYERS, steps,
                                cs.MOE_SHARDED_ARCH) + [
            "--metrics-out", f"{tmp}/{name}.{{rank}}.jsonl"] + extra
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(nproc), str(pathlib.Path(__file__)),
               "--rank-entry"] + probe + ["--"] + args
        proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(
            os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        launched.append((name, nproc, tmp, proc, time.perf_counter()))
    try:
        done = [cs._collect_ranks(x) for x in launched]
    finally:
        for x in launched:
            cs._stop_ranks(x)
    print(f"launched together: {[r[0] for r in runs]} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return done


def rank_entry(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank-entry", action="store_true")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--routes-out", default=None)
    cut = argv.index("--")
    args = ap.parse_args(argv[:cut])
    from repro_torch.launch import train
    routes = [] if args.routes_out else None
    with _patched(getattr(torch, args.dtype) if args.dtype else None,
                  routes):
        train.main(argv[cut + 1:])
    if routes is not None and os.environ.get("RANK", "0") == "0":
        torch.save(routes, args.routes_out)
    return 0


def main():
    if "--rank-entry" in sys.argv:
        return rank_entry(sys.argv[1:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="alone,witness")
    parts = ap.parse_args().parts.split(",")
    if not torch.cuda.is_available():
        print("moe_sharded_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    routes = {"one device": [], "one device, f32 combine": [],
              "one device, f32 forward": []}
    one = _one_device(STEPS, routes=routes["one device"])
    print(f"one device: {one}", flush=True)
    refs = {"one device": one}
    mp, dp = ["--model-parallel", "2", "--share-cards"], ["--share-cards"]
    with tempfile.TemporaryDirectory() as tmp:
        if "alone" in parts:
            for run in (("E1_alone", 2, STEPS,
                         mp + ["--checkpoint-dir", f"{tmp}/E1a",
                               "--checkpoint-every", "2"], []),
                        ("E2_alone", 2, 1, dp, [])):
                _report([run], _launch([run], tmp), refs)
        if {"witness", "flips"} & set(parts):
            f32 = _one_device(STEPS, f32_combine=True,
                              routes=routes["one device, f32 combine"])
            refs["one device, f32 combine"] = f32
            print(f"one device, f32 combine: {f32}; loss rel to one "
                  f"device {_rel(f32['losses'], one['losses'])}; routing "
                  f"flips {_flips(routes['one device, f32 combine'], routes['one device'], STEPS)}",
                  flush=True)
        if "witness" in parts:
            runs = (("E1", 2, STEPS,
                     mp + ["--checkpoint-dir", f"{tmp}/E1w",
                           "--checkpoint-every", "4"], []),
                    ("E2", 2, 1, dp, []))
            _report(runs, _launch(runs, tmp), refs)
        runs = []
        if "flips" in parts:
            runs.append(("E1_routes", 2, STEPS, mp,
                         ["--routes-out", f"{tmp}/E1_routes.pt"]))
        if "f32" in parts:
            one32 = _one_device(STEPS, dtype=torch.float32,
                                routes=routes["one device, f32 forward"])
            print(f"one device, f32 forward: {one32}; routing flips "
                  f"against the bf16 run "
                  f"{_flips(routes['one device, f32 forward'], routes['one device'], STEPS)}",
                  flush=True)
            runs.append(("E1_f32", 2, STEPS, mp,
                         ["--dtype", "float32",
                          "--routes-out", f"{tmp}/E1_f32.pt"]))
        for run in runs:
            got = _launch([run], tmp)[0]
            f32run = run[0] == "E1_f32"
            ref = "one device, f32 forward" if f32run else "one device"
            want = {ref: one32 if f32run else one}
            if not f32run:
                want["one device, f32 combine"] = refs[
                    "one device, f32 combine"]
            _report([run], [got], want)
            mine = torch.load(f"{tmp}/{run[0]}.pt")
            for name in want:
                print(f"{run[0]} routing flips against {name}: "
                      f"{_flips(mine, routes[name], STEPS)}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
