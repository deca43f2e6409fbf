"""What streaming through the async front end costs a decode step.

    python3 probes/frontend_paired.py [--rounds N]

The serve phase of chip_smoke.py on the card (tinyllama-1.1b at full
width, 8 requests of 64-512 tokens, gen 32, page 16, chunk 256), warm;
then `--rounds` rounds of four runs in turns: "engine" (`engine.run` on
the wall clock with an `emit` that keeps each token's stamp, all on one
thread), "frontend" (`launch.frontend.play_trace` with every request at
0 and no warm-up: the same loop on a daemon thread, each token handed to
its asyncio stream), "frontend", "engine". Every run's tokens must equal
the first engine run's. Per run: ITL p50 / p99 (every gap between two
tokens of one request, pooled), TTFT p50 / p99 (from the run's start;
every request arrives then) and decode tok/s. Prints a line per run,
then one JSON line with each kind's runs, medians and quartiles. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def engine_run(engine, params, reqs):
    """engine.run on the wall clock with a stamping `emit`: (tokens,
    ttft list, itl list, decode tok/s)."""
    stamps = {}

    def emit(rid, tok, final, t):
        stamps.setdefault(rid, []).append((tok, t))
    _, stats = engine.run(params, reqs, emit=emit, clock_mode="wall")
    t0 = engine._t_origin
    toks = {rid: [k for k, _ in ev] for rid, ev in stamps.items()}
    ttft = [ev[0][1] - t0 for ev in stamps.values()]
    itl = [b[1] - a[1] for ev in stamps.values()
           for a, b in zip(ev, ev[1:])]
    return toks, ttft, itl, stats["decode_tok_s"]


def frontend_run(engine, params, reqs):
    """play_trace, every request at 0, no warm-up: the same four."""
    from repro_torch.launch import frontend
    out, slo, stats = frontend.play_trace(
        engine, params, [(r.tokens, r.gen, 0.0) for r in reqs])
    return ({rid: list(map(int, t)) for rid, t in out.items()},
            slo["ttft"], slo["itl"], stats["decode_tok_s"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("frontend_paired: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.launch import frontend
    from repro_torch.kernels import build
    build.build_all()
    dev = torch.device("cuda")
    cfg, model, params, scales, codec = cs._full_width(dev)
    reqs, lens, gen = cs._serve_requests(cfg)
    engine, _ = cs._serve_engine(model, codec, scales, dev, lens, gen)
    want = engine_run(engine, params, reqs)[0]       # warm-up, the oracle
    frontend_run(engine, params, reqs)               # warm-up
    runs = {"engine": [], "frontend": []}
    for r in range(args.rounds):
        for kind in ("engine", "frontend", "frontend", "engine"):
            if kind == "engine":
                toks, ttft, itl, tok_s = engine_run(engine, params, reqs)
                ttft, itl = frontend._pctl(ttft), frontend._pctl(itl)
            else:
                toks, ttft, itl, tok_s = frontend_run(engine, params, reqs)
            if toks != want:
                raise AssertionError(f"round {r} {kind}: tokens differ")
            row = dict(ttft_p50_ms=ttft["p50_ms"], ttft_p99_ms=ttft["p99_ms"],
                       itl_p50_ms=itl["p50_ms"], itl_p99_ms=itl["p99_ms"],
                       decode_tok_s=tok_s)
            runs[kind].append(row)
            print(f"round {r} {kind:8s}: ttft p50 {row['ttft_p50_ms']:.1f} "
                  f"p99 {row['ttft_p99_ms']:.1f} ms | itl p50 "
                  f"{row['itl_p50_ms']:.2f} p99 {row['itl_p99_ms']:.2f} ms | "
                  f"decode {tok_s:.1f} tok/s", flush=True)
    summary = {}
    for kind, rows in runs.items():
        summary[kind] = {}
        for key in rows[0]:
            vals = [x[key] for x in rows]
            q1, q2, q3 = np.percentile(vals, [25, 50, 75])
            summary[kind][key] = dict(median=float(q2), q1=float(q1),
                                      q3=float(q3))
    print(json.dumps({"card": cs.smi_line(),
                      "device": torch.cuda.get_device_name(0),
                      "rounds": args.rounds, "runs": runs,
                      "summary": summary,
                      "itl_p50_ratio": statistics.median(
                          x["itl_p50_ms"] for x in runs["frontend"])
                      / statistics.median(
                          x["itl_p50_ms"] for x in runs["engine"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
