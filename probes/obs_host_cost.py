"""What the paged engine's telemetry costs, by level.

    python3 probes/obs_host_cost.py [--parts profile,wall] [--device D]
        [--rounds N]

Levels: "counters" (the default `Telemetry()`), "metrics" (
`Telemetry.metrics_only()`: phase histograms too), "tracing"
(`Telemetry.tracing()`: spans and a snapshot a step).

profile  the reduced tinyllama (8 requests of 16-63 tokens, gen 32, page
         16, chunk 64) on `--device` (default cpu), once warm, then
         `--rounds` runs under cProfile per level: the profiler's
         cumulative time (callees included) of the calls the engine makes
         into its telemetry (the spans' methods, the metric series'
         methods, the engine's per-step `_snapshot` and `note_pages`),
         per decode step. cProfile slows every Python call it sees, so
         these are upper bounds of the host work; the device is not
         measured.
wall     (on the card) the serve phase of chip_smoke.py (tinyllama-1.1b
         at full width, 8 requests of 64-512 tokens, gen 32, page 16,
         chunk 256), one engine per level, each warm; then `--rounds`
         rounds, each running every level once in a rotated order, and
         "tracing, gc off" (the collector disabled over the run): each
         run's wall time (`run_s`, host clock around synced work).

Prints a line per run and one JSON line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import json
import pathlib
import pstats
import statistics
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# the engine's entry points into its telemetry, by file: the spans'
# methods (`EngineSpans`; the `Tracer` calls are inside them), the series'
# methods, and the engine's own per-step telemetry helpers
ENTRY = {"tracing.py": {"submitted", "admitted", "chunk", "first_token",
                        "decoding", "token", "preempted", "swap",
                        "resume_work", "resumed", "finished", "step",
                        "snapshot", "run_begin", "run_end"},
         "metrics.py": {"inc", "set", "set_max", "observe", "value"},
         "serve.py": {"_snapshot", "note_pages"}}


def levels():
    from repro_torch.obs import Telemetry
    return {"counters": Telemetry, "metrics": Telemetry.metrics_only,
            "tracing": Telemetry.tracing}


def telemetry_seconds(profile: cProfile.Profile):
    """(seconds, calls) of the telemetry entry points, callees included."""
    secs, calls = 0.0, 0
    for (path, _, func), (_, n, _, ct, _) in pstats.Stats(
            profile).stats.items():
        if func in ENTRY.get(pathlib.Path(path).name, ()):
            secs += ct
            calls += n
    return secs, calls


def profile_part(device, rounds):
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    torch.set_num_threads(2)
    cfg = get_reduced_config("tinyllama-1.1b")
    model = Model(cfg, device=device)
    params = model.init_params(0)
    codec = serve.SPARQ_PRESETS["5opt"]
    rng = np.random.default_rng(0)
    reqs = [serve.Request(rng.integers(0, cfg.vocab_size, int(L)), 32)
            for L in rng.integers(16, 64, 8)]
    out = {}
    for level, make in levels().items():
        engine = serve.ContinuousBatchingEngine(
            model, serve.make_cache_config("sparq", codec), device=device,
            page_size=16, n_pages=64, max_active=8, max_seq_len=96,
            prefill="chunked", chunk_size=64, telemetry=make())
        engine.run(params, reqs)                      # warm
        rows = []
        for _ in range(rounds):
            prof = cProfile.Profile()
            prof.enable()
            _, stats = engine.run(params, reqs)
            prof.disable()
            secs, calls = telemetry_seconds(prof)
            us = 1e6 * secs / stats["decode_steps"]
            rows.append(dict(seconds=secs, calls=calls,
                             steps=stats["decode_steps"], us_a_step=us))
            print(f"profile {level}: {secs:.4f} s in {calls} telemetry "
                  f"calls over {stats['decode_steps']} decode steps, "
                  f"{us:.1f} us a step (device {device})", flush=True)
        out[level] = rows
    return out


def wall_part(rounds):
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("the wall part needs the card")
    dev = torch.device("cuda")
    cfg, model, params, scales, codec = cs._full_width(dev)
    reqs, lens, gen = cs._serve_requests(cfg)
    engines = {name: cs._serve_engine(model, codec, scales, dev, lens, gen,
                                      telemetry=make())[0]
               for name, make in levels().items()}
    for engine in engines.values():
        engine.run(params, reqs)                      # warm
    names = list(engines) + ["tracing, gc off"]
    runs = {n: [] for n in names}
    for r in range(rounds):
        for n in names[r % len(names):] + names[:r % len(names)]:
            engine = engines["tracing" if n.startswith("tracing") else n]
            if n.endswith("gc off"):
                gc.disable()
            try:
                _, stats = engine.run(params, reqs)
            finally:
                gc.enable()
            runs[n].append(stats["run_s"])
            print(f"wall round {r} {n}: run {stats['run_s']:.3f} s, decode "
                  f"{stats['decode_tok_s']:.1f} tok/s", flush=True)
    base = statistics.median(runs["counters"])
    summary = {n: dict(median_s=statistics.median(v), runs=v,
                       over_counters=statistics.median(v) / base - 1)
               for n, v in runs.items()}
    for n, v in summary.items():
        print(f"wall {n}: median {v['median_s']:.3f} s "
              f"({v['over_counters']:+.1%} against counters)")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="profile")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    out = {}
    parts = args.parts.split(",")
    if "profile" in parts:
        out["profile"] = profile_part(args.device, args.rounds)
    if "wall" in parts:
        out["wall"] = wall_part(args.rounds)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
