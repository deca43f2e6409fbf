"""K3's time at the serving shape in two trees, on one card, in turns.

    python3 probes/k3_paired.py PARENT_DIR [CHANGE_DIR] [--rounds N]

PARENT_DIR and CHANGE_DIR (default: this tree) are roots of checkouts of
the repository (e.g. a `git archive` of the parent commit unpacked into a
directory that .gitignore lists). Each turn runs one subprocess in one
tree: it imports that tree's chip_smoke.py, builds that tree's K3 and
times it (`chip_smoke.bench`, CUDA events, 200 launches, five times) on
chip_smoke's timed layout at hd 64 G 8, bq 8, page 16, the same inputs
from seed 3. Turns go parent, change, change, parent, N rounds. Prints a
line per turn and one JSON line with every time. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

TURN = r"""
import json, sys, torch
sys.path.insert(0, "."); sys.path.insert(0, "src")
import chip_smoke as cs
from repro_torch.kernels import sparq_prefill_attn as pre
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(3)
kw = dict(G=8, hd=64, ps=16, bq=8)
sets = [cs.k3_case(gen, dev, "timed", **kw)
        for _ in range(cs.n_sets(4 * 41 * 16 * 4 * 64))]
pre.sparq_chunked_prefill_attn_cuda(*sets[0])
torch.cuda.synchronize()
print(json.dumps([cs.bench(pre.sparq_chunked_prefill_attn_cuda, sets,
                           iters=200) for _ in range(5)]))
"""


def turn(tree: pathlib.Path):
    r = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"turn in {tree} failed:\n{r.stdout}{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    trees = {"parent": pathlib.Path(args.parent).resolve(),
             "change": pathlib.Path(args.change).resolve()}
    times = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            ms = turn(trees[name])
            times[name].append(ms)
            print(f"{name}: K3 hd 64 G 8 ms " + ", ".join(
                f"{x:.4f}" for x in ms), flush=True)
    mean = {k: sum(map(sum, v)) / sum(map(len, v)) for k, v in times.items()}
    print(f"mean ms: parent {mean['parent']:.4f}, change "
          f"{mean['change']:.4f}, ratio {mean['change'] / mean['parent']:.3f}")
    print(json.dumps({"times": times, "mean": mean}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
