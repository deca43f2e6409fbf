"""How far rounding-sized changes move a reduced model's training: the
one-device trainer's 3 steps (`build_train_step`, AdamW with the sharded
tests' schedule, batch 4 x 16) from the port's init, and again from that
init with every element scaled by 1 + 1e-7 x a normal draw. Prints each
step's loss and grad norm and their relative differences, a line an
arch.

    PYTHONPATH=src python probes/rwkv_sensitivity.py \\
        [--archs rwkv6-7b,tinyllama-1.1b,recurrentgemma-9b]

CPU, torch only, reduced configs in f32."""
import argparse
import json

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import get_reduced_config
from repro_torch.launch.train import build_train_step
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, cosine_schedule


def run(arch: str, eps: float):
    cfg = get_reduced_config(arch).replace(dtype=torch.float32,
                                           attn_chunk=8)
    model = Model(cfg, device="cpu")
    params = model.init_params(0, dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    params = T.tree_map(lambda x: x * (1 + eps * torch.randn(
        x.shape, generator=gen)), params)
    rng = np.random.default_rng(5)
    opt = AdamW(lr=cosine_schedule(1e-3, 1, 3))
    step = build_train_step(model, opt, None, 1)
    state, out = opt.init(params), []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.concatenate(
            [toks[:, 1:], np.full((4, 1), -1, np.int32)], 1)}
        params, state, _, m = step(params, state, None, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs",
                    default="rwkv6-7b,tinyllama-1.1b,recurrentgemma-9b")
    args = ap.parse_args()
    torch.set_num_threads(1)
    for arch in args.archs.split(","):
        base, moved = run(arch, 0.0), run(arch, 1e-7)
        print(json.dumps({
            "arch": arch, "base": base, "perturbed": moved,
            "rel_loss": [abs(a[0] - b[0]) / abs(a[0])
                         for a, b in zip(base, moved)],
            "rel_grad_norm": [abs(a[1] - b[1]) / abs(a[1])
                              for a, b in zip(base, moved)]}))


if __name__ == "__main__":
    main()
