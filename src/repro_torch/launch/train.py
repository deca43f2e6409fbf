"""The LLM trainer (port of `repro.launch.train`): gradient-accumulating
train step, AdamW with a cosine schedule, optional SPARQ gradient
compression with error feedback, checkpoint/restart and straggler
reporting, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 10 --batch 8

Params are f32 leaves; the forward computes in `cfg.dtype` (bf16 for the
published configs), each layer recomputed in the backward when
`cfg.remat`. Gradients come from `torch.autograd.grad` over leaves made
to require grad (`value_and_grad`), never from `.grad` fields. The
reference's meshes (`--mesh production`, `--multi-pod`,
`--model-parallel` > 1) are not ported and raise.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import Batcher, DataConfig
from repro_torch.distributed.collectives import GradCompressor
from repro_torch.distributed.fault import ElasticCoordinator
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, cosine_schedule


def value_and_grad(fn: Callable, params):
    """fn(params) -> loss or (loss, metrics). Returns (loss, metrics,
    grads): detached, and grads shaped as `params`, zeros where a leaf
    does not reach the loss (as JAX gives them)."""
    req = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    out = fn(T.unflatten(params, req))
    loss, metrics = out if isinstance(out, tuple) else (out, {})
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(req, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        T.unflatten(params, grads)


def build_train_step(model: Model, opt: AdamW,
                     compressor: Optional[GradCompressor] = None,
                     accum: Optional[int] = None):
    """train_step(params, opt_state, comp_state, batch) -> (params,
    opt_state, comp_state, metrics). With `accum` microbatches (default
    `cfg.train_microbatches`) the batch's rows split into that many
    consecutive slices, whose f32 gradients are summed in order and
    divided by `accum`; then the compressor, then the optimizer."""
    accum = accum or model.cfg.train_microbatches

    def train_step(params, opt_state, comp_state, batch: Dict):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if accum > 1:
            per = batch["tokens"].shape[0] // accum
            grads = T.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(accum):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                l_mb, _, g = value_and_grad(lambda p: model.loss(p, mb),
                                            params)
                for a, b in zip(T.leaves(grads), T.leaves(g)):
                    a.add_(b.to(torch.float32))
                loss = loss + l_mb
            n = torch.tensor(float(accum), device=model.device)
            grads = T.tree_map(lambda g: g / n, grads)
            loss = loss / n
            metrics = {"lm_loss": loss}
        else:
            loss, metrics, grads = value_and_grad(
                lambda p: model.loss(p, batch), params)
        if compressor is not None:
            grads, comp_state = compressor.compress(grads, comp_state)
        new_params, new_state, om = opt.update(grads, opt_state, params)
        return new_params, new_state, comp_state, {"loss": loss, **metrics,
                                                   **om}
    return train_step


def _state_tree(params, opt_state):
    return {"params": params, "m": opt_state.m, "v": opt_state.v}


def main(argv=None, metrics: Optional[list] = None):
    """Runs the training loop; returns the losses, one a step. When
    `metrics` is a list, each step appends {"step", "loss", "grad_norm",
    "ms"} to it (ms: host time of the step, the loss read back)."""
    ap = argparse.ArgumentParser(
        description="LM training with AdamW, optional SPARQ gradient "
                    "compression, checkpoint/restart (PyTorch/CUDA)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-total", type=int, default=None,
                    help="schedule horizon (default: --steps); set it "
                         "explicitly when a run will be resumed/extended")
    ap.add_argument("--mesh", choices=["host", "production"], default="host")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    for flag, on in (("--mesh production", args.mesh != "host"),
                     ("--multi-pod", args.multi_pod),
                     ("--model-parallel > 1", args.model_parallel != 1)):
        if on:
            raise NotImplementedError(
                f"{flag} is not yet ported to repro_torch (see ROADMAP.md)")

    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    model = Model(cfg, device=device)
    total = args.lr_total or args.steps
    opt = AdamW(lr=cosine_schedule(args.lr, max(total // 20, 1), total))
    compressor = GradCompressor() if args.compress_grads else None
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, seed=args.seed))

    # f32 master weights for every arch, as the reference's trainer
    # initialises them (its `init_params` default)
    params = model.init_params(args.seed, dtype=torch.float32)
    opt_state = opt.init(params)
    comp_state = compressor.init(params) if compressor else None
    start_step = 0
    if args.checkpoint_dir and args.restore:
        step = ckpt.latest_step(args.checkpoint_dir)
        if step is not None:
            state = ckpt.restore(args.checkpoint_dir, step,
                                 _state_tree(params, opt_state), device)
            params = state["params"]
            opt_state = opt_state._replace(
                m=state["m"], v=state["v"],
                count=torch.tensor(step, dtype=torch.int32, device=device))
            start_step = step
            print(f"restored step {step} from {args.checkpoint_dir}")

    step_fn = build_train_step(model, opt, compressor)
    coord = ElasticCoordinator(n_workers=1)
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = data.global_batch(step)
        params, opt_state, comp_state, m = step_fn(
            params, opt_state, comp_state, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        coord.step_report(0, step, dt)
        losses.append(loss)
        gnorm = float(m["grad_norm"])
        if metrics is not None:
            metrics.append({"step": step, "loss": loss, "grad_norm": gnorm,
                            "ms": dt * 1e3})
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"({dt*1000:.0f} ms)", flush=True)
        if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(args.checkpoint_dir, step + 1,
                      _state_tree(params, opt_state))
    if args.checkpoint_dir:
        ckpt.save(args.checkpoint_dir, args.steps,
                  _state_tree(params, opt_state))
    return losses


if __name__ == "__main__":
    main()
