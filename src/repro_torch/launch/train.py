"""The LLM trainer (port of `repro.launch.train`): gradient-accumulating
train step, AdamW with a cosine schedule, optional SPARQ gradient
compression with error feedback, checkpoint/restart and straggler
reporting, on one device or sharded over a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 10 --batch 8
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --reduced --model-parallel 2 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --reduced --device cpu

Params are f32 leaves; the forward computes in `cfg.dtype` (bf16 for the
published configs), each layer recomputed in the backward when
`cfg.remat`. Gradients come from `torch.autograd.grad` over leaves made
to require grad (`value_and_grad`), never from `.grad` fields.

Under `torchrun` with a world of more than one rank the trainer builds
the reference's mesh: `--model-parallel N` the host mesh (world / N, N),
`--mesh production [--multi-pod]` the (16, 16) or (2, 16, 16) one (256
or 512 ranks). Params, m, v and the residual are stored as blocks under
`param_pspecs` (FSDP / ZeRO; `distributed.fsdp`), each rank takes its dp
rows of the global batch, and weights are gathered a layer at a time.
Over the model axis the ranks of a group split the compute as the
reference's rules split the weights (`sharding.model_split`): Megatron's
column and row products, attention on whole heads, a vocab-parallel
embedding and LM loss, the RWKV and RG-LRU mixers on their heads or
channels; such a leaf is gathered over the dp axes alone (`distributed.
tensor`). An MoE layer routes, sizes its capacity and takes its load-
balance density over every row of the microbatch (one all-gather of the
[E] expert counts), and each rank of a model group runs only its E/m
routed experts (`distributed.expert`). A gradient reaches its block by
a reduce-scatter over the dp axes. Ranks share a card only with
`--share-cards` (gloo; NCCL where each has its own).
Without torchrun's environment the trainer runs on one device with no
process group, as before.
"""
from __future__ import annotations

import argparse
import json
import sys
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
from repro_torch.distributed.fsdp import FSDP
from repro_torch.distributed.sharding import param_pspecs
from repro_torch.launch import mesh as meshes
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
                     accum: Optional[int] = None,
                     fsdp: Optional[FSDP] = None):
    """train_step(params, opt_state, comp_state, batch) -> (params,
    opt_state, comp_state, metrics). With `accum` microbatches (default
    `cfg.train_microbatches`) the batch's rows split into that many
    consecutive slices, whose f32 gradients are summed in order and
    divided by `accum`; then the compressor, then the optimizer.

    With `fsdp` the state holds this rank's blocks and `batch` is the
    global batch: microbatch i is the rank's dp slice of global rows
    [i B / accum, (i + 1) B / accum), as the reference's reshape-then-
    shard gives; the loss and its terms are dp means, the compressor
    scales a block by its whole leaf's max, and AdamW clips by the global
    norm. An MoE layer routes and sizes its capacity over the whole
    microbatch, and its routed experts split over "model" where their
    banks do (`models.moe.moe_apply`); every other leaf that `fsdp`
    splits over "model" computes on its block there (`FSDP.split`)."""
    accum = accum or model.cfg.train_microbatches

    def loss_of(mb):
        if fsdp is None:
            return lambda p: model.loss(p, mb)
        rows, experts = fsdp.rows(mb)
        return lambda p: model.loss(p, rows, gather=fsdp, experts=experts)

    def train_step(params, opt_state, comp_state, batch: Dict):
        if fsdp is None:
            batch = {k: torch.as_tensor(v, device=model.device)
                     for k, v in batch.items()}
        if accum > 1:
            per = batch["tokens"].shape[0] // accum
            grads = T.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(accum):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                l_mb, _, g = value_and_grad(loss_of(mb), params)
                for a, b in zip(T.leaves(grads), T.leaves(g)):
                    a.add_(b.to(torch.float32))
                loss = loss + l_mb
            n = torch.tensor(float(accum), device=model.device)
            grads = T.tree_map(lambda g: g / n, grads)
            loss = loss / n
            metrics = {"lm_loss": loss}
        else:
            loss, metrics, grads = value_and_grad(loss_of(batch), params)
        gsq = None
        if fsdp is not None:
            names = ["loss", *metrics]
            means = fsdp.dp_mean(torch.stack([loss, *metrics.values()]),
                                 site="metrics")
            loss, metrics = means[0], dict(zip(names[1:], means[1:]))
            if compressor is not None:
                grads, comp_state = compressor.compress(
                    grads, comp_state, numels=fsdp.numels(grads),
                    amax=fsdp.amax)
            gsq = fsdp.sq_norm(grads)
        elif compressor is not None:
            grads, comp_state = compressor.compress(grads, comp_state)
        new_params, new_state, om = opt.update(grads, opt_state, params,
                                               gsq=gsq)
        return new_params, new_state, comp_state, {"loss": loss, **metrics,
                                                   **om}
    return train_step


def _kernel_launches() -> Dict[str, int]:
    """Launches of each of the port's kernels so far in this process (none
    where the kernels were never loaded)."""
    build = sys.modules.get("repro_torch.kernels.build")
    return build.launch_counts() if build else {}


def _state_tree(params, opt_state):
    return {"params": params, "m": opt_state.m, "v": opt_state.v}


def _mesh_of(args) -> Optional[meshes.DistMesh]:
    """The mesh the flags and the world ask for; None for one device
    without a process group. Raises before any process group starts
    where the world does not fit the flags."""
    if args.mesh == "production":
        return meshes.make_production_mesh(args.multi_pod, args.device,
                                           args.share_cards)
    _, world, _ = meshes.world_env()
    if world == 1 and args.model_parallel == 1:
        return None
    return meshes.make_host_mesh(args.model_parallel, args.device,
                                 args.share_cards)


def main(argv=None, metrics: Optional[list] = None):
    """Runs the training loop; returns the losses, one a step. When
    `metrics` is a list, each step appends {"step", "loss", "grad_norm",
    "ms", "rank", "peak_gb", "state_gb", "kernel_launches"} to it (ms:
    host time of the step, the loss read back; peak_gb: the device's peak
    allocated memory so far, None off the card; state_gb: the device's
    allocated memory once the params, AdamW's state and the compressor's
    residual exist, before the first step, None off the card;
    kernel_launches: {kernel: launches so far in this process});
    `--metrics-out` writes the same records as JSON lines."""
    ap = argparse.ArgumentParser(
        description="LM training with AdamW, optional SPARQ gradient "
                    "compression, checkpoint/restart, sharded over a mesh "
                    "under torchrun (PyTorch/CUDA)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the config's first N layers (a depth cut "
                         "at full width, for smoke runs)")
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
    ap.add_argument("--share-cards", action="store_true",
                    help="let ranks share cards where a host has fewer "
                         "cards than ranks (gloo)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--metrics-out", default=None,
                    help="append each step's record as a JSON line to this "
                         "file ({rank} becomes the rank)")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    started_world = dist.is_available() and dist.is_initialized()
    mesh = _mesh_of(args)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    rank, world = (dist.get_rank(), mesh.world) if mesh is not None \
        else (0, 1)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    model = Model(cfg, device=device)
    total = args.lr_total or args.steps
    opt = AdamW(lr=cosine_schedule(args.lr, max(total // 20, 1), total))
    compressor = GradCompressor() if args.compress_grads else None
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, seed=args.seed,
                              frontend=cfg.frontend,
                              frontend_len=cfg.frontend_len,
                              d_model=cfg.d_model))
    fsdp = None
    if mesh is not None:
        shapes = Model(cfg, device="meta").init_params(dtype=torch.float32)
        # the TP layout always, as the reference's trainer (its dry run
        # alone takes ZeRO-DP for a small model's train cell)
        fsdp = FSDP(mesh, param_pspecs(shapes, mesh, tensor_parallel=True),
                    cfg, tensor_parallel=True)
        if rank == 0:
            print(f"mesh {mesh.shape} over {world} ranks, backend "
                  f"{mesh.backend}, rank 0 on {device}", flush=True)

    # f32 master weights for every arch, as the reference's trainer
    # initialises them (its `init_params` default); on a mesh each rank
    # keeps its blocks of the same draws
    params = model.init_params(args.seed, dtype=torch.float32,
                               blocks=fsdp.slices if fsdp else None)
    opt_state = opt.init(params)
    comp_state = compressor.init(params) if compressor else None
    start_step = 0
    if args.checkpoint_dir and args.restore:
        step = ckpt.latest_step(args.checkpoint_dir)
        if step is not None:
            state = ckpt.restore(
                args.checkpoint_dir, step, _state_tree(params, opt_state),
                device, blocks=(lambda p, shape: fsdp.slices(p[1:], shape))
                if fsdp else None)
            params = state["params"]
            opt_state = opt_state._replace(
                m=state["m"], v=state["v"],
                count=torch.tensor(step, dtype=torch.int32, device=device))
            start_step = step
            if rank == 0:
                print(f"restored step {step} from {args.checkpoint_dir}")

    def save(step):
        ckpt.save(args.checkpoint_dir, step, _state_tree(params, opt_state),
                  unshard=(lambda p, b: fsdp.unshard(p[1:], b))
                  if fsdp else None, write=rank == 0)
        if mesh is not None:
            dist.barrier()

    state_gb = torch.cuda.memory_allocated(device) / 2 ** 30 \
        if device.type == "cuda" else None
    step_fn = build_train_step(model, opt, compressor, fsdp=fsdp)
    coord = ElasticCoordinator(n_workers=world)
    out = open(args.metrics_out.replace("{rank}", str(rank)), "a") \
        if args.metrics_out else None
    losses, saved = [], None
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = data.global_batch(step)
        params, opt_state, comp_state, m = step_fn(
            params, opt_state, comp_state, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        coord.step_report(rank, step, dt)
        losses.append(loss)
        gnorm = float(m["grad_norm"])
        rec = {"step": step, "loss": loss, "grad_norm": gnorm,
               "ms": dt * 1e3, "rank": rank,
               "peak_gb": torch.cuda.max_memory_allocated(device) / 2 ** 30
               if device.type == "cuda" else None,
               "state_gb": state_gb, "kernel_launches": _kernel_launches()}
        if metrics is not None:
            metrics.append(rec)
        if out is not None:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        if rank == 0 and (step % args.log_every == 0
                          or step == args.steps - 1):
            print(f"step {step} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"({dt*1000:.0f} ms)", flush=True)
        if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
            save(step + 1)
            saved = step + 1
    if args.checkpoint_dir and saved != args.steps:
        save(args.steps)
    if out is not None:
        out.close()
    if mesh is not None and not started_world:
        dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
