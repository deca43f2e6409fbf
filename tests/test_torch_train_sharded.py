"""Port parity, sharded training: the trainer's FSDP step over gloo CPU
ranks against the JAX package's `build_train_step` run without a mesh
(what GSPMD computes under the reference's rules, up to reduction order),
the collectives, `unshard_leaf`, and checkpoints across layouts.

Each world of ranks is spawned once (this file run as a script, torch
only, one intra-op thread a rank, a gloo `FileStore` in a temporary
directory) and runs every case of its world; the tests read what rank 0
(or each rank) wrote. World 2: meshes 2 x 1 and 1 x 2 (on 1 x 2 each
rank computes its heads, its d_ff columns and its half of the
vocabulary: Megatron's column and row products), reduced dbrx and
deepseek on 2 x 1 (routing and capacity over the whole microbatch) and
1 x 2 (expert parallelism, the shared experts' F split), the other
families on 1 x 2 (granite with a 513-row vocabulary: MQA k / v and the
vocabulary whole), the trainer's restart and cross-layout restores.
World 4: mesh 2 x 2 (both MoE models, rwkv6 and whisper too), the (pod
2, data 2) mesh, the collectives at 4 ranks. The collectives include the
model axis's autograd functions (`distributed.tensor`: `copy_to` /
`reduce_from`, `gather_from`, `reduce_scatter_to`) and the gather's
backward, a reduce-scatter over dp (`FSDP.block_grad`).

Tolerances, with their reasons:
- losses, grad norms and the MoE models' load-balance and z terms: 1e-5
  relative to JAX (a rank's loss is the mean over its rows and the dp
  mean follows; XLA and PyTorch sum in other orders; expert parallelism
  adds a token's expert outputs in another order, a row product its
  partials), 1e-4 with compression (a gradient element at a rounding
  boundary takes the next code: the step-1 residuals against one process
  are counted, measured at most 1 flipped code of 410,240 elements over
  dp 2 and none on 1 x 2, and asserted below 0.1% of the elements).
- parameters: `chip_smoke.train_params_close`, as the one-device port
  (tests/test_torch_train_step.py).
- the 1 x 2 mesh's first loss against one process: 1e-6 (f32; the row
  products' partials and the vocabulary's sums add in another order).
- exact: `unshard_leaf`, the restart, checkpoints, `compressed_psum` at 2
  ranks, the gather's backward against the dp mean then the slice at 2
  ranks; at 4, 2 ulp of the terms' summed magnitudes (gloo's order of
  summation), 1e-6 for the model axis's sums and the gather's backward.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ != "__main__":
    import importlib.util

    import jax
    import jax.numpy as jnp
    import pytest

    from repro.checkpoint import manager as jckpt
    from repro.configs.base import get_reduced_config as jcfg_reduced
    from repro.distributed.collectives import GradCompressor as JComp
    from repro.distributed.collectives import sparq_compress as jcompress
    from repro.distributed.sharding import set_activation_spec
    from repro.launch.train import build_train_step as jbuild
    from repro.models.model import Model as JModel
    from repro.optim.adamw import AdamW as JAdamW
    from repro.optim.adamw import cosine_schedule as jcosine

from repro_torch import tree as T  # noqa: E402

TRAIN_ARGV = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "4",
              "--seq", "16", "--device", "cpu", "--lr-total", "4",
              "--log-every", "100", "--seed", "7"]
SPECS = [(), (None, "model"), ("data", None), (("data", "model"), None),
         ("model", "data"), (None, ("model", "data"))]
POD_SPECS = [(("pod", "data"), None), (None, ("data", "pod")),
             ("pod", "data")]


# ----------------------------------------------------------------------
# rank side: torch and the port only
# ----------------------------------------------------------------------

def _cfg(arch, over=None):
    from repro_torch.configs import get_reduced_config
    return get_reduced_config(arch).replace(dtype=torch.float32,
                                            attn_chunk=8, **(over or {}))


def _run_train(job, rank):
    """`build_train_step` with an FSDP over the job's mesh, from the whole
    params it is given; the gathered params at the end; with "ckpt" a
    save, a restore onto the same blocks, and each rank's blocks."""
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed.collectives import GradCompressor
    from repro_torch.distributed.fsdp import FSDP
    from repro_torch.distributed.sharding import param_pspecs, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    mesh = make_mesh(tuple(job["shape"]), tuple(job["names"]), "cpu")
    inputs = torch.load(job["inputs"], weights_only=False)
    model = Model(_cfg(job["arch"], job.get("cfg")), device="cpu")
    tp = job.get("tp", True)
    specs = param_pspecs(inputs["params"], mesh, tensor_parallel=tp)
    fsdp = FSDP(mesh, specs, model.cfg, tensor_parallel=tp)
    params = shard_tree(inputs["params"], specs, mesh)
    opt = AdamW(lr=cosine_schedule(1e-3, 1, 3))
    comp = GradCompressor() if job["compress"] else None
    step = build_train_step(model, opt, comp, job["accum"], fsdp=fsdp)
    state, cs = opt.init(params), comp.init(params) if comp else None
    out = {"losses": [], "grad_norms": [], "lrs": [], "lb_loss": [],
           "z_loss": []}
    for i, b in enumerate(inputs["batches"]):
        with _MoESpy(out if i == 0 else None), \
                _DenseSpy(out if i == 0 else None):
            params, state, cs, m = step(params, state, cs, b)
        for k, n in (("losses", "loss"), ("grad_norms", "grad_norm"),
                     ("lrs", "lr"), ("lb_loss", "lb_loss"),
                     ("z_loss", "z_loss")):
            if n in m:
                out[k].append(float(m[n]))
        if i == 0 and comp is not None:
            out["residual"] = [fsdp.unshard(p, e)
                               for p, e in T.flatten_with_path(cs)]
    out["params"] = [fsdp.unshard(p, x) for p, x in
                     T.flatten_with_path(params)]
    if rank == 0:
        # the one-process port on the same inputs, first step
        one = build_train_step(model, opt, GradCompressor() if comp else
                               None, job["accum"])
        p0 = inputs["params"]
        _, _, cs1, m1 = one(p0, opt.init(p0), comp.init(p0) if comp
                            else None, inputs["batches"][0])
        out["one_process_loss"] = float(m1["loss"])
        if comp is not None:
            out["one_process_residual"] = T.leaves(cs1)
    if job.get("grads"):
        out["grad_errs"] = _grad_errs(model, fsdp, specs, mesh, inputs)
    if job.get("ckpt"):
        tree = {"params": params, "m": state.m, "v": state.v}
        ckpt.save(job["ckpt"], 3, tree, write=rank == 0,
                  unshard=lambda p, b: fsdp.unshard(p[1:], b))
        dist.barrier()
        blank = T.tree_map(torch.zeros_like, tree)
        got = ckpt.restore(job["ckpt"], 3, blank, "cpu",
                           blocks=lambda p, s: fsdp.slices(p[1:], s))
        out["restored_equal"] = all(torch.equal(a, b) for a, b in zip(
            T.leaves(got), T.leaves(tree)))
        out["blocks"] = T.leaves(params)
        out["coord"] = mesh.coord
        out["keys"] = [T.path_key(p) for p, _ in
                       T.flatten_with_path(params)]
    return out


def _grad_errs(model, fsdp, specs, mesh, inputs):
    """{leaf key: max |block gradient - one process's| / max |one
    process's|} of the first batch's loss from the job's params: each
    rank's gradient of its blocks, through the split products and the
    gather's backward, against the same block of the one-process port's
    gradient (the dp mean of the rank losses is the one-process loss)."""
    from repro_torch.distributed.sharding import block_slices, shard_tree
    from repro_torch.launch.train import value_and_grad
    p0, b = inputs["params"], inputs["batches"][0]
    rows, experts = fsdp.rows(b)
    _, _, got = value_and_grad(lambda p: model.loss(
        p, rows, gather=fsdp, experts=experts), shard_tree(p0, specs, mesh))
    _, _, want = value_and_grad(lambda p: model.loss(p, b), p0)
    out = {}
    for (path, g), w in zip(T.flatten_with_path(got), T.leaves(want)):
        key = T.path_key(path)
        w = w[block_slices(tuple(w.shape), specs[key], mesh)]
        out[key] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                    1e-30)
    return out


class _MoESpy:
    """While a step runs, records in `out` each MoE layer call's routing
    ("routing": its local expert ids, the counts before this rank's rows,
    the totals, C and the kept mask) and the expert banks each batched
    product takes ("bank_shapes"); no-op with `out` None."""

    def __init__(self, out):
        self.out = out

    def __enter__(self):
        from repro_torch.models import moe
        self.saved = moe.global_slots, moe._expert_ffn
        if self.out is None:
            return self
        routing = self.out.setdefault("routing", [])
        shapes = self.out.setdefault("bank_shapes", [])
        slots, ffn = self.saved

        def spy_slots(ids, before, total, C):
            slot, kept = slots(ids, before, total, C)
            routing.append({"ids": ids.clone(), "before": before.clone(),
                            "total": total.clone(), "C": C,
                            "kept": kept.clone()})
            return slot, kept

        def spy_ffn(wg, wu, wd, x, *a):
            shapes.append(tuple(wu.shape))
            return ffn(wg, wu, wd, x, *a)
        moe.global_slots, moe._expert_ffn = spy_slots, spy_ffn
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.global_slots, moe._expert_ffn = self.saved


class _DenseSpy:
    """While a step runs, records in `out` ("dense_shapes") the site and
    weight shape of every attention and FFN product and of the LM head
    (site "lm_head", its [D, V] or [D, V/m] head); no-op with `out`
    None."""
    PATCHED = (("attention", "dense"), ("attention", "dense_f32"),
               ("ffn", "dense"), ("ffn", "dense_f32"),
               ("common", "dense_f32"))

    def __init__(self, out):
        self.out = out

    def __enter__(self):
        import importlib
        self.mods = {n: importlib.import_module(f"repro_torch.models.{n}")
                     for n in ("attention", "ffn", "common", "model")}
        self.saved = [(m, f, getattr(self.mods[m], f))
                      for m, f in self.PATCHED + (("model",
                                                   "chunked_lm_loss"),)]
        if self.out is None:
            return self
        shapes = self.out.setdefault("dense_shapes", [])

        def spy(orig):
            def run(w, x, site, *a, **k):
                if site != "lm_head":
                    shapes.append((site, tuple(w.shape)))
                return orig(w, x, site, *a, **k)
            return run

        def spy_loss(orig):
            def run(head, *a, **k):
                shapes.append(("lm_head", tuple(head.shape)))
                return orig(head, *a, **k)
            return run
        for m, f, orig in self.saved:
            setattr(self.mods[m], f, spy_loss(orig) if f == "chunked_lm_loss"
                    else spy(orig))
        return self

    def __exit__(self, *exc):
        for m, f, orig in self.saved:
            setattr(self.mods[m], f, orig)


def _run_restart(job, rank):
    """The trainer's own loop (`train.main`) on the world: 4 steps
    straight; 2, a checkpoint, a restore and 2 more; the same restart on
    the 1 x 2 mesh from the 2 x 1 checkpoint; and 2 more steps from a
    one-device checkpoint."""
    import torch.distributed as dist
    from repro_torch.launch import train
    d = pathlib.Path(job["dir"])
    out = {}
    out["straight"] = train.main(TRAIN_ARGV + [
        "--steps", "4", "--checkpoint-dir", str(d / "straight")])
    out["first"] = train.main(TRAIN_ARGV + [
        "--steps", "2", "--checkpoint-dir", str(d / "half")])
    if rank == 0:
        shutil.copytree(d / "half", d / "half_mp")
    dist.barrier()
    out["resumed"] = train.main(TRAIN_ARGV + [
        "--steps", "4", "--restore", "--checkpoint-dir", str(d / "half")])
    out["resumed_mp"] = train.main(TRAIN_ARGV + [
        "--steps", "4", "--restore", "--model-parallel", "2",
        "--checkpoint-dir", str(d / "half_mp")])
    out["from_one_device"] = train.main(TRAIN_ARGV + [
        "--steps", "4", "--restore", "--checkpoint-dir",
        job["one_device_dir"]])
    return out


def _run_collectives(job, rank):
    """`compressed_psum` and `hierarchical_psum` of each rank's seeded
    tensor; `unshard_leaf` of each spec's block of an arange leaf."""
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     hierarchical_psum)
    from repro_torch.distributed.sharding import shard_leaf, unshard_leaf
    from repro_torch.launch.mesh import make_mesh
    out = {}
    world = job["world"]
    flat = make_mesh((world, 1), ("data", "model"), "cpu")
    x = torch.from_numpy(_rank_input(rank))
    out["compressed"] = compressed_psum(x, flat, "data")
    meshes = [((world // 2, 2), ("data", "model"), SPECS)]
    if world == 4:
        meshes.append(((2, 2, 1), ("pod", "data", "model"), POD_SPECS))
        pod = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
        out["hierarchical"] = hierarchical_psum(x, pod)
        out["hierarchical_int"] = hierarchical_psum(torch.round(x * 8), pod)
    # the expert-parallel autograd pair: every rank's x equal, its part
    # scaled by rank + 2, the parts summed
    from repro_torch.distributed.expert import copy_to, reduce_from
    g = flat.group("data")
    xw = torch.from_numpy(_rank_input(0)[:4]).requires_grad_(True)
    s = reduce_from(copy_to(xw, g) * float(rank + 2), g)
    (gx,) = torch.autograd.grad(
        torch.sum(s * torch.from_numpy(_rank_input(1)[:4])), xw)
    out["pair"] = (s.detach(), gx)
    out["model_axis"] = _model_axis_ops(g, rank)
    out["block_grads"] = _block_grads(world, rank)
    out["round_trip"] = []
    for shape, names, specs in meshes:
        mesh = make_mesh(shape, names, "cpu")
        whole = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
        for spec in specs:
            back = unshard_leaf(shard_leaf(whole, spec, mesh), spec, mesh)
            out["round_trip"].append((names, spec, torch.equal(back, whole)))
    return out


def _model_axis_ops(group, rank):
    """`gather_from` and `reduce_scatter_to` along dim 0 and dim 1 of each
    rank's input block x_r [8, 12]: their outputs and x_r's gradients
    under the loss Σ out * w_r (w_r another seeded block a rank)."""
    from repro_torch.distributed.tensor import gather_from, reduce_scatter_to
    got = {}
    for name, fn in (("gather", gather_from), ("scatter", reduce_scatter_to)):
        for dim in (0, 1):
            x = torch.from_numpy(_rank_input(rank)[:8, :12]).requires_grad_(
                True)
            y = fn(x, group, dim)
            w = torch.from_numpy(_rank_weight(rank, tuple(y.shape)))
            (gx,) = torch.autograd.grad(torch.sum(y * w), x)
            got[(name, dim)] = (y.detach(), gx)
    return got


BLOCK_GRAD_SPECS = {
    2: (((2, 1), ("data", "model"),
         [("data", None), (None, "data"), ("model", "data"), ()]),),
    4: (((2, 2), ("data", "model"),
         [("data", "model"), ("model", "data"), (None, "model"),
          ("data", None)]),
        ((2, 2, 1), ("pod", "data", "model"),
         [(("pod", "data"), None), (None, "data"), ("pod", None),
          (None, ("pod", "data"))])),
}


def _block_grads(world, rank):
    """`FSDP.block_grad` (the gather's backward: reduce-scatter over dp)
    and the dp mean, then the block's slice, of each rank's seeded
    whole gradient [8, 12] under each spec: (mesh names, spec, the two)."""
    from repro_torch.distributed.fsdp import FSDP
    from repro_torch.distributed.sharding import block_slices
    from repro_torch.launch.mesh import make_mesh
    out = []
    for shape, names, specs in BLOCK_GRAD_SPECS[world]:
        mesh = make_mesh(shape, names, "cpu")
        fsdp = FSDP(mesh, {}, None)
        g = torch.from_numpy(_rank_input(rank)[8:16, :12])
        for spec in specs:
            want = fsdp.dp_mean(g)[block_slices((8, 12), spec, mesh)]
            out.append((names, spec, fsdp.block_grad(g, spec), want))
    return out


def _rank_weight(rank, shape):
    return np.random.default_rng(200 + rank).standard_normal(
        shape).astype(np.float32)


def _rank_input(rank):
    return np.random.default_rng(100 + rank).standard_normal(
        (64, 33)).astype(np.float32)


RUNNERS = {"train": _run_train, "restart": _run_restart,
           "collectives": _run_collectives}


def _rank_main(argv):
    import torch.distributed as dist
    world, rank, store, jobs, out = int(argv[0]), int(argv[1]), *argv[2:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    results = {}
    with open(jobs) as f:
        for job in json.load(f):
            results[job["name"]] = RUNNERS[job["kind"]](job, rank)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))


# ----------------------------------------------------------------------
# test side
# ----------------------------------------------------------------------

def _start(world, jobs, d):
    """Start a world of gloo ranks on `jobs`; `_finish` waits for it."""
    (d / "jobs.json").write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return d, [subprocess.Popen(
        [sys.executable, __file__, str(world), str(r), str(d / "store"),
         str(d / "jobs.json"), str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _finish(started):
    """Each rank's results."""
    d, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch(rng, vocab, B, S, cfg=None):
    """Tokens and next-token labels; with an audio or vision front end
    (`cfg.frontend`) its precomputed "frames" [B, S, d] or "image_embeds"
    [B, frontend_len, d], normals x 0.02."""
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    out = {"tokens": toks, "labels": labels}
    if cfg is not None and cfg.frontend in ("audio", "vision"):
        rows = S if cfg.frontend == "audio" else cfg.frontend_len
        out["frames" if cfg.frontend == "audio" else "image_embeds"] = (
            rng.standard_normal((B, rows, cfg.d_model)) * 0.02
        ).astype(np.float32)
    return out


CASES = ((False, 1), (False, 2), (True, 1), (True, 2))
ARCHS = {"dbrx": "dbrx-132b", "deepseek": "deepseek-v2-lite-16b"}
# the other families, plain, accum 1: (name, arch, config overrides,
# meshes). granite's vocabulary of 513 rows does not split over 2, and its
# one KV head is computed whole (MQA): both stay whole on 1 x 2
FAMILIES = (("granite", "granite-20b", {"vocab_size": 513}, ("1x2",)),
            ("starcoder2", "starcoder2-3b", {}, ("1x2",)),
            ("rwkv6", "rwkv6-7b", {}, ("1x2", "2x2")),
            ("recurrentgemma", "recurrentgemma-9b", {}, ("1x2",)),
            ("whisper", "whisper-base", {}, ("1x2", "2x2")),
            ("paligemma", "paligemma-3b", {}, ("1x2",)))
FAMILY_RUNS = tuple((name, mesh) for name, _, _, meshes in FAMILIES
                    for mesh in meshes)
# rwkv6's reduced training amplifies rounding: a 1e-7 relative change of
# its initial params moves the one-device trainer's grad norm 1.5e-5 at
# step 2 and 1.9e-5 at step 3 (tinyllama's 8e-8; probes/
# rwkv_sensitivity.py), so no implementation that rounds otherwise than
# JAX holds those norms to 1e-5. Its losses and step 1's norm keep 1e-5;
# its later norms are held here, and its gradients leaf by leaf below
LATER_NORM_TOL = {"rwkv6": 1e-3}
# the jobs whose first-step gradients are held leaf by leaf to the
# one-process port's (the families' too)
GRAD_JOBS = ("1x2/False/1", "2x2/False/1", "dbrx_1x2/False/1",
             "deepseek_1x2/False/1", "deepseek_2x2/False/1")
GRAD_RUNS = tuple(f"{n}_{m}/False/1" for n, m in FAMILY_RUNS) + GRAD_JOBS
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
# ZeRO-DP (tensor_parallel=False: every axis data-parallel, nothing split
# over "model"; the dry run's layout for a small model's train cell) on
# 2 x 2, plain, accum 1: (name, arch)
ZERO_RUNS = (("tiny", "tinyllama-1.1b"), ("whisper", "whisper-base"))
# (arch, mesh, accum) of the MoE runs, plain: dp 2 (global routing), model
# 2 (expert parallelism), both at once in the world of 4
MOE_RUNS = (("dbrx", "2x1", 1), ("dbrx", "2x1", 2), ("dbrx", "1x2", 1),
            ("deepseek", "2x1", 1), ("deepseek", "2x1", 2),
            ("deepseek", "1x2", 1), ("dbrx", "2x2", 1),
            ("deepseek", "2x2", 1))


def _inputs(arch, d, over=None):
    """The JAX model, its init, 3 batches of 4 x 16 tokens, and the path
    of the same params and batches saved for the ranks."""
    from repro_torch.interop import params_from_jax
    jm = JModel(jcfg_reduced(arch).replace(dtype=jnp.float32, attn_chunk=8,
                                           **(over or {})))
    jp0 = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    batches = [_batch(rng, jm.cfg.vocab_size, 4, 16, jm.cfg)
               for _ in range(3)]
    path = d / f"{arch}.pt"
    torch.save({"params": params_from_jax(jax.tree.map(np.asarray, jp0)),
                "batches": batches}, path)
    return jm, jp0, batches, str(path)


def _reference(jm, jp0, batches, cases=CASES):
    """JAX `build_train_step` (no mesh) for the 3 steps in each
    (compressed, accum) case."""
    set_activation_spec(None)
    runs = {}
    for compress, accum in cases:
        jo = JAdamW(lr=jcosine(1e-3, 1, 3))
        step = jax.jit(jbuild(jm, jo, JComp() if compress else None, accum))
        jp, js = jp0, jo.init(jp0)
        jcs = JComp().init(jp0) if compress else None
        rec = {"losses": [], "grad_norms": [], "lb_loss": [], "z_loss": []}
        for b in batches:
            jp, js, jcs, m = step(jp, js, jcs, jax.tree.map(jnp.asarray, b))
            rec["losses"].append(float(m["loss"]))
            rec["grad_norms"].append(float(m["grad_norm"]))
            for k in ("lb_loss", "z_loss"):
                if k in m:
                    rec[k].append(float(m[k]))
        rec["params"] = [np.asarray(x) for x in jax.tree.leaves(jp)]
        runs[(compress, accum)] = rec
    return runs


def _jobs_train(name, shape, names, inputs, arch="tinyllama-1.1b",
                cases=CASES, cfg=None):
    return [{"kind": "train", "name": f"{name}/{c}/{a}", "arch": arch,
             "shape": shape, "names": names, "inputs": inputs,
             "compress": c, "accum": a, "cfg": cfg} for c, a in cases]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this process's small tensors (the ranks pin
    their own), as the other port test files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds run while this process computes the JAX references:
    {"tiny", "dbrx": references; "world2", "world4": each rank's
    results; "one_losses": the one-device trainer's 4 steps; dirs}."""
    from repro_torch.launch import train
    d = tmp_path_factory.mktemp("sharded")
    d2, d4 = d / "world2", d / "world4"
    d2.mkdir()
    d4.mkdir()
    tiny = _inputs("tinyllama-1.1b", d)
    moe = {a: _inputs(ARCHS[a], d) for a in ARCHS}
    fam = {name: _inputs(arch, d, over)
           for name, arch, over, _ in FAMILIES}
    one_losses = train.main(TRAIN_ARGV + ["--steps", "4"])
    train.main(TRAIN_ARGV + ["--steps", "2", "--checkpoint-dir",
                             str(d / "one_device")])
    jobs2 = (_jobs_train("2x1", (2, 1), ("data", "model"), tiny[3])
             + _jobs_train("1x2", (1, 2), ("data", "model"), tiny[3])
             + [{"kind": "restart", "name": "restart", "dir": str(d2),
                 "one_device_dir": str(d / "one_device")},
                {"kind": "collectives", "name": "collectives", "world": 2}])
    jobs2[1]["ckpt"] = str(d2 / "ckpt")          # 2x1, plain, accum 2
    jobs4 = (_jobs_train("2x2", (2, 2), ("data", "model"), tiny[3])
             + _jobs_train("pod", (2, 2, 1), ("pod", "data", "model"),
                           tiny[3], cases=((False, 1), (True, 1)))
             + [{"kind": "collectives", "name": "collectives", "world": 4}])
    for a, mesh, accum in MOE_RUNS:
        jobs = jobs4 if mesh == "2x2" else jobs2
        jobs += _jobs_train(f"{a}_{mesh}", MESHES[mesh], ("data", "model"),
                            moe[a][3], ARCHS[a], ((False, accum),))
    for name, arch, over, meshes in FAMILIES:
        for mesh in meshes:
            (jobs4 if mesh == "2x2" else jobs2).extend(_jobs_train(
                f"{name}_{mesh}", MESHES[mesh], ("data", "model"),
                fam[name][3], arch, ((False, 1),), over))
            (jobs4 if mesh == "2x2" else jobs2)[-1]["grads"] = True
    for name, arch in ZERO_RUNS:
        jobs4.extend(_jobs_train(f"zero_{name}", (2, 2), ("data", "model"),
                                 (tiny if name == "tiny" else fam[name])[3],
                                 arch, ((False, 1),)))
        jobs4[-1].update(tp=False, grads=True)
    for jobs in (jobs2, jobs4):
        for job in jobs:
            if job["name"] in GRAD_JOBS:
                job["grads"] = True
    started = [_start(2, jobs2, d2), _start(4, jobs4, d4)]
    try:
        refs = {"tiny": _reference(*tiny[:3])}
        for a in ARCHS:
            refs[a] = _reference(*moe[a][:3], cases=sorted(
                {(False, accum) for b, _, accum in MOE_RUNS if b == a}))
        for name in fam:
            refs[name] = _reference(*fam[name][:3], cases=((False, 1),))
    finally:
        worlds = [_finish(w) for w in started]
    return dict(refs, world2=worlds[0], world4=worlds[1],
                one_losses=one_losses, dir=d2, ckpt=str(d2 / "ckpt"))


def _flips(got, want):
    """Elements whose error-feedback residuals differ by more than a
    thousandth of the leaf's largest residual: a code that flipped."""
    n = 0
    for a, b in zip(got, want):
        tol = 1e-3 * float(b.abs().max())
        n += int(((a - b).abs() > tol).sum())
    return n


def _hold(res, ref, what, params_tol=True):
    rtol = 1e-4 if what.split("/")[1] == "True" else 1e-5
    for k in ("losses", "grad_norms"):
        np.testing.assert_allclose(res[k], ref[k], rtol=rtol,
                                   err_msg=f"{what} {k}")
    if params_tol:
        _chip_smoke().train_params_close(ref["params"], res["params"],
                                         sum(res["lrs"]), what)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_world2_train_matches_reference(runs, mesh, compress, accum):
    """3 sharded steps on the 2 x 1 (dp 2) and 1 x 2 (storage over the
    model axis) meshes against the JAX step; every rank reports the same
    loss and grad norm; compressed, the codes that flipped against the
    one-process port are few."""
    name = f"{mesh}/{compress}/{accum}"
    res = [r[name] for r in runs["world2"]]
    _hold(res[0], runs["tiny"][(compress, accum)], name)
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["grad_norms"] == res[1]["grad_norms"]
    if compress:
        n = sum(e.numel() for e in res[0]["residual"])
        flips = _flips(res[0]["residual"], res[0]["one_process_residual"])
        assert flips <= 1e-3 * n, (flips, n)


def test_1x2_first_loss_matches_one_process(runs):
    """Each rank of the 1 x 2 mesh computes its heads, its d_ff columns and
    its half of the vocabulary, the row products' f32 partials summed over
    the model axis in another order than one process adds them: step 1's
    loss is the one-process port's within 1e-6 (f32), in every case."""
    for c in (False, True):
        for a in (1, 2):
            r = runs["world2"][0][f"1x2/{c}/{a}"]
            np.testing.assert_allclose(r["losses"][0], r["one_process_loss"],
                                       rtol=1e-6, err_msg=f"{c} {a}")


def _products(res):
    """{site: the set of weight shapes its products took} of a job."""
    out = {}
    for site, shape in res["dense_shapes"]:
        out.setdefault(site, set()).add(shape)
    return out


def test_dense_products_take_their_block(runs):
    """The products each rank runs in a step (`_DenseSpy`). Reduced
    tinyllama on 1 x 2: q, k, v, up and gate take d_out / 2 columns, wo
    and down d_in / 2 rows, the LM head V / 2 columns (Megatron's column
    and row products, a vocab-parallel head); on 2 x 1 every product is
    whole. Reduced granite (one KV head, a 513-row vocabulary) on 1 x 2:
    q, wo, up and down split, k, v and the head whole."""
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config("tinyllama-1.1b")
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    whole = {"attn_q": (D, qd), "attn_k": (D, kvd), "attn_v": (D, kvd),
             "attn_out": (qd, D), "ffn_up": (D, F), "ffn_gate": (D, F),
             "ffn_down": (F, D), "lm_head": (D, V)}
    half = {"attn_q": (D, qd // 2), "attn_k": (D, kvd // 2),
            "attn_v": (D, kvd // 2), "attn_out": (qd // 2, D),
            "ffn_up": (D, F // 2), "ffn_gate": (D, F // 2),
            "ffn_down": (F // 2, D), "lm_head": (D, V // 2)}
    for mesh, want in (("1x2", half), ("2x1", whole)):
        for r in runs["world2"]:
            got = _products(r[f"{mesh}/False/1"])
            assert got == {k: {v} for k, v in want.items()}, (mesh, got)
    g = get_reduced_config("granite-20b")
    D, F, qd = g.d_model, g.d_ff, g.n_heads * g.head_dim
    kvd = g.n_kv_heads * g.head_dim
    want = {"attn_q": (D, qd // 2), "attn_k": (D, kvd), "attn_v": (D, kvd),
            "attn_out": (qd // 2, D), "ffn_up": (D, F // 2),
            "ffn_down": (F // 2, D), "lm_head": (D, 513)}
    for r in runs["world2"]:
        got = _products(r["granite_1x2/False/1"])
        assert got == {k: {v} for k, v in want.items()}, got


@pytest.mark.parametrize("name,mesh", FAMILY_RUNS,
                         ids=[f"{n}-{m}" for n, m in FAMILY_RUNS])
def test_family_train_matches_reference(runs, name, mesh):
    """Reduced granite (MQA k / v and a 513-row vocabulary, whole),
    starcoder2, rwkv6 (heads of the time mix, the channel mix's gate
    gathered), recurrentgemma (the RG-LRU's channels, its gates
    reduce-scattered; MQA local attention), whisper (the encoder and the
    cross attention on heads) and paligemma (MQA behind an image prefix)
    on 1 x 2, and rwkv6 and whisper on 2 x 2: 3 steps against JAX's step
    without a mesh, every rank's losses and grad norms equal."""
    job = f"{name}_{mesh}/False/1"
    res = [r[job] for r in runs["world4" if mesh == "2x2" else "world2"]]
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"], job
        assert r["grad_norms"] == res[0]["grad_norms"], job
    got, ref = res[0], runs[name][(False, 1)]
    if name in LATER_NORM_TOL:
        np.testing.assert_allclose(got["grad_norms"][1:],
                                   ref["grad_norms"][1:],
                                   rtol=LATER_NORM_TOL[name], err_msg=job)
        got = dict(got, grad_norms=got["grad_norms"][:1])
        ref = dict(ref, grad_norms=ref["grad_norms"][:1])
    _hold(got, ref, job)


@pytest.mark.parametrize("job", GRAD_RUNS)
def test_split_gradients_match_one_process(runs, job):
    """The first batch's gradient of every leaf, on every rank, through
    the model axis's split products and the gather's backward (a
    reduce-scatter over dp), against the same block of the one-process
    port's gradient: within 1e-5 of the leaf's largest element. The hazard
    it guards: a product computed whole whose output each rank uses in
    part (MQA k / v, RWKV's decay LoRA and vectors, the RG-LRU's lam,
    MLA's latent) must have its gradient summed over the model axis once
    and only once; neither a missing nor a doubled sum raises."""
    world = "world4" if "2x2" in job else "world2"
    for r, res in enumerate(runs[world]):
        errs = res[job]["grad_errs"]
        assert len(errs) == len(res[job]["params"])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-5, (job, r, worst, errs[worst])


@pytest.mark.parametrize("name", [n for n, _ in ZERO_RUNS])
def test_zero_dp_matches_reference(runs, name):
    """ZeRO-DP on 2 x 2 (`FSDP(..., tensor_parallel=False)` over
    `param_pspecs(..., tensor_parallel=False)`): a rank's rows are its
    block over both axes, every leaf is gathered whole over the merged
    group (the 2-layer stacks, which the ZeRO rules split on their layer
    axis over "model", once a step with the leaves outside the layers),
    and no product splits. 3 steps against JAX's step without a mesh at
    the sharded tolerances, every rank's losses and norms equal, and the
    first batch's gradient of every leaf on every rank within 1e-5 of
    the one-process port's block."""
    job = f"zero_{name}/False/1"
    res = [r[job] for r in runs["world4"]]
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"], job
        assert r["grad_norms"] == res[0]["grad_norms"], job
    _hold(res[0], runs[name][(False, 1)], job)
    for r, one in enumerate(res):
        worst = max(one["grad_errs"], key=one["grad_errs"].get)
        assert one["grad_errs"][worst] <= 1e-5, (job, r, worst)


def _hold_moe(runs, arch, mesh, accum):
    """`_hold` plus the load-balance and z terms (reported at accum 1,
    the JAX step's metrics), every rank's losses and norms equal."""
    name = f"{arch}_{mesh}/False/{accum}"
    res = [r[name] for r in runs["world4" if mesh == "2x2" else "world2"]]
    ref = runs[arch][(False, accum)]
    _hold(res[0], ref, name)
    assert len(res[0]["lb_loss"]) == len(ref["lb_loss"]) == \
        (3 if accum == 1 else 0), name
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(res[0][k], ref[k], rtol=1e-5,
                                   err_msg=f"{name} {k}")
    for r in res[1:]:
        for k in ("losses", "grad_norms", "lb_loss", "z_loss"):
            assert r[k] == res[0][k], (name, k)
    return res


def test_dbrx_on_1x2_matches_reference(runs):
    """Reduced dbrx (stacked experts under (None, model, data, None), the
    load-balance and z terms in the loss) on the 1 x 2 mesh: each rank
    runs its 2 of the 4 experts over the same rows and the partial
    outputs are summed over the model axis."""
    _hold_moe(runs, "dbrx", "1x2", 1)


@pytest.mark.parametrize("arch,mesh,accum", [
    r for r in MOE_RUNS if r[:2] != ("dbrx", "1x2")],
    ids=[f"{a}-{m}-{c}" for a, m, c in MOE_RUNS if (a, m) != ("dbrx",
                                                             "1x2")])
def test_moe_train_matches_reference(runs, arch, mesh, accum):
    """Reduced dbrx and deepseek (an MLA dense layer, then MoE layers with
    a shared expert) on dp 2 (routing, capacity and the load-balance
    density over the whole microbatch), model 2 (expert parallelism) and
    2 x 2: 3 steps against the JAX step without a mesh, the aux terms
    the reference's global values."""
    _hold_moe(runs, arch, mesh, accum)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_routing_is_global_over_dp(runs, arch):
    """On 2 x 1 the two ranks' kept assignments, laid end to end, are the
    one-process slot table's over the whole microbatch, layer by layer.
    The inputs make this a test: some expert overflows the global C, and
    capacity taken per rank (each rank's own C, slots from 0) would keep
    another set of assignments."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import moe
    cfg = get_reduced_config(ARCHS[arch])
    calls = [r[f"{arch}_2x1/False/1"]["routing"] for r in runs["world2"]]
    assert calls[0] and len(calls[0]) == len(calls[1])
    per_rank_differs = overflow = False
    for a, b in zip(*calls):
        ids = torch.cat([a["ids"], b["ids"]])
        C = moe.capacity(ids.shape[0], cfg, False)
        assert a["C"] == b["C"] == C
        want_total = moe.expert_counts(ids, cfg.n_experts)
        assert torch.equal(a["total"], want_total)
        assert torch.equal(b["before"], moe.expert_counts(a["ids"],
                                                          cfg.n_experts))
        _, kept = moe.slot_assignments(ids, cfg.n_experts, C)
        assert torch.equal(torch.cat([a["kept"], b["kept"]]), kept)
        overflow |= bool((want_total > C).any())
        c_rank = moe.capacity(a["ids"].shape[0], cfg, False)
        alone = torch.cat([moe.slot_assignments(x["ids"], cfg.n_experts,
                                                c_rank)[1] for x in (a, b)])
        per_rank_differs |= not torch.equal(alone, kept)
    assert overflow and per_rank_differs


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_expert_products_take_their_block(runs, arch):
    """On 1 x 2 every routed expert product of either rank takes banks of
    E / 2 experts, never all E (expert parallelism, not replicated
    compute); on 2 x 1 it takes all E. deepseek's shared experts are one
    fused expert [1, D, F x S], gathered whole on every rank."""
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config(ARCHS[arch])
    E = cfg.n_experts
    for mesh, routed in (("1x2", E // 2), ("2x1", E)):
        for r in runs["world2"]:
            shapes = r[f"{arch}_{mesh}/False/1"]["bank_shapes"]
            lead = [sh[0] for sh in shapes]
            assert lead.count(routed) > 0, (mesh, shapes)
            assert set(lead) <= {routed, 1}, (mesh, shapes)
            assert lead.count(1) == (len(lead) // 2
                                     if cfg.n_shared_experts else 0)
            assert all(sh[1:] == (cfg.d_model, cfg.moe_d_ff)
                       for sh in shapes if sh[0] == routed), shapes


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_world4_train_matches_reference(runs, compress, accum):
    """The 2 x 2 mesh: dp 2 and storage over model 2 at once."""
    name = f"2x2/{compress}/{accum}"
    res = [r[name] for r in runs["world4"]]
    _hold(res[0], runs["tiny"][(compress, accum)], name)
    assert all(r["losses"] == res[0]["losses"] for r in res)


@pytest.mark.parametrize("compress", [False, True])
def test_pod_mesh_matches_reference(runs, compress):
    """The (pod 2, data 2, model 1) mesh: rows over four dp ranks, the
    gradient reduced through `hierarchical_psum`."""
    name = f"pod/{compress}/1"
    _hold(runs["world4"][0][name], runs["tiny"][(compress, 1)], name)


def test_restart_on_mesh_is_bit_exact(runs):
    """`train.main` on the 2 x 1 mesh: 2 steps, a save, a restore and 2
    more equal 4 straight, losses and every saved leaf bit for bit."""
    r = runs["world2"][0]["restart"]
    assert r["first"] + r["resumed"] == r["straight"]
    d = runs["dir"]
    with open(d / "straight" / "step_00000004" / "manifest.json") as f:
        keys = json.load(f)["leaves"]
    assert len(keys) == 36          # params, m and v: 12 leaves each
    for key, meta in keys.items():
        a = np.load(d / "straight" / "step_00000004" / meta["file"])
        b = np.load(d / "half" / "step_00000004" / meta["file"])
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_restores_cross_layouts(runs):
    """A 2 x 1 checkpoint resumed on the 1 x 2 mesh, and a one-device
    checkpoint resumed on 2 x 1, continue the straight run's losses. The
    trainer's reduced config computes in bf16, and another row split
    rounds other products: 1e-4 relative, the card phase's tolerance."""
    r = runs["world2"][0]["restart"]
    np.testing.assert_allclose(r["resumed_mp"], r["straight"][2:],
                               rtol=1e-4)
    np.testing.assert_allclose(r["from_one_device"],
                               runs["one_losses"][2:], rtol=1e-4)
    np.testing.assert_allclose(r["straight"], runs["one_losses"],
                               rtol=1e-4)


def test_mesh_checkpoint_restores_whole(runs):
    """The state saved on the 2 x 1 mesh after 3 steps restores in one
    process (the port's `restore`) and in the JAX package's to the same
    whole leaves, which hold every rank's blocks at its slices; a rank's
    restore onto blocks gives back its own."""
    import types

    from repro_torch.checkpoint import manager as tckpt
    from repro_torch.distributed.sharding import block_slices, param_pspecs
    from repro_torch.models.model import Model
    ranks = [r["2x1/False/2"] for r in runs["world2"]]
    assert all(r["restored_equal"] for r in ranks)
    tp = Model(_cfg("tinyllama-1.1b"), device="cpu").init_params(
        0, dtype=torch.float32)
    got = tckpt.restore(runs["ckpt"], 3, {"params": tp, "m": tp, "v": tp})
    jp = JModel(jcfg_reduced("tinyllama-1.1b")).init_params(
        jax.random.PRNGKey(0))
    jgot = jckpt.restore(runs["ckpt"], 3, {"params": jp, "m": jp,
                                            "v": jp})
    for a, b in zip(T.leaves(got), jax.tree.leaves(jgot), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 1},
                                 axis_names=("data", "model"))
    specs = param_pspecs(tp, mesh)
    whole = {T.path_key(p): x for p, x in
             T.flatten_with_path(got["params"])}
    for r in ranks:
        assert r["keys"] == list(specs)
        for key, block in zip(r["keys"], r["blocks"], strict=True):
            sl = block_slices(tuple(whole[key].shape), specs[key], mesh,
                              r["coord"])
            assert torch.equal(whole[key][sl], block), key


def test_collectives_world2(runs):
    """`compressed_psum` over 2 ranks equals the sum of the JAX package's
    `sparq_compress` of their inputs bit for bit; `unshard_leaf` rebuilds
    every spec's leaf exactly."""
    r = runs["world2"][0]["collectives"]
    want = sum(np.asarray(jcompress(jnp.asarray(_rank_input(k))))
               for k in range(2))
    np.testing.assert_array_equal(r["compressed"].numpy(), want)
    assert all(ok for _, _, ok in r["round_trip"])
    _hold_pair(runs["world2"])


def _hold_model_axis(ranks, rtol):
    """`gather_from` and `reduce_scatter_to` over the world's one group,
    along dims 0 and 1, against numpy: outputs and x's gradients (the
    rank's block of its w after a gather; every rank's w side by side
    after a reduce-scatter)."""
    n = len(ranks)
    xs = [_rank_input(r)[:8, :12] for r in range(n)]
    for (name, dim) in ranks[0]["collectives"]["model_axis"]:
        ws = [_rank_weight(r, tuple(res["collectives"]["model_axis"][
            (name, dim)][0].shape)) for r, res in enumerate(ranks)]
        for r, res in enumerate(ranks):
            y, gx = res["collectives"]["model_axis"][(name, dim)]
            if name == "gather":
                want_y = np.concatenate(xs, dim)
                want_g = np.split(ws[r], n, dim)[r]
            else:
                want_y = np.split(np.sum(xs, 0), n, dim)[r]
                want_g = np.concatenate(ws, dim)
            np.testing.assert_allclose(y.numpy(), want_y, rtol=rtol,
                                       atol=1e-6, err_msg=f"{name} {dim}")
            np.testing.assert_array_equal(gx.numpy(), want_g)


def _hold_block_grads(ranks, exact):
    """The gather's backward (reduce-scatter over dp) against the dp
    all-reduce mean, then the block's slice: bit for bit (`exact`), else
    within 1e-6."""
    for res in ranks:
        got = res["collectives"]["block_grads"]
        assert got
        for names, spec, a, b in got:
            assert a.shape == b.shape, (names, spec)
            if exact:
                assert torch.equal(a, b), (names, spec)
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=1e-7,
                                           err_msg=f"{names} {spec}")


def test_model_axis_collectives_world2(runs):
    """At 2 ranks: `gather_from` and `reduce_scatter_to` forward and
    backward against the whole computation; the gather's backward
    (`FSDP.block_grad`, a reduce-scatter over dp) equals the all-reduce
    mean then the slice bit for bit, on every spec of the 2 x 1 mesh."""
    _hold_model_axis(runs["world2"], 1e-6)
    _hold_block_grads(runs["world2"], exact=True)


def _hold_pair(ranks):
    """`copy_to` then `reduce_from` over the world, each rank's part the
    same x times rank + 2: every rank holds Σ (r + 2) x, and x's gradient
    under the loss Σ s w is Σ (r + 2) w (each rank's backward through its
    own part, summed), on every rank."""
    k = sum(r + 2 for r in range(len(ranks)))
    x, w = _rank_input(0)[:4], _rank_input(1)[:4]
    for res in ranks:
        s, gx = res["collectives"]["pair"]
        np.testing.assert_allclose(s.numpy(), k * x, rtol=1e-6)
        np.testing.assert_allclose(gx.numpy(), k * w, rtol=1e-6)


def test_collectives_world4(runs):
    """At 4 ranks `compressed_psum` equals the sum of JAX's compressions up
    to the order of summation, which is gloo's: within 2 ulp of the sum
    of the terms' magnitudes (where terms cancel, more ulp of the result
    itself); `hierarchical_psum` over (pod 2, data 2) equals numpy's sum
    (exactly on integer values); `unshard_leaf` rebuilds every leaf on the
    2 x 2 and the pod mesh, merged axis tuples among the specs."""
    r = runs["world4"][0]["collectives"]
    parts = np.stack([np.asarray(jcompress(jnp.asarray(_rank_input(k))))
                      for k in range(4)])
    err = np.abs(r["compressed"].numpy() - np.sum(parts, 0))
    assert (err <= 2 * np.spacing(np.sum(np.abs(parts), 0))).all()
    xs = [_rank_input(k) for k in range(4)]
    np.testing.assert_allclose(r["hierarchical"].numpy(),
                               np.sum(xs, 0), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        r["hierarchical_int"].numpy(),
        np.sum([np.round(x * 8) for x in xs], 0))
    assert len(r["round_trip"]) == len(SPECS) + len(POD_SPECS)
    assert all(ok for _, _, ok in r["round_trip"])
    _hold_pair(runs["world4"])


def test_model_axis_collectives_world4(runs):
    """At 4 ranks: `gather_from` and `reduce_scatter_to` against numpy
    (the sum within 1e-6, gloo's order); the gather's backward against
    the dp mean then the slice within 1e-6 on the 2 x 2 mesh (dp 2, model
    2) and the (pod 2, data 2) mesh, where the sum runs over "data",
    then "pod"."""
    _hold_model_axis(runs["world4"], 1e-6)
    _hold_block_grads(runs["world4"], exact=False)


def test_layers_flag_cuts_depth(tmp_path):
    """`--layers N` keeps the config's first N layers at full width (the
    card phase's depth cut): the saved stack holds N layers."""
    from repro_torch.launch import train
    losses = train.main(TRAIN_ARGV + ["--layers", "1", "--steps", "1",
                                      "--checkpoint-dir", str(tmp_path)])
    assert len(losses) == 1 and np.isfinite(losses[0])
    wq = np.load(tmp_path / "step_00000001"
                 / "params__blocks__0__attn__wq.npy")
    assert wq.shape[0] == 1
