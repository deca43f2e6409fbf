"""The dry run (port of `repro.launch.dryrun`): what every (architecture
x input shape) cell costs one rank of the production meshes, 16 x 16
("data", "model") over 256 ranks and 2 x 16 x 16 ("pod", "data", "model")
over 512, with nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out report.json

Runs on the CPU; no card is needed or used. Per cell, a record with the
reference's keys:

  * **train cells** run the port's own sharded train step
    (`launch.train.build_train_step` over `distributed.fsdp.FSDP`, with
    `cfg.train_microbatches` and the params in `cfg.param_dtype`) for
    rank 0 on the meta device, under torch's "fake" process group of 256
    or 512 ranks: every collective is issued and returns at once, no
    tensor holds data. `flops_per_device` is `FlopCounterMode`'s count of
    the step (aten matmul / conv / attention only: elementwise work is not
    counted), `collective_bytes_per_device` the bytes of each collective's
    result on the rank by kind (`distributed.comm.counting`), and
    `memory.argument_bytes` the rank's params, AdamW m and v and batch
    rows, from `param_pspecs` and `batch_pspecs`. The layout follows the
    reference's rule: ZeRO-DP (every axis data-parallel, no product
    split) for a train cell of a config with `tensor_parallel=False`
    whose global batch divides the ranks, else the tensor-parallel one.
  * **prefill and decode cells** cannot run on meta (the kernel dispatch
    takes CPU and CUDA tensors only, `kernels/ops.py`), so they are
    counted from the specs alone: the int8 serving weights
    (`models.quantize.quantize_params` on meta) under `param_pspecs`, the
    bf16 fp cache of `Model.init_cache(B, S + 16)` under `cache_pspecs`,
    and the batch. Their FLOPs and collective bytes are null, with the
    reason in the record.
  * `long_500k` on a full-attention arch is skipped with the reference's
    reason.

Keys the reference fills from XLA that have no counterpart here
(`bytes_per_device`, `hlo_full`, `memory.temp_bytes`,
`memory.generated_code_bytes`) are null; `trace_s` (the host seconds of
the meta step) stands in for `lower_s` / `compile_s`. `origin` names the
source of each figure ("counted on meta, CPU", "from specs", "analytic"),
and `fits` holds the rank's argument bytes against an H100 80GB HBM3's
80 GB. A tensor-parallel train cell runs with sequence parallelism, as
the reference's does (`sp` true in its record; `--no-sp` turns it off):
the residual stream between the blocks is split over T on "model"
(`FSDP(..., sp=True)`). A cell where the model axis does not divide the T
of one of its streams runs without it (`sp` false). Every number is a
count made on the CPU, never a time on a device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import (ARCHS, SHAPES, ShapeSpec,
                                      cell_is_runnable, get_config,
                                      input_specs)
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import Model, stream_lengths

#: an H100 80GB HBM3's memory, the bound `fits` holds a rank's arguments to
HBM_BYTES = 80 * 10 ** 9
HBM_DEVICE = "NVIDIA H100 80GB HBM3"

FLOPS_COUNTED = "aten matmul/conv/attention only"
ON_META = "counted on meta, CPU"
FROM_SPECS = "from specs"
ANALYTIC = "analytic"
SERVING_NOT_TRACED = (
    "prefill and decode cells are not traced: the kernel dispatch takes "
    "CPU and CUDA tensors only (kernels/ops.py), so a serving step cannot "
    "run on the meta device; bytes are counted from the specs")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """The fields the spec functions read of a mesh: each axis's size and
    the axis names, major to minor."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())


def layout_of(dims: Tuple[int, ...]) -> MeshShape:
    """("data", "model") for two dims, ("pod", "data", "model") for three."""
    names = ("pod", "data", "model")[-len(dims):]
    return MeshShape(dict(zip(names, dims)), names)


def production_layout(multi_pod: bool = False) -> MeshShape:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"): `launch.mesh.make_production_mesh`'s axes, without ranks."""
    return layout_of((2, 16, 16) if multi_pod else (16, 16))


def uses_tensor_parallel(cfg, shape: ShapeSpec, mesh) -> bool:
    """The reference's rule (`dryrun.py:160`): ZeRO-DP only helps
    training (big global batch); serving keeps the TP layout so small
    request batches still shard the model axis, and ZeRO needs the
    global batch to divide the ranks."""
    world = math.prod(mesh.shape.values())
    return bool(cfg.tensor_parallel or shape.kind != "train"
                or shape.global_batch % world != 0)


# ---------------------------------------------------------------------
# analytic figures
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _param_counts(cfg) -> Tuple[int, int, int]:
    """(all params, the routed experts', the embeddings') of a config,
    from the shapes of meta params."""
    total = routed = embed = 0
    for path, leaf in T.flatten_with_path(
            Model(cfg, device="meta").init_params()):
        name = str(path[-1])
        total += leaf.numel()
        if "embed" in name:
            embed += leaf.numel()
        # stacked routed experts are 4-D [L, E, din, dout]
        if leaf.dim() == 4 and any(
                k in name for k in ("w_up", "w_gate", "w_down")):
            routed += leaf.numel()
    return total, routed, embed


def model_stats(cfg, shape: ShapeSpec) -> Dict[str, float]:
    """Analytic N_total / N_active / MODEL_FLOPS (6 N D train, 2 N D
    inference; MoE counts active params: shared + top-k of the routed
    experts; embeddings excluded unless tied) and a first-order HBM
    traffic model of a step (global bytes), from the shapes of meta
    params: the reference's arithmetic, term for term."""
    total, routed, embed = _param_counts(cfg)
    n_total = total - (0 if cfg.tie_embeddings else embed)
    active_frac = (cfg.experts_per_token / cfg.n_experts) \
        if cfg.n_experts else 1.0
    n_active = n_total - routed * (1.0 - active_frac)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2

    pd = 2 if cfg.param_dtype == torch.bfloat16 else 4
    P = total
    layers = cfg.n_layers + cfg.n_enc_layers
    d = cfg.d_model
    cache_per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * 2  # k+v bf16
    if cfg.kv_lora_rank:
        cache_per_tok = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    if cfg.family == "rwkv6":
        cache_per_tok = 0   # O(1) state
    if shape.kind == "train":
        accum = cfg.train_microbatches
        weight_traffic = 3 * P * pd * accum      # fwd + remat + bwd reads
        opt_traffic = P * 4 * (1 + 4)            # grads w + m,v r/w
        act_traffic = 4 * tokens * d * 2 * layers  # boundaries + attn io
        hbm = weight_traffic + opt_traffic + act_traffic
    elif shape.kind == "prefill":
        hbm = P * 1 + tokens * cache_per_tok * layers \
            + 4 * tokens * d * 2 * layers        # int8 weights (serving)
    else:  # decode: weight + cache read dominate
        T_ctx = shape.seq_len
        cache_rw = shape.global_batch * T_ctx * cache_per_tok * layers
        if cfg.family == "rglru":
            # only 1/3 of layers are (windowed) attention
            cache_rw = shape.global_batch * min(T_ctx, cfg.local_window) * \
                2 * cfg.n_kv_heads * cfg.head_dim * 2 * (layers // 3)
        hbm = P * 1 + cache_rw
    return {"n_total": int(total), "n_active": int(n_active),
            "tokens": int(tokens),
            "model_flops": float(mult * n_active * tokens),
            "analytic_hbm_bytes": float(hbm)}


# ---------------------------------------------------------------------
# a rank's bytes from the specs
# ---------------------------------------------------------------------

def tree_rank_bytes(tree: Any, specs: Dict[str, Any], mesh,
                    dtype: Optional[torch.dtype] = None) -> int:
    """One rank's bytes of `tree` under `specs` ({`tree.path_key`: spec}),
    each leaf in its own dtype or in `dtype`."""
    total = 0
    for path, leaf in T.flatten_with_path(tree):
        if dtype is not None:
            leaf = torch.empty(leaf.shape, dtype=dtype, device="meta")
        total += shd.block_bytes(leaf, specs[T.path_key(path)], mesh)
    return total


def train_state_bytes(cfg, mesh, tensor_parallel: bool = True,
                      param_dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, int]:
    """A rank's training state under `param_pspecs` on `mesh` (anything
    with `shape` and `axis_names`; no process group): {"params" (in
    `param_dtype`, default `cfg.param_dtype`), "opt_state" (AdamW's f32 m
    and v, and its int32 step count), "total"}."""
    dtype = cfg.param_dtype if param_dtype is None else param_dtype
    shapes = Model(cfg, device="meta").init_params(dtype=dtype)
    specs = shd.param_pspecs(shapes, mesh, tensor_parallel)
    params = tree_rank_bytes(shapes, specs, mesh)
    opt = 2 * tree_rank_bytes(shapes, specs, mesh, torch.float32) + 4
    return {"params": params, "opt_state": opt, "total": params + opt}


def batch_rank_bytes(batch: Dict[str, torch.Tensor], mesh,
                     tensor_parallel: bool) -> int:
    specs = shd.batch_pspecs(batch, mesh, tensor_parallel)
    return sum(shd.block_bytes(v, specs[k], mesh) for k, v in batch.items())


# ---------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """torch's "fake" process group of `world` ranks for this process, as
    rank 0: collectives are issued and return at once, moving nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is already running in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_train_step(cfg, layout: MeshShape, tensor_parallel: bool,
                     batch: Dict[str, torch.Tensor],
                     sp: bool = False) -> Dict[str, Any]:
    """The port's sharded train step (`build_train_step` over `FSDP`,
    `cfg.train_microbatches`, params in `cfg.param_dtype`, sequence
    parallel with `sp`) for rank 0 on the meta device under a fake group
    of `layout`'s ranks, on the global `batch` (meta tensors). Returns
    {"flops" (`FlopCounterMode`'s total),
    "kinds" and "sites" (collective bytes, `comm.Traffic`), "trace_s",
    "metric_bytes" (the step's metrics)}."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.fsdp import FSDP
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_train_step
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    model = Model(cfg, device="meta")
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
    with fake_world(layout.world):
        mesh = make_mesh(tuple(layout.shape.values()), layout.axis_names,
                         "meta")
        shapes = model.init_params(dtype=cfg.param_dtype)
        specs = shd.param_pspecs(shapes, mesh, tensor_parallel)
        fsdp = FSDP(mesh, specs, cfg, tensor_parallel=tensor_parallel,
                    sp=sp)
        params = model.init_params(dtype=cfg.param_dtype,
                                   blocks=fsdp.slices)
        state = opt.init(params)
        step = build_train_step(model, opt, fsdp=fsdp)
        t0 = time.perf_counter()
        with comm.counting() as traffic, \
                FlopCounterMode(display=False) as flops:
            metrics = step(params, state, None, batch)[3]
        trace_s = time.perf_counter() - t0
    return {"flops": float(flops.get_total_flops()),
            "kinds": dict(traffic.kinds),
            "sites": {k: dict(v) for k, v in traffic.sites.items()},
            "trace_s": trace_s,
            "metric_bytes": sum(v.numel() * v.element_size()
                                for v in metrics.values())}


def _train_cell(cfg, shape: ShapeSpec, layout: MeshShape, tp: bool,
                sp: bool) -> Dict:
    """A train cell's counted fields: the traced step, the rank's state
    and batch bytes from the specs."""
    batch = input_specs(cfg, shape)
    run = trace_train_step(cfg, layout, tp, batch, sp)
    state_b = train_state_bytes(cfg, layout, tp)
    batch_b = batch_rank_bytes(batch, layout, tp)
    return {
        "trace_s": round(run["trace_s"], 1),
        "flops_per_device": run["flops"],
        "collective_bytes_per_device": run["kinds"],
        "collective_bytes_by_site": run["sites"],
        "memory": {"argument_bytes": state_b["total"] + batch_b,
                   "output_bytes": state_b["total"] + run["metric_bytes"],
                   "temp_bytes": None, "generated_code_bytes": None,
                   "params_bytes": state_b["params"],
                   "opt_state_bytes": state_b["opt_state"],
                   "batch_bytes": batch_b},
        "origin": {"flops_per_device": ON_META,
                   "collective_bytes_per_device": ON_META,
                   "memory": FROM_SPECS, "model_stats": ANALYTIC},
    }


def _serving_cell(cfg, shape: ShapeSpec, layout: MeshShape) -> Dict:
    """A prefill or decode cell's bytes on one rank from the specs (TP
    layout): int8 weights, the bf16 fp cache of S + 16 tokens, the batch;
    outputs the cache and the greedy tokens."""
    from repro_torch.models.quantize import quantize_params
    model = Model(cfg, device="meta")
    t0 = time.perf_counter()
    params = quantize_params(model.init_params(dtype=torch.float32))
    specs = shd.param_pspecs(params, layout, tensor_parallel=True)
    params_b = tree_rank_bytes(params, specs, layout)
    # (+16 pad keeps the time axis divisible by the 16-way model axis)
    caches = model.init_cache(shape.global_batch, shape.seq_len + 16)
    cspecs = shd.cache_pspecs(caches, model, layout, tensor_parallel=True)
    cache_b = sum(shd.block_bytes(leaf, cspecs[T.path_key(p)], layout)
                  for p, leaf in shd.cache_leaves(caches))
    batch = input_specs(cfg, shape)
    batch_b = batch_rank_bytes(batch, layout, True)
    toks = {"tokens": torch.empty((shape.global_batch,), dtype=torch.int32,
                                  device="meta")}
    out_b = cache_b + batch_rank_bytes(toks, layout, True)
    return {
        "trace_s": round(time.perf_counter() - t0, 1),
        "flops_per_device": None,
        "collective_bytes_per_device": None,
        "reason": SERVING_NOT_TRACED,
        "memory": {"argument_bytes": params_b + cache_b + batch_b,
                   "output_bytes": out_b,
                   "temp_bytes": None, "generated_code_bytes": None,
                   "params_bytes": params_b, "cache_bytes": cache_b,
                   "batch_bytes": batch_b},
        "origin": {"memory": FROM_SPECS, "model_stats": ANALYTIC},
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             sp: bool = True) -> Dict[str, Any]:
    """One cell's record: "ok", "skipped" (the reference's reason) or
    "error" (a dry-run failure is a fault of the port)."""
    ok, reason = cell_is_runnable(arch, shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    try:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        layout = production_layout(multi_pod)
        tp = uses_tensor_parallel(cfg, shape, layout)
        # SP where the model axis divides every stream's T; else the
        # split drops, as `fit_spec` drops it, and the record says false
        sp = bool(sp and tp and shape.kind == "train") and all(
            t % layout.shape["model"] == 0
            for _, t in stream_lengths(cfg, input_specs(cfg, shape)))
        rec.update(tensor_parallel=tp, sp=sp)
        counted = _train_cell(cfg, shape, layout, tp, sp) \
            if shape.kind == "train" else _serving_cell(cfg, shape, layout)
        arg = counted["memory"]["argument_bytes"]
        rec.update(
            status="ok",
            flops_counted=FLOPS_COUNTED if shape.kind == "train" else None,
            bytes_per_device=None,
            model_stats=model_stats(cfg, shape),
            hlo_full=None,
            fits={"device": HBM_DEVICE, "hbm_bytes": HBM_BYTES,
                  "argument_bytes": arg, "ok": arg <= HBM_BYTES},
            **counted)
    except Exception as e:  # a dry-run failure is a bug in the system
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def _gib(x) -> str:
    return "null" if x is None else f"{x / 2 ** 30:.2f}GiB"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="per-rank bytes, FLOPs and collective bytes of every "
                    "arch x shape cell on the production meshes, counted "
                    "on the CPU (meta device, fake process group)")
    ap.add_argument("--arch", choices=list(ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable the sequence-parallel residual stream "
                         "of the tensor-parallel train cells")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    t_all = time.perf_counter()
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp, sp=not args.no_sp)
                results.append(rec)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    flops = rec["flops_per_device"]
                    extra = (f" flops/dev="
                             f"{'null' if flops is None else f'{flops:.3e}'}"
                             f" args={_gib(rec['memory']['argument_bytes'])}"
                             f" trace={rec['trace_s']}s")
                print(f"[{rec['mesh']}] {arch} x {shape}: {status}{extra}",
                      flush=True)
                if status == "error":
                    print(rec["error"], flush=True)
    n_err = sum(r["status"] == "error" for r in results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    print(f"wall time {time.perf_counter() - t_all:.1f} s on the CPU")
    print(f"{len(results)} cells: "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{n_err} errors")
    sys.exit(1 if n_err else 0)


if __name__ == "__main__":
    main()
