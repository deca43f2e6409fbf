"""Sharded training over a `launch.mesh.DistMesh`: FSDP storage, data-
parallel compute over the dp axes and Megatron's split compute over
"model" (the port's counterpart of what GSPMD makes of the reference's
pjit step under `param_pspecs`).

Every rank stores only its block of each parameter (and of AdamW's m and
v and the compressor's residual), under the reference's rules. A rank
takes its rows of the batch (`batch_pspecs`); ranks that differ only on
the model axis hold the same rows. The weights are made whole where they
are used (`Model.loss(..., gather=)`): the leaves outside the layer
stacks at the top of the loss, each layer inside its remat body, so the
backward's recompute gathers again instead of keeping every layer.

A leaf that `sharding.model_split` splits is made whole over the dp axes
only: the rank computes on its block over "model" (column and row
products, heads, the vocabulary, its E/m routed experts), its inputs
entering through `distributed.tensor.copy_to` and its row partials
leaving through `reduce_from` (`FSDP.model_axis`, which `Model.loss`
hands the layers). Every other leaf is made whole over the mesh and
computed whole on every rank of a model group, on the same inputs, so
its gradient is the same there.

The gather's backward turns the whole gradient into the block's: the
model axis's slice (the same gradient on every rank of a model group),
then a reduce-scatter over the dp group onto the dp block, divided by
the dp size (a rank's loss is the mean over its rows), summed over
"data", then "pod", as `hierarchical_psum` sums; a leaf whose dp entry
`fit_spec` dropped takes the all-reduce mean whole.

With `tensor_parallel=False` (the reference's ZeRO-DP layout, which its
dry run takes for a small model's train cell) the model axis joins the
dp group: every leaf is made whole over every axis, no product splits,
and a rank's rows are its block of the batch over all the axes.

With `sp=True` (sequence parallelism, the reference's Megatron-SP layout
`activation_spec(mesh, sp=True)`, which its dry run takes for a TP train
cell) the residual stream between the blocks is split over T on the
model axis (`distributed.tensor.ModelAxis`): the norms run on this
rank's block of T, so the gradient of every leaf that is not split over
"model" is this rank's part of it, and the gather's backward sums it over
the model group ("sp_grads") before the slice and the dp reduction. That
holds only where every stream of the step is split: the model refuses a
batch one of whose streams' T the model axis does not divide
(`models.model.stream_lengths`), so SP is on or off for a whole step.

Every collective goes through `distributed.comm` (the dry run counts
their bytes there). Every rank runs the same collectives in the same order: the gathers and
the model axis's sums follow the model's code, which never branches on
the data, and a leaf that does not reach the loss still joins the
reductions after the backward (the norm, the compressor's scale).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.distributed import comm
from repro_torch.distributed.collectives import hierarchical_psum
from repro_torch.distributed.expert import ExpertGroups
from repro_torch.distributed.sharding import (TP, Spec, batch_pspecs,
                                              block_slices, dp_axes,
                                              entry_axes, model_split,
                                              owns_block, unshard_leaf,
                                              whole_shape)
from repro_torch.distributed.tensor import ModelAxis


class _Gather(torch.autograd.Function):
    """block -> the leaf made whole over `spec`'s axes; backward: the
    block's gradient (`FSDP.block_grad`)."""

    @staticmethod
    def forward(ctx, block, fsdp, spec, partial):
        ctx.fsdp, ctx.spec, ctx.partial = fsdp, spec, partial
        out = unshard_leaf(block, spec, fsdp.mesh)
        return out.view_as(out) if out is block else out

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = ctx.fsdp.model_sum(g)
        return ctx.fsdp.block_grad(g, ctx.spec), None, None, None


class FSDP:
    """The gathers and reductions of a sharded train step. `specs` maps
    each parameter's key (`tree.path_key`) to its spec, as `param_pspecs`
    gives them for the whole leaves; `model_split` chooses, from the
    model's config `cfg`, the leaves computed on their model block.
    `tensor_parallel=False` is the ZeRO-DP layout (`specs` then from
    `param_pspecs(..., tensor_parallel=False)`): dp is every axis and
    nothing splits over "model". `sp` turns sequence parallelism on where
    the model axis is larger than 1 (module docstring)."""

    def __init__(self, mesh, specs: Dict[str, Spec], cfg,
                 tensor_parallel: bool = True, sp: bool = False):
        self.mesh, self.specs = mesh, specs
        self.tensor_parallel = tensor_parallel
        self.dp = dp_axes(mesh, tensor_parallel)
        self.dp_size = math.prod(mesh.shape[a] for a in self.dp)
        self._experts: Dict[Tuple[str, ...], ExpertGroups] = {}
        m = mesh.shape.get(TP, 1) if tensor_parallel else 1
        self.model_axis = ModelAxis(mesh, sp) if m > 1 else None
        self.sp = self.model_axis is not None and self.model_axis.sp
        self.split: Dict[str, bool] = {}
        # stacked leaves whose spec shards the layer axis (the ZeRO rules
        # put dp on a stacked leaf's first dimension, which `fit_spec`
        # keeps where the layer count divides): made whole once a step
        # with the leaves outside the layers, not a layer at a time
        self.stack_whole: Dict[str, bool] = {}
        for key, spec in specs.items():
            axes = [a for e in spec for a in entry_axes(e)]
            if len(axes) != len(set(axes)):
                raise NotImplementedError(
                    f"{key}: spec {spec} names an axis twice")
            self.stack_whole[key] = key.startswith("blocks/") and \
                bool(spec) and spec[0] is not None
            for e in spec:
                if len({a in self.dp for a in entry_axes(e)}) > 1:
                    raise NotImplementedError(
                        f"{key}: spec {spec} merges dp and model axes in "
                        f"one entry")
            self.split[key] = model_split(tuple(key.split("/")), spec,
                                          cfg, m)

    # ------------------------------------------------------------ gathers
    def _gather(self, key: str, leaf, spec: Spec):
        if self.split[key]:
            spec = tuple(None if e == TP else e for e in spec)
        return _Gather.apply(leaf, self, spec,
                             self.sp and not self.split[key])

    def outside(self, params: Dict) -> Dict:
        """`params` with every leaf outside "blocks" made whole (over the
        dp axes only where it computes on its model block), and every
        stacked leaf sharded on its layer axis."""
        out = []
        for path, leaf in T.flatten_with_path(params):
            key = T.path_key(path)
            out.append(leaf if path[0] == "blocks"
                       and not self.stack_whole[key]
                       else self._gather(key, leaf, self.specs[key]))
        return T.unflatten(params, out)

    def layer(self, gi: int, p_l: Any) -> Any:
        """Layer blocks of stack group `gi` (views of its [L, ...] blocks)
        made whole under a stacked leaf's spec less its layer entry, over
        the dp axes only where the leaf computes on its model block (a
        routed expert bank keeps this rank's E/m experts); a leaf made whole
        in `outside` passes as it is."""
        out = []
        for path, leaf in T.flatten_with_path(p_l):
            key = T.path_key(("blocks", gi) + path)
            out.append(leaf if self.stack_whole[key] else
                       self._gather(key, leaf, self.specs[key][1:]))
        return T.unflatten(p_l, out)

    def block_grad(self, g: torch.Tensor, spec: Spec) -> torch.Tensor:
        """A block's gradient from the gradient of the leaf made whole
        over `spec`'s axes: the slice of the axes outside the dp group,
        then the dp block of the sum over the dp group (reduce-scattered
        over "data", then "pod"; all-reduced over an axis the spec does
        not split on), divided by the dp size."""
        dp = set(self.dp)
        outer = tuple(tuple(a for a in entry_axes(e) if a not in dp)
                      for e in spec)
        g = g[block_slices(tuple(g.shape), outer, self.mesh)]
        if self.dp_size == 1:
            return g.contiguous()
        d = next((i for i, e in enumerate(spec)
                  if set(entry_axes(e)) & dp), None)
        if d is None:
            return self.dp_mean(g)
        axes = list(entry_axes(spec[d]))
        sizes = [self.mesh.shape[a] for a in axes]
        shape = tuple(g.shape)
        x = g.reshape(shape[:d] + tuple(sizes)
                      + (shape[d] // math.prod(sizes),) + shape[d + 1:])
        for a in reversed(self.dp):
            group = self.mesh.group(a)
            if a not in axes:
                x = comm.all_reduce(x.contiguous().clone(), group,
                                    site="grads")
                continue
            k = d + axes.index(a)
            y = x.movedim(k, 0).contiguous()
            out = torch.empty((1,) + tuple(y.shape[1:]), dtype=y.dtype,
                              device=y.device)
            comm.reduce_scatter(out, y, group, site="grads")
            x = out.movedim(0, k)
            axes.pop(axes.index(a))
            x = x.reshape(x.shape[:k] + x.shape[k + 1:])
        x = x.reshape(shape[:d] + (shape[d] // math.prod(sizes),)
                      + shape[d + 1:])
        return x / torch.tensor(float(self.dp_size), dtype=x.dtype,
                                device=x.device)

    def model_sum(self, g: torch.Tensor) -> torch.Tensor:
        """A gradient's parts summed over the model group (f32), under
        sequence parallelism."""
        y = comm.all_reduce(g.to(torch.float32).contiguous().clone(),
                            self.model_axis.group, site="sp_grads")
        return y.to(g.dtype)

    # ------------------------------------------------------------ rows
    def rows(self, batch: Dict[str, np.ndarray]
             ) -> Tuple[Dict[str, np.ndarray], ExpertGroups]:
        """This rank's rows of a batch, under `batch_pspecs`, and its place
        among the blocks of those rows (the `ExpertGroups` that
        `Model.loss(experts=)` hands the MoE layers)."""
        specs = batch_pspecs(batch, self.mesh, self.tensor_parallel)
        axes = entry_axes(specs["tokens"][0])
        if axes not in self._experts:
            self._experts[axes] = ExpertGroups(self.mesh, axes)
        return ({k: v[block_slices(tuple(v.shape), specs[k], self.mesh)]
                 for k, v in batch.items()}, self._experts[axes])

    # ------------------------------------------------------------ sums
    def dp_mean(self, x: torch.Tensor, site: str = "grads") -> torch.Tensor:
        """The mean over the dp group, ("data",) or ("pod", "data")
        (through `hierarchical_psum`), or every axis under ZeRO-DP; a new
        tensor."""
        if self.dp_size == 1:
            return x
        if len(self.dp) == len(self.mesh.axis_names):
            y = comm.all_reduce(x.contiguous().clone(), None, site=site)
        elif "pod" in self.dp:
            y = hierarchical_psum(x.contiguous(), self.mesh, site=site)
        else:
            y = comm.all_reduce(x.contiguous().clone(),
                                self.mesh.group("data"), site=site)
        return y / torch.tensor(float(self.dp_size), dtype=y.dtype,
                                device=y.device)

    def sq_norm(self, grads: Any) -> torch.Tensor:
        """Σ g² over the whole leaves (each block counted once over the
        mesh), equal on every rank."""
        dev = self.mesh.device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for path, g in T.flatten_with_path(grads):
            if owns_block(self.specs[T.path_key(path)], self.mesh):
                total = total + torch.sum(g.to(torch.float32) ** 2)
        return comm.all_reduce(total, None, site="metrics")

    def amax(self, local: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the mesh."""
        import torch.distributed as dist
        return comm.all_reduce(local.clone(), None, site="metrics",
                               op=dist.ReduceOp.MAX)

    def numels(self, tree: Any) -> List[int]:
        """The whole leaves' sizes, in leaf order, from the blocks."""
        return [math.prod(whole_shape(tuple(b.shape),
                                      self.specs[T.path_key(p)], self.mesh))
                for p, b in T.flatten_with_path(tree)]

    # ------------------------------------------------------------ blocks
    def slices(self, path: tuple, shape: tuple):
        """The slices of a whole leaf that this rank keeps (the `blocks`
        hook of `Model.init_params`)."""
        return block_slices(shape, self.specs[T.path_key(path)], self.mesh)

    def unshard(self, path: tuple, block: torch.Tensor) -> torch.Tensor:
        """The whole leaf (every rank calls it, in leaf order)."""
        return unshard_leaf(block, self.specs[T.path_key(path)], self.mesh)
