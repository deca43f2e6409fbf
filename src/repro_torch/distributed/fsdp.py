"""Sharded training over a `launch.mesh.DistMesh`: FSDP storage, data-
parallel compute (the port's counterpart of what GSPMD makes of the
reference's pjit step under `param_pspecs`).

Every rank stores only its block of each parameter (and of AdamW's m and
v and the compressor's residual), under the reference's rules. Compute is
data-parallel over the dp axes: a rank takes its rows of the batch
(`batch_pspecs`), and the weights are made whole a layer at a time where
they are used (`Model.loss(..., gather=)`): the leaves outside the layer
stacks at the top of the loss, each layer inside its remat body, so the
backward's recompute gathers again instead of keeping every layer. The
gather's backward turns the whole weight's gradient into the block's:
the mean over the dp group (a rank's loss is the mean over its rows),
then the block's slice. Ranks that differ only on the model axis compute
the same rows. A routed expert bank stored over "model" on E is made
whole over the dp axes only: each rank of a model group runs its own
E/m experts over the group's tokens and the partial outputs are summed
(expert parallelism, `distributed.expert`, `models.moe.moe_apply`).
Every other weight is gathered whole, and its compute over the model
axis is replicated (Megatron's column and row products are the next
slice). Only what the forward makes whole depends on this: the stored
blocks, their specs and the checkpoints do not.

Every rank runs the same collectives in the same order: the gathers
follow the model's code, which never branches on the data, and a leaf
that does not reach the loss still joins the reductions after the
backward (the norm, the compressor's scale).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.distributed.collectives import hierarchical_psum
from repro_torch.distributed.expert import ExpertGroups
from repro_torch.distributed.sharding import (EXPERT_KEYS, TP, Spec,
                                              batch_pspecs, block_slices,
                                              dp_axes, entry_axes,
                                              owns_block, unshard_leaf,
                                              whole_shape)


class _Gather(torch.autograd.Function):
    """block -> whole leaf; backward: the whole gradient's dp mean, then
    the block's slice."""

    @staticmethod
    def forward(ctx, block, fsdp, spec):
        ctx.fsdp, ctx.spec = fsdp, spec
        out = unshard_leaf(block, spec, fsdp.mesh)
        return out.view_as(out) if out is block else out

    @staticmethod
    def backward(ctx, g):
        g = ctx.fsdp.dp_mean(g)
        return (g[block_slices(tuple(g.shape), ctx.spec, ctx.fsdp.mesh)]
                .contiguous(), None, None)


class FSDP:
    """The gathers and reductions of a sharded train step. `specs` maps
    each parameter's key (`tree.path_key`) to its spec, as `param_pspecs`
    gives them for the whole leaves."""

    def __init__(self, mesh, specs: Dict[str, Spec]):
        self.mesh, self.specs = mesh, specs
        self.dp = dp_axes(mesh)
        self.dp_size = math.prod(mesh.shape[a] for a in self.dp)
        self._experts: Dict[Tuple[str, ...], ExpertGroups] = {}
        for key, spec in specs.items():
            axes = [a for e in spec for a in entry_axes(e)]
            if len(axes) != len(set(axes)):
                raise NotImplementedError(
                    f"{key}: spec {spec} names an axis twice")
            if key.startswith("blocks/") and spec and spec[0] is not None:
                raise NotImplementedError(
                    f"{key}: spec {spec} shards the layer axis, which the "
                    f"per-layer gather does not take")

    # ------------------------------------------------------------ gathers
    def outside(self, params: Dict) -> Dict:
        """`params` with every leaf outside "blocks" made whole."""
        return T.unflatten(params, [
            leaf if path[0] == "blocks" else
            _Gather.apply(leaf, self, self.specs[T.path_key(path)])
            for path, leaf in T.flatten_with_path(params)])

    def layer(self, gi: int, p_l: Any) -> Any:
        """Layer blocks of stack group `gi` (views of its [L, ...] blocks)
        made whole under a stacked leaf's spec less its layer entry; a
        routed expert bank split over "model" on E keeps this rank's
        E/m experts (made whole over the dp axes only)."""
        out = []
        for path, leaf in T.flatten_with_path(p_l):
            spec = self.specs[T.path_key(("blocks", gi) + path)][1:]
            if path[-2:-1] == ("moe",) and path[-1] in EXPERT_KEYS \
                    and spec[:1] == (TP,):
                spec = (None,) + spec[1:]
            out.append(_Gather.apply(leaf, self, spec))
        return T.unflatten(p_l, out)

    # ------------------------------------------------------------ rows
    def rows(self, batch: Dict[str, np.ndarray]
             ) -> Tuple[Dict[str, np.ndarray], ExpertGroups]:
        """This rank's rows of a batch, under `batch_pspecs`, and its place
        among the blocks of those rows (the `ExpertGroups` that
        `Model.loss(experts=)` hands the MoE layers)."""
        specs = batch_pspecs(batch, self.mesh)
        axes = entry_axes(specs["tokens"][0])
        if axes not in self._experts:
            self._experts[axes] = ExpertGroups(self.mesh, axes)
        return ({k: v[block_slices(tuple(v.shape), specs[k], self.mesh)]
                 for k, v in batch.items()}, self._experts[axes])

    # ------------------------------------------------------------ sums
    def dp_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the dp group, ("data",) or ("pod", "data")
        (through `hierarchical_psum`); a new tensor."""
        import torch.distributed as dist
        if self.dp_size == 1:
            return x
        if "pod" in self.dp:
            y = hierarchical_psum(x.contiguous(), self.mesh)
        else:
            y = x.contiguous().clone()
            dist.all_reduce(y, group=self.mesh.group("data"))
        return y / torch.tensor(float(self.dp_size), dtype=y.dtype,
                                device=y.device)

    def sq_norm(self, grads: Any) -> torch.Tensor:
        """Σ g² over the whole leaves (each block counted once over the
        mesh), equal on every rank."""
        import torch.distributed as dist
        dev = self.mesh.device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for path, g in T.flatten_with_path(grads):
            if owns_block(self.specs[T.path_key(path)], self.mesh):
                total = total + torch.sum(g.to(torch.float32) ** 2)
        dist.all_reduce(total)
        return total

    def amax(self, local: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the mesh."""
        import torch.distributed as dist
        out = local.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out

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
