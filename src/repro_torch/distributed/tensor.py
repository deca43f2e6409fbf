"""The model axis's collectives for a train step (Megatron's four
autograd functions), and `ModelAxis`, a rank's place on that axis (the
port's counterpart of what GSPMD makes of the reference's column- and
row-parallel rules and its `constrain_heads`).

  * `copy_to(x, group)`: identity forward, the gradient summed over the
    group backward. It feeds a split product: each rank's backward
    through its own block gives only its share of x's gradient.
  * `reduce_from(x, group)`: the sum over the group forward, identity
    backward. It ends a row-parallel product: the loss after the sum is
    the same on every rank, so each partial takes the output's gradient
    as it is.
  * `gather_from(x, group, dim)`: the ranks' blocks laid side by side
    along `dim` forward; this rank's block of the gradient backward.
  * `reduce_scatter_to(x, group, dim)`: the sum over the group, of which
    this rank keeps its block along `dim`, forward; the blocks of the
    gradient gathered backward.
Every sum is taken in f32 and returns the input's dtype.

Sequence parallelism (`ModelAxis(mesh, sp=True)`, the reference's
Megatron-SP layout, `activation_spec(mesh, sp=True)`): between the blocks
the residual stream is [B, T/m, D], this rank's block of T. A block
enters its products through `enter` (an all-gather over T whose backward
is a reduce-scatter) and its row products leave through `sum_out` (a
reduce-scatter over T whose backward is an all-gather). A tensor every
rank of the group holds whole between those two then carries only this
rank's part of its gradient, as the split products give it: so `copy`
is the identity both ways (the entry's reduce-scatter sums the parts), a
feature `gather` sums its gradient back (reduce-scatter), a whole tensor
goes back to the stream through `shard` (its block of T; the other
blocks' gradient zero), a whole value that the loss takes directly
passes 1/m of its gradient (`partial`), and a leaf that is not split
over the axis gets a partial gradient, which `distributed.fsdp` sums over
the group.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import TP

MODEL_AXIS = "model_axis"     # the counting site of the model axis's sums


def _group_sum(x: torch.Tensor, group, site: str = MODEL_AXIS
               ) -> torch.Tensor:
    """Σ over `group` in f32, in x's dtype; a new tensor."""
    y = x.to(torch.float32).contiguous().clone()
    return comm.all_reduce(y, group, site=site).to(x.dtype)


def _gather(x: torch.Tensor, group, dim: int,
            site: str = MODEL_AXIS) -> torch.Tensor:
    """The group's blocks of x, in group-rank order, along `dim`."""
    return torch.cat(comm.all_gather(x.contiguous(), group, site=site), dim)


def _scatter_sum(x: torch.Tensor, group, dim: int,
                 site: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's block along `dim` of Σ over `group` (f32, x's dtype)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    y = x.to(torch.float32).movedim(dim, 0).contiguous()
    out = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]),
                      dtype=y.dtype, device=y.device)
    comm.reduce_scatter(out, y, group, site=site)
    return out.movedim(0, dim).to(x.dtype)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    n, r = dist.get_world_size(group), dist.get_rank(group)
    step = x.shape[dim] // n
    return x.narrow(dim, r * step, step).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, site):
        ctx.group, ctx.site = group, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _group_sum(g, ctx.group, ctx.site), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, site):
        return _group_sum(x, group, site)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, site):
        ctx.group, ctx.dim, ctx.site = group, dim, site
        return _scatter_sum(x, group, dim, site)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim, ctx.site), None, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _group_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _group_sum(g, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def copy_to(x: torch.Tensor, group, site: str = MODEL_AXIS) -> torch.Tensor:
    """x as it is, where the group's ranks each compute a part of what
    follows from it: its gradient is summed over `group` (`site` names
    the sum for `comm.counting`)."""
    return _CopyTo.apply(x, group, site)


def reduce_from(x: torch.Tensor, group, site: str = MODEL_AXIS
                ) -> torch.Tensor:
    """The sum of each rank's partial x over `group` (f32 sums, x's
    dtype); its gradient reaches each partial unchanged."""
    return _ReduceFrom.apply(x, group, site)


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's blocks of x side by side along `dim`; the gradient's
    block of this rank flows back."""
    return _GatherFrom.apply(x, group, dim % x.dim())


def reduce_scatter_to(x: torch.Tensor, group, dim: int = -1,
                      site: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's block along `dim` of the sum of the ranks' partial x
    over `group` (f32 sums, x's dtype); the gradient's blocks are
    gathered back."""
    return _ReduceScatterTo.apply(x, group, dim % x.dim(), site)


class ModelAxis:
    """A rank's place on the model axis of a train step's mesh: its group,
    the group's size m and this rank's index there. A product split over
    the axis takes this rank's block, the index-th of m equal parts of the
    split dimension (`part`). With `sp` the residual stream between the
    blocks is split over T (module docstring); m must then divide the T of
    every stream of the step (`models.model.stream_lengths`), which the
    model checks."""

    def __init__(self, mesh, sp: bool = False):
        self.group = mesh.group(TP)
        self.size = mesh.shape[TP]
        self.index = mesh.coord[TP]
        self.sp = bool(sp) and self.size > 1

    def part(self, n: int) -> slice:
        """This rank's block of a dimension of n (m divides n)."""
        step = n // self.size
        return slice(self.index * step, (self.index + 1) * step)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.sp else copy_to(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of partials whose sum every rank then
        uses whole and alone (the loss's sums over the vocabulary)."""
        return reduce_from(x, self.group)

    def sum_out(self, x: torch.Tensor) -> torch.Tensor:
        """The end of a row product [B, T, ...]: the sum of the ranks'
        partials, as the stream takes it (this rank's block of T under
        SP)."""
        if self.sp:
            return reduce_scatter_to(x, self.group, 1)
        return reduce_from(x, self.group)

    def sum_whole(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partials, whole on every rank (under SP
        its gradient is summed too)."""
        if self.sp:
            return _SumBoth.apply(x, self.group)
        return reduce_from(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        if self.sp:
            return _GatherSum.apply(x, self.group, dim % x.dim())
        return gather_from(x, self.group, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return reduce_scatter_to(x, self.group, dim)

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """A block's normed input [B, T/m, D] made whole over T before its
        products (the reference's `constrain_batch`); as it is without
        SP."""
        return _GatherSum.apply(h, self.group, 1) if self.sp else h

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """Under SP, this rank's block of T of a whole [B, T, ...] tensor;
        else x."""
        if not self.sp:
            return x
        step = x.shape[1] // self.size
        return x.narrow(1, self.index * step, step)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """A whole value computed alike on every rank that the loss takes
        directly: under SP each rank passes 1/m of its gradient, so that
        the sums over the group count it once."""
        return _ScaleGrad.apply(x, 1.0 / self.size) if self.sp else x

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group, detached."""
        import torch.distributed as dist
        y = x.detach().contiguous().clone()
        return comm.all_reduce(y, self.group, site=MODEL_AXIS,
                               op=dist.ReduceOp.MAX)
