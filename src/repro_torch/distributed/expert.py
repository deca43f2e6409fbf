"""Expert parallelism over a `launch.mesh.DistMesh`: what a sharded MoE
layer needs of the mesh (the port's counterpart of what GSPMD makes of
the reference's `moe_apply` under `param_pspecs`, whose stacked expert
banks lie over "model" on E).

Under the reference's activation spec every rank of a model group holds
the same tokens, its dp rows. So a layer whose banks are split over
"model" runs only this rank's experts over those tokens and sums the
partial outputs over the group: the tokens and gates enter the experts
through `distributed.tensor.copy_to` and the partial outputs leave
through `reduce_from` (Megatron's pair, which the model axis's other
split products use too). Under sequence parallelism the tokens are the
whole stream, gathered at the block's entry, the copies are the identity
and the partial outputs leave through a reduce-scatter over T.

Routing and capacity are functions of the whole microbatch (the
reference routes every token of the global batch at once). A rank holds
one block of the rows, in the rank order of the axes that split them;
`ExpertGroups.counts` gathers the per-expert assignment counts [E] over
those axes (one small all-gather an axis) and gives this rank the counts
of the ranks before it and the totals, from which
`models.moe.global_slots` places every local assignment in its expert's
global queue. No token ids or activations cross the wire.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import TP
from repro_torch.distributed.tensor import (copy_to, reduce_from,
                                            reduce_scatter_to)

EXPERTS = "experts"           # the counting site of the expert path

__all__ = ["ExpertGroups", "copy_to", "reduce_from"]


class ExpertGroups:
    """A rank's place for a sharded MoE layer: `row_axes`, the mesh axes
    that split the batch's rows (major to minor, as `batch_pspecs` fits
    them; replicas of the same rows share an index), and the model axis
    over which the expert banks split."""

    def __init__(self, mesh, row_axes: Tuple[str, ...]):
        self.mesh, self.row_axes = mesh, tuple(row_axes)
        self.row_size = math.prod(mesh.shape[a] for a in self.row_axes)
        idx = 0
        for a in self.row_axes:
            idx = idx * mesh.shape[a] + mesh.coord[a]
        self.row_index = idx
        self.model_index = mesh.coord.get(TP, 0)

    def counts(self, local: torch.Tensor):
        """(before, total) [E]: the summed counts of the row blocks before
        this rank's, and of all of them. Every rank calls it, in the same
        order; the blocks are gathered an axis at a time, minor to
        major, as `unshard_leaf` lays them."""
        x = local.reshape(1, -1)
        for a in reversed(self.row_axes):
            if self.mesh.shape[a] == 1:
                continue
            x = torch.cat(comm.all_gather(x.contiguous(), self.mesh.group(a),
                                          site=EXPERTS), 0)
        return torch.sum(x[:self.row_index], 0), torch.sum(x, 0)

    def copy_to_experts(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.mesh.group(TP), EXPERTS)

    def reduce_from_experts(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.mesh.group(TP), EXPERTS)

    def reduce_scatter_from_experts(self, x: torch.Tensor,
                                    dim: int) -> torch.Tensor:
        """The partial outputs' sum, this rank's block along `dim` (the
        sequence-parallel stream's T)."""
        return reduce_scatter_to(x, self.mesh.group(TP), dim, EXPERTS)
