"""The port's collectives: each a thin call of `torch.distributed` that
every sharded path goes through (`distributed.sharding.unshard_leaf`,
`fsdp`, `tensor`, `collectives`, `expert`), and the dry run's count of
the bytes they move.

Under `counting()` each call adds the bytes of its result on this rank
to its kind, the kinds of the reference's `launch/dryrun.py::
collective_bytes` (which reads them from the compiled HLO): an all-reduce
its tensor, an all-gather the gathered whole, a reduce-scatter this
rank's block. The port issues no all-to-all or collective-permute; those
kinds stay 0. Each call also names its site, what it carries: "weights"
(FSDP's gathers), "grads" (a gradient's reduce-scatter or all-reduce),
"model_axis" (the model axis's sums and gathers), "experts" (an MoE
layer's count gather and its experts' sums), "sp_grads" (under sequence
parallelism, the sums over the model axis of the gradients of the leaves
not split over it) or "metrics" (the loss's dp mean, the norm, the
compressor's maxima). Outside `counting()` the count
is one test of a module global a call.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
SITES = ("weights", "grads", "model_axis", "experts", "sp_grads",
         "metrics")


class Traffic:
    """Bytes of collective results on this rank, by kind and by site."""

    def __init__(self):
        self.kinds: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.sites: Dict[str, Dict[str, int]] = {
            s: dict.fromkeys(KINDS, 0) for s in SITES}

    def add(self, kind: str, site: str, nbytes: int) -> None:
        self.kinds[kind] += nbytes
        self.sites[site][kind] += nbytes


_TRAFFIC: Optional[Traffic] = None


@contextlib.contextmanager
def counting() -> Iterator[Traffic]:
    """Count every collective this process issues inside the block."""
    global _TRAFFIC
    prev, _TRAFFIC = _TRAFFIC, Traffic()
    try:
        yield _TRAFFIC
    finally:
        _TRAFFIC = prev


def _bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_reduce(x: torch.Tensor, group=None, *, site: str,
               op=None) -> torch.Tensor:
    """Σ (or `op`) of x over `group` (None: the world), in place."""
    import torch.distributed as dist
    if _TRAFFIC is not None:
        _TRAFFIC.add("all-reduce", site, _bytes(x))
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return x


def all_gather(x: torch.Tensor, group, *, site: str) -> List[torch.Tensor]:
    """The group's blocks of x (contiguous), in group-rank order."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    if _TRAFFIC is not None:
        _TRAFFIC.add("all-gather", site, n * _bytes(x))
    dist.all_gather(parts, x, group=group)
    return parts


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group, *,
                   site: str) -> torch.Tensor:
    """This rank's block (`out`, the first dim of x over the group) of Σ
    over `group` of x."""
    import torch.distributed as dist
    if _TRAFFIC is not None:
        _TRAFFIC.add("reduce-scatter", site, _bytes(out))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out
