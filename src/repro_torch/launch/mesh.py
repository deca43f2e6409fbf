"""The meshes (port of `repro.launch.mesh`).

**Serving** (`make_tp_mesh`). The reference builds a ("data", "model")
`jax.Mesh` over the local devices and runs its attention dispatchers per
shard under `shard_map`. The port keeps its single-controller shape in
PyTorch's idiom of explicit placement: a `TPMesh` is the list of the `tp`
devices the shards live on, in shard order, and one host loop launches
each shard's kernels on its device (`kernels.ops`, `models.paging`).
Shard r holds KV heads [r KV/tp, (r + 1) KV/tp) of every page
(`distributed.sharding.shard_heads`); the lead device, shard 0's, holds
the weights, the activations, the logits and the host scheduler's device
copies.

**Training** (`make_host_mesh`, `make_production_mesh`). One process a
rank, as `torchrun` starts them (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`): a
`DistMesh` wraps a `torch.distributed.device_mesh.DeviceMesh` over the
world, rank-major in its axes, with one process group an axis. Each rank
takes `cuda:LOCAL_RANK`; where a host has fewer cards than ranks, ranks
share cards only when the caller asks (the counterpart of the
reference's forced host device count), and on the CPU every rank is the
CPU. The backend is NCCL where each rank has a card of its own, else
gloo (NCCL refuses two ranks on one card); the mesh records which.

On the meta device (the dry run: one rank of a production mesh in one
process, over torch's "fake" process group, which the caller starts) the
`DeviceMesh` is built on "cpu" while the rank's tensors live on meta.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """`tp` shard devices in shard order; shard 0's is the lead. A device
    may hold several shards (`make_tp_mesh(tp, devices=[d] * tp)`)."""
    devices: Tuple[torch.device, ...]

    @property
    def tp(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices that hold a shard, each once, in shard order: each
        keeps one copy of the replicated bookkeeping."""
        return tuple(dict.fromkeys(self.devices))


def canonical_device(device) -> torch.device:
    """`device` as its tensors report it: a card with its index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_tp_mesh(tp: int, device=None,
                 devices: Optional[Sequence] = None) -> TPMesh:
    """The serving `--tp N` mesh. `devices` places the shards explicitly
    (several may share a device: one card, or the CPU in tests, the
    counterpart of the reference's forced host device count). Otherwise
    on `cuda` (the default device) the shards take the first `tp` visible
    cards, and fewer cards than `tp` raise, as the reference raises when tp
    does not divide its device count: one card is never reused silently.
    On the CPU every shard is the CPU."""
    if tp < 1:
        raise ValueError(f"--tp must be >= 1, got {tp}")
    if devices is not None:
        devs = tuple(canonical_device(d) for d in devices)
        if len(devs) != tp:
            raise ValueError(f"--tp {tp} needs one device a shard, got "
                             f"{len(devs)}")
        return TPMesh(devs)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return TPMesh((dev,) * tp)
    n = torch.cuda.device_count()
    if n < tp:
        raise ValueError(
            f"--tp {tp} needs {tp} visible cards, {n} visible; place the "
            f"shards explicitly with make_tp_mesh(tp, devices=...) to put "
            f"several on one card")
    return TPMesh(tuple(torch.device("cuda", i) for i in range(tp)))


# ---------------------------------------------------------------------
# training meshes over torch.distributed
# ---------------------------------------------------------------------

def world_env() -> Tuple[int, int, int]:
    """(rank, world size, local rank): the initialized process group's, or
    from `torchrun`'s environment, (0, 1, 0) without either."""
    import torch.distributed as dist
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), local
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)), local)


@dataclasses.dataclass(frozen=True)
class DistMesh:
    """A rank's view of a training mesh: the `DeviceMesh`, its axes and
    their sizes ({axis: size}, as `distributed.sharding` reads a mesh),
    this rank's coordinate on each axis, its device, and the backend."""
    device_mesh: Any
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coord: Dict[str, int]
    device: torch.device
    backend: str

    def group(self, axis: str):
        """The process group of the ranks that differ from this one on
        `axis` only; a rank's group rank is its coordinate there."""
        return self.device_mesh.get_group(axis)

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())


def _rank_device(device, share_cards: bool) -> Tuple[torch.device, bool]:
    """(the rank's device, whether it shares a card with another rank)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, False
    _, world, local = world_env()
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n = torch.cuda.device_count()
    if n >= ranks_here:
        return torch.device("cuda", local), False
    if not share_cards:
        raise ValueError(
            f"{ranks_here} ranks on this host need {ranks_here} visible "
            f"cards, {n} visible; ask ranks to share cards (--share-cards) "
            f"to put several on one card")
    return torch.device("cuda", local % n), True


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device=None,
              share_cards: bool = False) -> DistMesh:
    """A mesh of `shape` with axes `names` over every rank, rank-major;
    starts the process group from torchrun's environment unless one is
    running. With `device="meta"` the group must be running (the dry
    run's fake group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev, shared = _rank_device(device, share_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        rank, world, _ = world_env()
        dist.init_process_group(
            "nccl" if dev.type == "cuda" and not shared else "gloo",
            rank=rank, world_size=world)
    dm = init_device_mesh("cpu" if dev.type == "meta" else dev.type, shape,
                          mesh_dim_names=names)
    coord = dict(zip(names, dm.get_coordinate()))
    for a in names:
        if dist.get_group_rank(dm.get_group(a), dist.get_rank()) != coord[a]:
            raise RuntimeError(f"axis {a}: group rank is not the "
                               f"coordinate {coord[a]}")
    return DistMesh(dm, names, dict(zip(names, shape)), coord, dev,
                    dist.get_backend())


def make_host_mesh(model_parallel: int = 1, device=None,
                   share_cards: bool = False) -> DistMesh:
    """A (world / mp, mp) ("data", "model") mesh over every rank (tests and
    runs on one host); raises where mp does not divide the world."""
    _, world, _ = world_env()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not "
                         f"divide the world of {world} ranks")
    return make_mesh((world // model_parallel, model_parallel),
                      ("data", "model"), device, share_cards)


def make_production_mesh(multi_pod: bool = False, device=None,
                         share_cards: bool = False) -> DistMesh:
    """The production target's mesh: (16, 16) ("data", "model") over 256
    ranks, or (2, 16, 16) ("pod", "data", "model") over 512; raises on a
    world of any other size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    _, world, _ = world_env()
    need = math.prod(shape)
    if world != need:
        raise ValueError(f"the {'multi-pod ' if multi_pod else ''}"
                         f"production mesh {shape} needs {need} ranks, the "
                         f"world has {world}")
    return make_mesh(shape, names, device, share_cards)
