"""The serving mesh (port of `repro.launch.mesh.make_tp_mesh`).

The reference builds a ("data", "model") `jax.Mesh` over the local devices
and runs its attention dispatchers per shard under `shard_map`. The port
keeps its single-controller shape in PyTorch's idiom of explicit
placement: a `TPMesh` is the list of the `tp` devices the shards live on,
in shard order, and one host loop launches each shard's kernels on its
device (`kernels.ops`, `models.paging`). Shard r holds KV heads [r KV/tp,
(r + 1) KV/tp) of every page (`distributed.sharding.shard_heads`); the
lead device, shard 0's, holds the weights, the activations, the logits
and the host scheduler's device copies.

`make_production_mesh` and `make_host_mesh` of the reference belong to
sharded training and are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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
