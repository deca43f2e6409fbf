"""AdamW with global-norm clipping over a parameter tree (port of
`repro.optim.adamw`).

The arithmetic is the reference's, op for op: the global norm sums the
leaves' squares in the reference's leaf order, weight decay is coupled
(`step = m̂ / (√v̂ + eps) + wd · p`, then `p − lr · step`, on every leaf,
norms and embeddings included), and m and v are f32. This is not
`torch.optim.AdamW`, whose decoupled decay runs in another order. The
step count, the schedule and the bias corrections are f32 tensors on the
parameters' device, as in JAX; every division is by a tensor (PyTorch's
CUDA division by a Python scalar multiplies by its reciprocal)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree as T


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor            # 0-d int32


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        zeros = lambda p: T.tree_map(
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), p)
        dev = T.leaves(params)[0].device
        return AdamWState(m=zeros(params), v=zeros(params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=dev))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """Returns (new_params, new_state, metrics)."""
        flat_g = T.leaves(grads)
        dev = flat_g[0].device
        gsq = 0
        for g in flat_g:
            gsq = gsq + torch.sum(g.to(torch.float32) ** 2)
        gnorm = torch.sqrt(gsq + 1e-20)
        scale = torch.minimum(_f32(1.0, dev), _f32(self.clip_norm, dev)
                              / gnorm)
        count = state.count + 1
        lr = self.lr(count) if callable(self.lr) else self.lr
        countf = count.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(self.b1, dev), countf)
        bc2 = 1 - torch.pow(_f32(self.b2, dev), countf)

        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            step = step + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step).to(p.dtype), m, v

        out = [upd(p, g, m, v) for p, g, m, v in zip(
            T.leaves(params), flat_g, T.leaves(state.m),
            T.leaves(state.v))]
        new_p = T.unflatten(params, [o[0] for o in out])
        new_m = T.unflatten(params, [o[1] for o in out])
        new_v = T.unflatten(params, [o[2] for o in out])
        return new_p, AdamWState(new_m, new_v, count), \
            {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to `peak`, then cosine decay to `floor * peak`; a
    function of the step count (a 0-d tensor) returning an f32 tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        dev = step.device
        warm = peak * step / _f32(max(warmup, 1), dev)
        prog = torch.clamp((step - warmup) / _f32(max(total - warmup, 1),
                                                  dev), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 *
                      (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr
