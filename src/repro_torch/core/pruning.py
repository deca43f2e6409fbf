"""2:4 structured weight pruning (paper §5.3, NVIDIA sparse tensor cores),
port of `repro.core.pruning`.

Every group of 4 adjacent weights along the reduction axis keeps its 2
largest-magnitude members. Ties break as the reference's stable sorts
break them: `prune_2_4` ranks by ascending |w| and keeps the two highest
ranks, so among equal magnitudes the later lanes survive; `keep_indices`
sorts by descending |w|, so among equal magnitudes the earlier lanes are
named. Both sorts here are stable (`torch.argsort(stable=True)`).
"""
from __future__ import annotations

import torch


def prune_2_4(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Zero the 2 smallest-|w| of every 4 adjacent weights along `axis`."""
    w_m = torch.movedim(w, axis, -1)
    if w_m.shape[-1] % 4 != 0:
        raise ValueError(
            f"axis length must be divisible by 4: {w_m.shape[-1]}")
    g = w_m.reshape(*w_m.shape[:-1], -1, 4)
    order = torch.argsort(torch.abs(g), dim=-1, stable=True)  # ascending
    ranks = torch.argsort(order, dim=-1, stable=True)
    pruned = torch.where(ranks >= 2, g, torch.zeros_like(g))
    return torch.movedim(pruned.reshape(w_m.shape), -1, axis)


def keep_indices(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per group of 4 along `axis`, the ascending positions (0..3) of the
    2 kept weights — the STC's stored coordinates. Shape [..., K/4, 2]
    with the grouped axis moved last, int64."""
    w_m = torch.movedim(w, axis, -1)
    g = w_m.reshape(*w_m.shape[:-1], -1, 4)
    top2 = torch.argsort(-torch.abs(g), dim=-1, stable=True)[..., :2]
    return torch.sort(top2, dim=-1).values


def sparsity(w: torch.Tensor) -> float:
    return float(torch.mean((w == 0.0).to(torch.float32)))
