"""vSPARQ: pair-level sparsity (paper §3.2, Eq. 2), port of
`repro.core.vsparq`: the pair reconstruction and the sparse-tensor-core
pairing of 2:4-pruned groups (§5.3).

Pairs are adjacent elements (2i, 2i+1) of the last axis, which must be even.
"""
from __future__ import annotations

import torch

from repro_torch.core.bsparq import bsparq_recon


def vsparq_recon(x: torch.Tensor, n_bits: int, shifts: tuple[int, ...],
                 rounding: bool, max_val: int = 255) -> torch.Tensor:
    """Eq. (2) for non-negative int32 values: a lane whose pair partner is
    zero keeps its full precision; otherwise both are bSPARQ-trimmed."""
    if x.shape[-1] % 2 != 0:
        raise ValueError(f"reduction axis must be even, got {x.shape[-1]}")
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    a, b = pairs[..., 0], pairs[..., 1]
    ra = torch.where(b == 0, a, bsparq_recon(a, n_bits, shifts, rounding,
                                             max_val))
    rb = torch.where(a == 0, b, bsparq_recon(b, n_bits, shifts, rounding,
                                             max_val))
    return torch.stack([ra, rb], dim=-1).reshape(x.shape)


def vsparq_recon_signed(x: torch.Tensor, n_bits: int,
                        shifts: tuple[int, ...], rounding: bool,
                        max_val: int = 127) -> torch.Tensor:
    """Signed extension: pairing decision on |x| == 0; bSPARQ on magnitudes."""
    sign = torch.sign(x).to(torch.int32)
    mag = torch.abs(x).to(torch.int32)
    return sign * vsparq_recon(mag, n_bits, shifts, rounding, max_val)


def vsparq_recon_grouped(x: torch.Tensor, keep_idx: torch.Tensor,
                         n_bits: int, shifts: tuple[int, ...],
                         rounding: bool, max_val: int = 255,
                         signed: bool = False) -> torch.Tensor:
    """Sparse-tensor-core path (paper §5.3, Table 6). `keep_idx[..., G,
    2]` holds, per group of 4 along the last axis of x, the two lanes
    (0..3) whose weights survive 2:4 pruning; the STC muxes those two
    activations and vSPARQ pairs them. Returns x's shape with the selected
    lanes reconstructed; unselected lanes pass through (they meet zero
    weights). Leading dims of keep_idx broadcast against x's."""
    if x.shape[-1] % 4 != 0:
        raise ValueError(
            f"reduction axis must be divisible by 4, got {x.shape[-1]}")
    g = x.reshape(*x.shape[:-1], -1, 4)
    keep_idx = keep_idx.to(torch.int64).expand(*g.shape[:-1], 2)
    picked = torch.gather(g, -1, keep_idx)                 # [..., G, 2]
    flat = picked.reshape(*picked.shape[:-2], -1)
    recon = (vsparq_recon_signed if signed else vsparq_recon)(
        flat, n_bits, shifts, rounding, max_val).reshape(picked.shape)
    lane = torch.arange(4, device=x.device)
    out = g
    for j in range(2):
        out = torch.where(lane == keep_idx[..., j:j + 1],
                          recon[..., j:j + 1], out)
    return out.reshape(x.shape)
