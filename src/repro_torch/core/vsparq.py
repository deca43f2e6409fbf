"""vSPARQ: pair-level sparsity (paper §3.2, Eq. 2), port of
`repro.core.vsparq` (the pair reconstruction; the STC path is not ported).

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
