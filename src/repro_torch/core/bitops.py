"""Integer bit-level helpers used by bSPARQ (port of `repro.core.bitops`).

Functions operate on int32 tensors holding small non-negative integers
(magnitudes after symmetric quantization, values in [0, 255]).
"""
from __future__ import annotations

import torch


def msb_pos(x: torch.Tensor) -> torch.Tensor:
    """Position of the most-significant toggled bit: floor(log2(x)) for
    x >= 1, 0 for x == 0. Exact integer computation, no float log."""
    x = x.to(torch.int32)
    m = torch.zeros_like(x)
    for k in range(1, 8):  # values are < 2**8
        m = m + (x >= (1 << k)).to(torch.int32)
    return m


def select_shift(m: torch.Tensor, n_bits: int,
                 shifts: tuple[int, ...]) -> torch.Tensor:
    """Smallest allowed shift in `shifts` whose n-bit window covers bit
    position `m` (the paper's trim rule); the largest shift otherwise."""
    need = torch.clamp(m - (n_bits - 1), min=0)
    s = torch.full_like(m, shifts[-1])
    for opt in reversed(shifts[:-1]):
        s = torch.where(need <= opt, torch.full_like(m, opt), s)
    return s
