"""bSPARQ: bit-level sparsity-aware trimming (paper §3.1), port of
`repro.core.bsparq`. Pure int32 tensor code, the oracle of the kernels."""
from __future__ import annotations

import torch

from repro_torch.core.bitops import msb_pos, select_shift


def shifts_for(n_bits: int, opts: int) -> tuple[int, ...]:
    """Window placement options: full sets (n=4: 5opt, n=3: 6opt, n=2:
    7opt) and the reduced 4-bit sets 3opt = (0,2,4), 2opt = (0,4)."""
    full = 8 - n_bits + 1
    if opts == full:
        return tuple(range(full))
    if n_bits == 4 and opts == 3:
        return (0, 2, 4)
    if n_bits == 4 and opts == 2:
        return (0, 4)
    raise ValueError(f"unsupported (n_bits={n_bits}, opts={opts})")


def _trim(x: torch.Tensor, n_bits: int, shifts: tuple[int, ...]):
    """Trim-only window selection. Returns (q, s): window value and shift."""
    s = select_shift(msb_pos(x), n_bits, shifts)
    q = torch.bitwise_right_shift(x, s) & ((1 << n_bits) - 1)
    return q, s


def bsparq_encode(x: torch.Tensor, n_bits: int, shifts: tuple[int, ...],
                  rounding: bool, max_val: int = 255):
    """Non-negative int32 -> (window value q, shift s); recon is q << s.

    With rounding, the residual LSB rounds q to nearest; a carry out of the
    window is re-encoded at a higher window (exact) after clamping to
    `max_val` (saturation), applied unconditionally as in the reference."""
    x = x.to(torch.int32)
    q, s = _trim(x, n_bits, shifts)
    if not rounding:
        return q, s
    rbit = torch.where(
        s > 0, torch.bitwise_right_shift(x, torch.clamp(s - 1, min=0)) & 1,
        torch.zeros_like(x))
    v = torch.bitwise_left_shift(q + rbit, s)
    v = torch.clamp(v, max=max_val)
    return _trim(v, n_bits, shifts)


def bsparq_recon(x: torch.Tensor, n_bits: int, shifts: tuple[int, ...],
                 rounding: bool, max_val: int = 255) -> torch.Tensor:
    """Fake-quant reconstruction: encode then decode (q << s)."""
    q, s = bsparq_encode(x, n_bits, shifts, rounding, max_val)
    return torch.bitwise_left_shift(q, s)


def bsparq_recon_signed(x: torch.Tensor, n_bits: int,
                        shifts: tuple[int, ...], rounding: bool,
                        max_val: int = 127) -> torch.Tensor:
    """Sign-magnitude extension: bSPARQ windows |x|, the sign rides along."""
    sign = torch.sign(x).to(torch.int32)
    mag = torch.abs(x).to(torch.int32)
    return sign * bsparq_recon(mag, n_bits, shifts, rounding, max_val)
