"""ACIQ analytic clipping (Banner et al., NeurIPS 2019), the paper's
Table 3 baseline; port of `repro.core.aciq`.

The MSE-optimal clip of a bell-shaped distribution is alpha* = c(bits) *
b, with b the Laplace scale E|x - mu| (or c'(bits) * sigma for a
Gaussian), with the published constants. Statistics are f32 reductions
over the whole tensor: the mean, then the mean absolute deviation from it
(Laplace) or the population standard deviation (Gauss).
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import QScale, act_scale_from_stats

# alpha*/b for Laplace(0, b), per bit-width (Banner et al., Table 1).
_LAPLACE_ALPHA_OVER_B = {2: 2.83, 3: 3.89, 4: 5.03, 5: 6.20, 6: 7.41,
                         7: 8.64, 8: 9.89}
# alpha*/sigma for Gaussian, per bit-width.
_GAUSS_ALPHA_OVER_SIGMA = {2: 1.71, 3: 2.15, 4: 2.55, 5: 2.93, 6: 3.28,
                           7: 3.61, 8: 3.92}


def aciq_clip_laplace(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Optimal symmetric clip value for Laplace-distributed x."""
    x = x.to(torch.float32)
    b = torch.mean(torch.abs(x - torch.mean(x)))
    return _LAPLACE_ALPHA_OVER_B[bits] * b


def aciq_clip_gauss(x: torch.Tensor, bits: int) -> torch.Tensor:
    sigma = torch.std(x.to(torch.float32), correction=0)
    return _GAUSS_ALPHA_OVER_SIGMA[bits] * sigma


def aciq_act_scale(x: torch.Tensor, bits: int, signed: bool,
                   dist: str = "laplace") -> QScale:
    """Activation scale with ACIQ clipping instead of min-max."""
    clip = aciq_clip_laplace(x, bits) if dist == "laplace" \
        else aciq_clip_gauss(x, bits)
    return act_scale_from_stats(clip, bits=bits, signed=signed)


def aciq_fake_quant(x: torch.Tensor, bits: int, signed: bool,
                    dist: str = "laplace") -> torch.Tensor:
    qs = aciq_act_scale(x, bits, signed, dist)
    q = torch.clamp(torch.round(x / qs.scale), qs.qmin, qs.qmax)
    return q * qs.scale
