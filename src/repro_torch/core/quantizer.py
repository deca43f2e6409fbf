"""Uniform min-max symmetric PTQ (port of `repro.core.quantizer`).

Activations: per-tensor symmetric; weights: per-output-channel signed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QScale:
    """x_int = clip(round(x / scale)). Unsigned range [0, 2**bits - 1];
    signed [-(2**(bits-1) - 1), 2**(bits-1) - 1] (symmetric, no -128)."""
    scale: torch.Tensor  # 0-d (per-tensor) or [out_features] (per-channel)
    bits: int
    signed: bool

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1 if self.signed \
            else (1 << self.bits) - 1

    @property
    def qmin(self) -> int:
        return -self.qmax if self.signed else 0


@functools.lru_cache(maxsize=None)
def _divisor(n: int, device: torch.device) -> torch.Tensor:
    return torch.full((), float(n), dtype=torch.float32, device=device)


def div_qmax(t: torch.Tensor, qmax: int) -> torch.Tensor:
    """t / qmax as IEEE f32 division on every device, as the reference
    divides. PyTorch's CUDA division by a Python scalar multiplies by the
    scalar's f32 reciprocal instead, an ulp off for many values; dividing
    by a 0-d tensor on t's device (kept per device) is exact."""
    return t / _divisor(int(qmax), t.device)


def act_scale_from_stats(max_val, bits: int = 8,
                         signed: bool = False) -> QScale:
    """Per-tensor activation scale from a calibrated max statistic."""
    qmax = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    scale = div_qmax(torch.clamp(torch.as_tensor(max_val,
                                                 dtype=torch.float32),
                                 min=1e-8), qmax)
    return QScale(scale=scale, bits=bits, signed=signed)


def weight_scale(w: torch.Tensor, bits: int = 8) -> QScale:
    """Per-output-channel symmetric signed scale; w is [in, out]."""
    qmax = (1 << (bits - 1)) - 1
    absmax = torch.amax(torch.abs(w), dim=tuple(range(w.ndim - 1)))
    scale = div_qmax(torch.clamp(absmax, min=1e-8), qmax)
    return QScale(scale=scale, bits=bits, signed=True)


def quantize(x: torch.Tensor, qs: QScale) -> torch.Tensor:
    """Float -> int32 codes: divide by the scale (never multiply by its
    reciprocal), round half to even, clip."""
    q = torch.round(x / qs.scale)
    return torch.clamp(q, qs.qmin, qs.qmax).to(torch.int32)


def dequantize(q: torch.Tensor, qs: QScale) -> torch.Tensor:
    return q.to(torch.float32) * qs.scale


def fake_quant(x: torch.Tensor, qs: QScale) -> torch.Tensor:
    return dequantize(quantize(x, qs), qs)


def quantize_weight(w: torch.Tensor,
                    bits: int = 8) -> tuple[torch.Tensor, QScale]:
    qs = weight_scale(w, bits)
    return quantize(w, qs), qs


@dataclasses.dataclass
class MinMaxObserver:
    """Running min/max collector for activation calibration. Reading the
    statistics syncs with the device; calibration runs eagerly off the
    serving path."""
    max_val: float = 0.0
    min_val: float = 0.0
    count: int = 0

    def update(self, x: torch.Tensor) -> "MinMaxObserver":
        mx = float(torch.max(x))
        mn = float(torch.min(x))
        if self.count == 0:
            return MinMaxObserver(mx, mn, 1)
        return MinMaxObserver(max(self.max_val, mx), min(self.min_val, mn),
                              self.count + 1)

    def scale(self, bits: int = 8, signed: Optional[bool] = None) -> QScale:
        if signed is None:
            signed = self.min_val < 0
        span = max(abs(self.max_val), abs(self.min_val)) if signed \
            else self.max_val
        return act_scale_from_stats(span, bits=bits, signed=signed)
