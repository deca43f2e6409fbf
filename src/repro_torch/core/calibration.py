"""Calibration pass: per-layer activation statistics (paper §5), port of
`repro.core.calibration`.

The paper calibrates per-layer min/max on ~2K images and recalibrates
BatchNorm running statistics. A `CalibBank` maps site names to
`MinMaxObserver`s, updated eagerly during forward passes run with a
calibrating `QuantCtx`; `recalibrate_batchnorm` is the generic EMA of
BatchNorm statistics (the CNN's own recalibration, a cumulative average,
is `models.cnn.recalibrate_bn`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable

import torch

from repro_torch.core.quantizer import MinMaxObserver, QScale


@dataclasses.dataclass
class CalibBank:
    """Layer name -> MinMaxObserver, updated eagerly during forward passes."""
    observers: Dict[str, MinMaxObserver] = dataclasses.field(
        default_factory=dict)

    def observe(self, name: str, x: torch.Tensor) -> None:
        obs = self.observers.get(name, MinMaxObserver())
        self.observers[name] = obs.update(x)

    def scales(self, bits: int = 8) -> Dict[str, QScale]:
        return {k: o.scale(bits=bits) for k, o in self.observers.items()}

    def merge(self, other: "CalibBank") -> "CalibBank":
        out = dict(self.observers)
        for k, o in other.observers.items():
            if k in out:
                out[k] = MinMaxObserver(max(out[k].max_val, o.max_val),
                                        min(out[k].min_val, o.min_val),
                                        out[k].count + o.count)
            else:
                out[k] = o
        return CalibBank(out)


def calibrate(apply_fn: Callable, params, batches: Iterable) -> CalibBank:
    """Run `apply_fn(params, batch, collect=bank)` over calibration batches."""
    bank = CalibBank()
    for batch in batches:
        apply_fn(params, batch, collect=bank)
    return bank


def recalibrate_batchnorm(stats_fn: Callable, params, batches: Iterable,
                          momentum: float = 0.1):
    """Recompute BN running mean/var over calibration batches (paper §5,
    refs [29,33,35,36]). `stats_fn(params, batch)` returns
    {bn_name: (batch_mean, batch_var)}; they are EMA'd into fresh running
    stats, returned as {bn_name: (mean, var)}."""
    running = {}
    for batch in batches:
        for name, (mean, var) in stats_fn(params, batch).items():
            if name not in running:
                running[name] = (mean, var)
            else:
                m0, v0 = running[name]
                running[name] = ((1 - momentum) * m0 + momentum * mean,
                                 (1 - momentum) * v0 + momentum * var)
    return running
