"""Calibration bank: named activation observers (port of
`repro.core.calibration.CalibBank`)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.quantizer import MinMaxObserver


@dataclasses.dataclass
class CalibBank:
    """Layer name -> MinMaxObserver, updated eagerly during forward passes."""
    observers: Dict[str, MinMaxObserver] = dataclasses.field(
        default_factory=dict)

    def observe(self, name: str, x: torch.Tensor) -> None:
        obs = self.observers.get(name, MinMaxObserver())
        self.observers[name] = obs.update(x)
