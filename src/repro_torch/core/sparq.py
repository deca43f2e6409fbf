"""SPARQ configuration and integer reconstruction (port of
`repro.core.sparq`; the sparse-tensor-core path is not ported)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bsparq, vsparq


@dataclasses.dataclass(frozen=True)
class SparqConfig:
    """bits/opts combinations evaluated in the paper:
    (4, 5) 5opt · (4, 3) 3opt · (4, 2) 2opt · (3, 6) 6opt · (2, 7) 7opt"""
    bits: int = 4
    opts: int = 5
    rounding: bool = True          # +R
    vsparq: bool = True            # pair-level sparsity (Eq. 2)
    signed: bool = False           # signed magnitude extension
    act_bits: int = 8              # base PTQ bit-width of activations
    weight_bits: int = 8           # per-channel weight bit-width
    enabled: bool = True           # False -> plain A8W8 (paper's baseline)

    @property
    def shifts(self) -> tuple[int, ...]:
        return bsparq.shifts_for(self.bits, self.opts)

    @property
    def max_val(self) -> int:
        return (1 << (self.act_bits - 1)) - 1 if self.signed \
            else (1 << self.act_bits) - 1

    @property
    def name(self) -> str:
        tag = f"{self.bits}b-{self.opts}opt"
        tag += "+R" if self.rounding else "-R"
        tag += "+vS" if self.vsparq else "-vS"
        return tag + ("(signed)" if self.signed else "")

    @staticmethod
    def opt5(**kw) -> "SparqConfig":
        return SparqConfig(bits=4, opts=5, **kw)

    @staticmethod
    def opt3(**kw) -> "SparqConfig":
        return SparqConfig(bits=4, opts=3, **kw)

    @staticmethod
    def opt2(**kw) -> "SparqConfig":
        return SparqConfig(bits=4, opts=2, **kw)

    @staticmethod
    def opt6(**kw) -> "SparqConfig":  # 3-bit
        return SparqConfig(bits=3, opts=6, **kw)

    @staticmethod
    def opt7(**kw) -> "SparqConfig":  # 2-bit
        return SparqConfig(bits=2, opts=7, **kw)

    @staticmethod
    def a8w8() -> "SparqConfig":
        return SparqConfig(enabled=False)


def sparq_recon_int(q: torch.Tensor, cfg: SparqConfig) -> torch.Tensor:
    """Integer codes -> SPARQ-reconstructed integer codes (last axis = K)."""
    if not cfg.enabled:
        return q
    if cfg.vsparq:
        fn = vsparq.vsparq_recon_signed if cfg.signed else vsparq.vsparq_recon
    else:
        fn = bsparq.bsparq_recon_signed if cfg.signed else bsparq.bsparq_recon
    return fn(q, cfg.bits, cfg.shifts, cfg.rounding, cfg.max_val)
