"""SPARQ configuration, integer reconstruction and the float-level
products (port of `repro.core.sparq`).

`sparq_dot` / `sparq_linear` are the plain reference products; the model
path goes through `kernels.ops.quantized_matmul` (K1 on the card).
`sparq_dot_stc` simulates the paper's sparse tensor cores (§5.3) in plain
PyTorch on every device, as the reference computes it outside any kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import bsparq, vsparq
from repro_torch.core.pruning import keep_indices
from repro_torch.core.quantizer import QScale, quantize, weight_scale


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


def sparq_fake_quant(x: torch.Tensor, act_qs: QScale,
                     cfg: SparqConfig) -> torch.Tensor:
    """Float activations -> float SPARQ reconstruction (reference path)."""
    q = quantize(x, act_qs)
    r = sparq_recon_int(q, cfg)
    return r.to(x.dtype) * act_qs.scale


def sparq_dot(x: torch.Tensor, w_q: torch.Tensor, act_qs: QScale,
              w_qs: QScale, cfg: SparqConfig,
              keep_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized dot product: x [..., K] float, w_q [K, N] int codes;
    activations quantized, SPARQ'd (through the 2:4 STC pairing when
    `keep_idx` is given), multiplied against the integer weights in f32
    and rescaled by act_scale * w_scale."""
    q = quantize(x, act_qs)
    if keep_idx is not None:
        r = vsparq.vsparq_recon_grouped(
            q, keep_idx, cfg.bits, cfg.shifts, cfg.rounding, cfg.max_val,
            signed=cfg.signed)
    else:
        r = sparq_recon_int(q, cfg)
    acc = torch.matmul(r.to(torch.float32), w_q.to(torch.float32))
    return acc * act_qs.scale * w_qs.scale


def sparq_linear(x: torch.Tensor, w: torch.Tensor, act_qs: QScale,
                 cfg: SparqConfig) -> torch.Tensor:
    """Quantize weights on the fly (per output channel), then sparq_dot."""
    w_qs = weight_scale(w, cfg.weight_bits)
    return sparq_dot(x, quantize(w, w_qs), act_qs, w_qs, cfg)


def sparq_dot_stc(x: torch.Tensor, w: torch.Tensor, act_qs: QScale,
                  cfg: SparqConfig, chunk: int = 32) -> torch.Tensor:
    """Sparse-tensor-core simulation (paper §5.3): w [K, N] is 2:4-pruned
    along K; per output channel the STC muxes the 2 surviving activations
    of each group of 4 and vSPARQ pairs them. The selection differs per
    channel, so the reconstruction is per channel, [..., chunk, K] int32
    at a time: at M rows that is M * chunk * K * 4 bytes, which bounds the
    batch a call can take."""
    w_qs = weight_scale(w, cfg.weight_bits)
    w_q = quantize(w, w_qs)                       # [K, N]
    keep = keep_indices(w, axis=0)                # [N, K/4, 2]
    q = quantize(x, act_qs)                       # [..., K]
    N = w.shape[1]
    outs = []
    for c0 in range(0, N, chunk):
        kc = keep[c0:c0 + chunk]                  # [C, G, 2]
        qx = q[..., None, :].expand(*q.shape[:-1], kc.shape[0], q.shape[-1])
        recon = vsparq.vsparq_recon_grouped(
            qx, kc, cfg.bits, cfg.shifts, cfg.rounding, cfg.max_val,
            signed=cfg.signed)                    # [..., C, K]
        y = torch.einsum("...ck,kc->...c", recon.to(torch.float32),
                         w_q[:, c0:c0 + chunk].to(torch.float32))
        outs.append(y * act_qs.scale * w_qs.scale[c0:c0 + chunk])
    return torch.cat(outs, dim=-1)
