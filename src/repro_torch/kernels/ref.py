"""Plain PyTorch oracles of the §5.1 codec (port of `repro.kernels.ref`).

`ref_sparq_quant` (the KV write path's quantizer), `meta_shifts`,
`sparq_pack` (reconstructed codes -> the stored form) and `_meta_decode32`
live here. The plain versions of the three kernels sit
beside their kernels: `sparq_matmul.ref_sparq_matmul`,
`sparq_decode_attn.ref_sparq_paged_decode_attn` and
`sparq_prefill_attn.ref_sparq_chunked_prefill_attn`.
"""
from __future__ import annotations

import torch

from repro_torch.core.bsparq import bsparq_encode


def quantize_codes(x: torch.Tensor, act_scale, signed: bool,
                   max_val: int) -> torch.Tensor:
    """clip(round(x / a)) as int32, computed in f32 (round half to even)."""
    qmin = -max_val if signed else 0
    a = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x.to(torch.float32) / a), qmin, max_val)
    return q.to(torch.int32)


def ref_sparq_quant(x, act_scale, *, bits=4, opts_shifts=(0, 1, 2, 3, 4),
                    rounding=True, vsparq=True, signed=True, max_val=127,
                    enabled=True):
    """float -> (reconstructed codes int8, meta int8); the meta byte of a
    pair is mux_any*64 + shift_even*8 + shift_odd, copied to both lanes."""
    q = quantize_codes(x, act_scale, signed, max_val)
    if not enabled:
        return q.to(torch.int8), torch.zeros_like(q, dtype=torch.int8)
    sign = torch.sign(q)
    mag = torch.abs(q)
    qq, ss = bsparq_encode(mag, bits, opts_shifts, rounding, max_val)
    trimmed = torch.bitwise_left_shift(qq, ss)
    if vsparq:
        pairs = mag.reshape(*mag.shape[:-1], -1, 2)
        partner = torch.stack([pairs[..., 1], pairs[..., 0]],
                              dim=-1).reshape(mag.shape)
        full = partner == 0
        recon = torch.where(full, mag, trimmed)
        shift_code = torch.where(full, torch.zeros_like(ss), ss)
        mux = full
    else:
        recon = trimmed
        shift_code = ss
        mux = torch.zeros_like(mag, dtype=torch.bool)
    codes = (sign * recon).to(torch.int8)
    mux_i = mux.to(torch.int32).reshape(*mag.shape[:-1], -1, 2)
    s_pair = shift_code.reshape(*mag.shape[:-1], -1, 2)
    mux_any = torch.clamp(mux_i[..., 0] + mux_i[..., 1], max=1)
    meta_pair = mux_any * 64 + s_pair[..., 0] * 8 + s_pair[..., 1]
    meta = torch.repeat_interleave(meta_pair, 2, dim=-1).to(torch.int8)
    return codes, meta


def meta_shifts(meta: torch.Tensor) -> torch.Tensor:
    """Per-lane ShiftCtrl from the packed per-pair meta byte (§5.1), by
    lane of the LAST axis: even lanes (meta >> 3) & 7, odd lanes meta & 7."""
    m = meta.to(torch.int32)
    lane = torch.arange(m.shape[-1], device=m.device, dtype=torch.int32)
    return torch.where(lane % 2 == 0, torch.bitwise_right_shift(m, 3) & 7,
                       m & 7)


def sparq_pack(codes: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Reconstructed int8 codes -> stored window codes (§5.1 data nibbles):
    sign * (|codes| >> shift). Exact, since codes were window << shift."""
    q = codes.to(torch.int32)
    return (torch.sign(q) * torch.bitwise_right_shift(
        torch.abs(q), meta_shifts(meta))).to(torch.int8)


def _meta_decode32(store, meta, scale):
    """§5.1 meta-decode in int32 (no int8 narrowing), then * scale in f32:
    the exact datapath of the fused attention kernels."""
    q32 = store.to(torch.int32)
    recon = torch.sign(q32) * torch.bitwise_left_shift(torch.abs(q32),
                                                       meta_shifts(meta))
    return recon.to(torch.float32) * scale
