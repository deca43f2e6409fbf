"""K1: fused SPARQ quantize + int8 matmul — the CUDA kernel's wrapper and
its plain PyTorch version (port of `repro.kernels.sparq_matmul` and of the
oracle `repro.kernels.ref.ref_sparq_matmul`).

    out[M,N] f32 = (sum_k r[m,k] * w[k,n]) * a * c[n]

`r` is the SPARQ reconstruction of clip(round(x / a)). The integer sum is
exact in both versions, and both multiply (float(acc) * a) * c[n] in that
order, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparq import SparqConfig, sparq_recon_int
from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import quantize_codes

KERNEL = _b.CudaKernel(
    "sparq_matmul", "sparq_matmul.cu", "sparq_matmul_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    replaces="src/repro/kernels/sparq_matmul.py:96")


def _cfg(bits, shifts, rounding, vsparq, signed, enabled):
    return SparqConfig(bits=bits, opts=len(shifts), rounding=rounding,
                       vsparq=vsparq, signed=signed, enabled=enabled,
                       act_bits=8)


def ref_sparq_matmul(x, w_codes, act_scale, chan_scale, *, bits=4,
                     opts_shifts=(0, 1, 2, 3, 4), rounding=True, vsparq=True,
                     signed=False, max_val=255, enabled=True):
    """Plain version: float x (M, K), int8 weight codes (K, N) -> f32.

    The integer product runs in float64, which holds every partial sum of
    |r| <= 255 times |w| <= 127 exactly, so it equals the int32 sum on
    every device."""
    q = quantize_codes(x, act_scale, signed, max_val)
    cfg = _cfg(bits, opts_shifts, rounding, vsparq, signed, enabled)
    r = sparq_recon_int(q, cfg) if enabled else q
    acc = torch.matmul(r.to(torch.float64), w_codes.to(torch.float64))
    a = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
    return acc.to(torch.float32) * a * chan_scale.to(torch.float32)[None, :]


def sparq_matmul_cuda(x, w_codes, act_scale, chan_scale, *, bits=4,
                      opts_shifts=(0, 1, 2, 3, 4), rounding=True,
                      vsparq=True, signed=False, max_val=255, enabled=True):
    """Launch K1 on the current stream. x (M, K) f32 or bf16, w_codes
    (K, N) int8, act_scale a one-element f32 device tensor, chan_scale
    (N,) f32. Returns f32 (M, N)."""
    dev = x.device
    M, K = x.shape
    N = w_codes.shape[1]
    if not (signed and max_val <= 127):
        raise NotImplementedError(
            "the CUDA sparq_matmul takes signed codes with max_val <= 127 "
            "(int8 x int8); the unsigned max_val 255 path is not ported")
    if K % 2:
        raise ValueError(f"vSPARQ pairs adjacent K lanes; K={K} is odd")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x: dtype {x.dtype}, expected float32/bfloat16")
    _b.check(x, "x", x.dtype, (M, K), dev)
    _b.check(w_codes, "w_codes", torch.int8, (K, N), dev)
    a = act_scale.reshape(1)
    _b.check(a, "act_scale", torch.float32, (1,), dev)
    _b.check(chan_scale, "chan_scale", torch.float32, (N,), dev)
    mask = sum(1 << s for s in opts_shifts)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    KERNEL.launch(
        _b.ptr(x), int(x.dtype == torch.bfloat16), _b.ptr(w_codes),
        _b.ptr(a), _b.ptr(chan_scale), _b.ptr(out), M, N, K, bits, mask,
        max(opts_shifts), int(rounding), int(vsparq), int(signed), max_val,
        int(enabled), _b.stream_ptr(x))
    return out
