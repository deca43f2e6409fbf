"""K6: §5.1 meta-decode of the KV read-back path — the CUDA kernel's
wrapper and its plain PyTorch versions (port of
`repro.kernels.sparq_dequant.sparq_dequant_pallas` and of the oracle
`repro.kernels.ref.ref_sparq_dequant`, and in float mode of the scaling
that `repro.models.cache.CachedTensor.read` applies after it).

    codes = int8(sign(store) * (|store| << shift(meta, lane)))
    float = codes.to(float32) * scale          (then .to(dtype))

The product is formed in int32 and narrowed to int8 by keeping its low
byte in both versions, so they agree on every (store, meta) byte pair; the
float mode multiplies in IEEE f32 and rounds to bf16 to nearest even in
both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import meta_shifts

KERNEL = _b.CudaKernel(
    "sparq_dequant", "sparq_dequant.cu", "sparq_dequant_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sparq_dequant.py:38")

# output mode of sparq_dequant_launch by output dtype (None: int8 codes)
OUT_MODES = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def ref_sparq_dequant(store: torch.Tensor, meta: torch.Tensor):
    """Plain version: int8 window codes + packed meta (..., K) -> int8
    reconstructed codes, lane parity taken along the last axis."""
    q = store.to(torch.int32)
    recon = torch.bitwise_left_shift(torch.abs(q), meta_shifts(meta))
    return (torch.sign(q) * recon).to(torch.int8)


def ref_sparq_dequant_float(store, meta, scale, dtype=None):
    """Plain float mode: the decoded codes times the f32 scale (0-d), cast
    to `dtype` when given (CachedTensor.read's arithmetic)."""
    out = ref_sparq_dequant(store, meta).to(torch.float32) * scale
    return out if dtype is None else out.to(dtype)


def sparq_dequant_cuda(store: torch.Tensor, meta: torch.Tensor,
                       scale=None, dtype=None):
    """Launch K6 on the current stream. store, meta int8 (M, K), K even.
    Codes mode (scale None): returns int8 (M, K). Float mode: scale f32 0-d
    or (1,) on the card; returns `dtype` (float32 when None, or bfloat16)
    (M, K)."""
    dev = store.device
    M, K = store.shape
    if K % 2:
        raise ValueError(f"the meta byte covers lane pairs; K={K} is odd")
    _b.check(store, "store", torch.int8, (M, K), dev)
    _b.check(meta, "meta", torch.int8, (M, K), dev)
    if scale is None:
        out_dtype = None
    else:
        out_dtype = torch.float32 if dtype is None else dtype
        if out_dtype not in OUT_MODES:
            raise ValueError(f"float mode writes float32 or bfloat16, not "
                             f"{out_dtype}")
        _b.check(scale.reshape(1), "scale", torch.float32, (1,), dev)
    out = torch.empty((M, K), dtype=out_dtype or torch.int8, device=dev)
    with _b.on_device(store):
        KERNEL.launch(_b.ptr(store), _b.ptr(meta), _b.ptr(out), _b.ptr(scale),
                      OUT_MODES[out_dtype], M, K, _b.stream_ptr(store))
    return out
