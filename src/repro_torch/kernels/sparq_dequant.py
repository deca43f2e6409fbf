"""K6: §5.1 meta-decode of the KV read-back path — the CUDA kernel's
wrapper and its plain PyTorch version (port of
`repro.kernels.sparq_dequant.sparq_dequant_pallas` and of the oracle
`repro.kernels.ref.ref_sparq_dequant`).

    codes = int8(sign(store) * (|store| << shift(meta, lane)))

The product is formed in int32 and narrowed to int8 by keeping its low
byte in both versions, so they agree on every (store, meta) byte pair.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import meta_shifts

KERNEL = _b.CudaKernel(
    "sparq_dequant", "sparq_dequant.cu", "sparq_dequant_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sparq_dequant.py:38")


def ref_sparq_dequant(store: torch.Tensor, meta: torch.Tensor):
    """Plain version: int8 window codes + packed meta (..., K) -> int8
    reconstructed codes, lane parity taken along the last axis."""
    q = store.to(torch.int32)
    recon = torch.bitwise_left_shift(torch.abs(q), meta_shifts(meta))
    return (torch.sign(q) * recon).to(torch.int8)


def sparq_dequant_cuda(store: torch.Tensor, meta: torch.Tensor):
    """Launch K6 on the current stream. store, meta int8 (M, K), K even.
    Returns int8 (M, K)."""
    dev = store.device
    M, K = store.shape
    if K % 2:
        raise ValueError(f"the meta byte covers lane pairs; K={K} is odd")
    _b.check(store, "store", torch.int8, (M, K), dev)
    _b.check(meta, "meta", torch.int8, (M, K), dev)
    if store.data_ptr() % 2 or meta.data_ptr() % 2:
        store, meta = store.clone(), meta.clone()   # read as 16-bit pairs
    codes = torch.empty((M, K), dtype=torch.int8, device=dev)
    KERNEL.launch(_b.ptr(store), _b.ptr(meta), _b.ptr(codes), M, K,
                  _b.stream_ptr(store))
    return codes
