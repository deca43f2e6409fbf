"""K4: SPARQ quantization of the KV write path — the CUDA kernel's wrapper
beside its plain PyTorch version `repro_torch.kernels.ref.ref_sparq_quant`
(port of `repro.kernels.sparq_quant.sparq_quant_pallas` and of the oracle
`repro.kernels.ref.ref_sparq_quant`).

    (codes, meta) = quant(x / a)

`codes` are the reconstructed int8 values (window << shift, sign applied)
and `meta` the per-pair byte mux_any*64 + shift_even*8 + shift_odd on both
lanes. Both versions are integer arithmetic after one IEEE f32 division,
so they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import ref_sparq_quant  # noqa: F401 (plain)

KERNEL = _b.CudaKernel(
    "sparq_quant", "sparq_quant.cu", "sparq_quant_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p] + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sparq_quant.py:79")


def sparq_quant_cuda(x, scale, *, bits=4, opts_shifts=(0, 1, 2, 3, 4),
                     rounding=True, vsparq=True, signed=True, max_val=127,
                     enabled=True):
    """Launch K4 on the current stream. x (M, K) f32 with K even; scale
    f32 (1,) (one step for every row) or (M,) (one per row). Returns
    (codes, meta), int8 (M, K)."""
    dev = x.device
    M, K = x.shape
    if K % 2:
        raise ValueError(f"vSPARQ pairs adjacent lanes; K={K} is odd")
    _b.check(x, "x", torch.float32, (M, K), dev)
    if x.data_ptr() % 8:
        x = x.clone()             # the kernel reads each pair as a float2
    per_row = scale.numel() != 1
    _b.check(scale, "scale", torch.float32, (M,) if per_row else (1,), dev)
    codes = torch.empty((M, K), dtype=torch.int8, device=dev)
    meta = torch.empty((M, K), dtype=torch.int8, device=dev)
    KERNEL.launch(
        _b.ptr(x), _b.ptr(scale), int(per_row), _b.ptr(codes), _b.ptr(meta),
        M, K, bits, sum(1 << s for s in opts_shifts), max(opts_shifts),
        int(rounding), int(vsparq), int(signed), max_val, int(enabled),
        _b.stream_ptr(x))
    return codes, meta
