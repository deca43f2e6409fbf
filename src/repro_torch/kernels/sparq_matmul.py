"""K1: fused SPARQ quantize + 8-bit integer matmul — the CUDA kernel's
wrapper and its plain PyTorch version (port of `repro.kernels.sparq_matmul`
and of the oracle `repro.kernels.ref.ref_sparq_matmul`).

    out[M,N] f32 = (sum_k r[m,k] * w[k,n]) * a * c[n]

`r` is the SPARQ reconstruction of clip(round(x / a)): signed codes in
[-127, 127] (int8 x int8 on the card) or, in the paper's unsigned mode
(post-ReLU activations, max_val up to 255), codes in [0, 255] (uint8 x
int8). The weights `w` are int8 in both. The integer sum is
exact in both versions, and both multiply (float(acc) * a) * c[n] in that
order, so they agree bit for bit.

`plan(M, N, K)` is the CUDA kernel's tiling, a pure function that the
wrapper passes to the C entry point: the output tile, and the K slices
(split-K) that give a small-M call enough blocks to stream its weights on
every SM. The slices' int32 partial sums are exact in any order and the
epilogue runs once on their total, so a split changes no bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.core.sparq import SparqConfig, sparq_recon_int
from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import quantize_codes

KERNEL = _b.CudaKernel(
    "sparq_matmul", "sparq_matmul.cu", "sparq_matmul_launch",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 17 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sparq_matmul.py:96")

# k bytes per tile of the CUDA kernel: two mma k-steps of 32, and even, so
# a K slice never splits a vSPARQ pair
BK = 64
# (BM, BN) output tiles above M = 1024, in order of preference; the
# kernel is instantiated for these and for 16 x 128 and 64 x 128
_LARGE_TILES = ((128, 128), (64, 32))
# depth of the GEMM's cp.async ring, and the bytes a staged k row of the
# weight tile takes whatever BN is (`STAGES`, `B_ROW` in the .cu)
STAGES = 4
B_ROW = 128


class Plan(NamedTuple):
    """Tiling of one K1 call: output tiles BM x BN, k tiles of BK, and K
    cut into `split_k` slices of `tiles_per_split` whole k tiles (the last
    may be shorter). `kp` is K rounded up to BK (the row length of the
    quantized codes r); `blocks` counts the GEMM's blocks."""
    bm: int
    bn: int
    bk: int
    split_k: int
    tiles_per_split: int
    kp: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, K: int, sms: int = 132) -> Plan:
    """The tile plan of one K1 call on a card with `sms` SMs.

    The output tile follows M: 16 x 128 at decode (M <= 16), 64 x 128 up
    to M = 1024, else 128 x 128, or 64 x 32 where 128 x 128 tiles number
    fewer than `sms` (wk/wv at the scan prefill). When the output tiles
    give fewer blocks than `sms`, K is split into slices of whole k tiles:
    the fewest slices that give at least 1.5 blocks per SM, or one k tile
    per slice when even that gives fewer."""
    if M <= 0 or N <= 0 or K <= 0:
        raise ValueError(f"empty matmul {(M, N, K)}")
    cands = (((16, 128),) if M <= 16 else ((64, 128),) if M <= 1024
             else _LARGE_TILES)
    bm, bn = next((c for c in cands
                   if _cdiv(M, c[0]) * _cdiv(N, c[1]) >= sms), cands[-1])
    tiles = _cdiv(M, bm) * _cdiv(N, bn)
    kt = _cdiv(K, BK)
    tps = kt
    if tiles < sms:
        for want in range(2, kt + 1):       # fewest slices first
            tps = _cdiv(kt, want)           # balanced slices
            if tiles * _cdiv(kt, tps) * 2 >= 3 * sms:
                break
    split = _cdiv(kt, tps)
    return Plan(bm, bn, BK, split, tps, kt * BK, tiles * split)


def smem_bytes(p: Plan) -> int:
    """Dynamic shared memory of one GEMM block of plan `p`, as the launcher
    sets it: the STAGES-deep ring of BM x BK code tiles and BK x B_ROW
    weight tiles."""
    return STAGES * (p.bm * p.bk + p.bk * B_ROW)


def hbm_bytes(p: Plan, M: int, N: int, K: int, x_bytes: int = 4) -> int:
    """Device-memory bytes of one K1 call of plan `p`, as the plan implies
    when no read hits L2: the pre-pass reads x (`x_bytes` a value) and
    writes the codes r (M x kp, a byte each); the GEMM reads r once per N
    tile and w once per M tile; with split-K every slice writes its int32
    partial sums and the tile's last block reads them all back; the
    epilogue writes the f32 output. The scales (N + 1 floats) and
    split-K's arrival counters (one int a tile) are left out. The codec
    does not enter: SPARQ's logic runs in registers."""
    pre = M * K * x_bytes + M * p.kp
    gemm = M * p.kp * _cdiv(N, p.bn) + K * N * _cdiv(M, p.bm)
    partials = 2 * 4 * p.split_k * M * N if p.split_k > 1 else 0
    return pre + gemm + partials + 4 * M * N


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """SMs of the card `dev`: the `sms` of its plans."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def k_slices(p: Plan, K: int) -> List[Tuple[int, int]]:
    """[k_begin, k_end) of each K slice, as the kernel's blockIdx.z cuts
    K: slice z starts at z * tiles_per_split * BK."""
    step = p.tiles_per_split * p.bk
    return [(z * step, min(K, (z + 1) * step)) for z in range(p.split_k)]


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
    (N,) f32. Returns f32 (M, N). Signed codecs (max_val <= 127) run
    int8 x int8 on the tensor cores, unsigned ones (max_val <= 255)
    uint8 x int8. The C entry point launches two kernels (the quantizing
    pre-pass and the GEMM); the call counts as one launch of K1."""
    dev = x.device
    M, K = x.shape
    N = w_codes.shape[1]
    if not 1 <= max_val <= (127 if signed else 255):
        raise ValueError(f"max_val {max_val} out of range for "
                         f"{'signed int8' if signed else 'unsigned uint8'} "
                         f"codes")
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
    p = plan(M, N, K, sm_count(dev))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    # one scratch buffer: the codes r (M, kp), a byte each, then with
    # split-K the int32 partial sums (split_k, M, N) and one arrival
    # counter per tile
    ws_off = _cdiv(M * p.kp, 256) * 256
    n_ws = p.split_k * M * N + p.blocks // p.split_k if p.split_k > 1 else 0
    scratch = torch.empty((ws_off + 4 * n_ws,), dtype=torch.uint8,
                          device=dev)
    base = scratch.data_ptr()
    ws = base + ws_off if n_ws else 0
    arrivals = ws + 4 * p.split_k * M * N if n_ws else 0
    w_vec = int(N % 16 == 0 and w_codes.data_ptr() % 16 == 0)
    with _b.on_device(x):
        KERNEL.launch(
            _b.ptr(x), int(x.dtype == torch.bfloat16), _b.ptr(w_codes),
            _b.ptr(a), _b.ptr(chan_scale), _b.ptr(out), ctypes.c_void_p(base),
            ctypes.c_void_p(ws), ctypes.c_void_p(arrivals), M, N, K, p.kp,
            p.bm, p.bn, p.tiles_per_split, p.split_k, w_vec, bits, mask,
            max(opts_shifts), int(rounding), int(vsparq), int(signed), max_val,
            int(enabled), _b.stream_ptr(x))
    return out
