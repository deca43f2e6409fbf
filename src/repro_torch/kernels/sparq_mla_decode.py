"""K7: absorbed-MLA flash-decode over the two §5.1 packed latent planes —
the CUDA kernel's wrapper beside its plain PyTorch version (port of
`repro.models.mla._sparq_mla_decode`, a tiled `lax.scan` in the reference
and no Pallas kernel: each tile there meta-decodes both planes through
`sparq_dequantize` and folds them into an online softmax).

    s[t]  = (q_lat . c[t] + q_pe . pe[t]) * sm_scale,   t < pos
    o_lat = softmax(s) . c                               [B, H, r]

c and pe are each plane's §5.1 codes times its own f32 scale. The keys are
[c, pe] (width r + dr), the values the latent plane c itself (width r).

The plain version walks the reference's tile loop in its f32 op order. The
kernel (`csrc/sparq_mla_decode.cu`) runs the products on f16 tensor cores
over the exact codes, q and p split into f16 terms, and walks a run of key
tiles a block; a cluster of blocks (`plan`) combines a batch row's splits.
The two agree to a tolerance, not bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import _meta_decode32
from repro_torch.kernels.sparq_decode_attn import _online_update, _vec

# q_lat, q_pe, c_data, c_meta, c_scale, pe_data, pe_meta, pe_scale, pos,
# out; B, H, r, dr, Tk, n_splits, vec; sm_scale; the stream
KERNEL = _b.CudaKernel(
    "sparq_mla_decode", "sparq_mla_decode.cu", "sparq_mla_decode_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                  ctypes.c_void_p],
    replaces="src/repro/models/mla.py:58")


def ref_sparq_mla_decode(q_lat, q_pe, c_data, c_meta, c_scale, pe_data,
                         pe_meta, pe_scale, pos, *, sm_scale: float,
                         bk: int = 128):
    """Plain version: the reference's tile loop. bk keys a tile (clamped
    to Tk), the time axis zero-padded to a tile multiple (padded keys have
    t >= Tk >= pos, so the mask drops them), each tile meta-decoded and
    scaled in f32, online softmax in f32 (`_online_update`: m_safe and
    corr as the reference's -inf rules).

    q_lat [B, H, r], q_pe [B, H, dr] float; c planes [B, Tk, r] and pe
    planes [B, Tk, dr] int8; scales and pos 0-d or one-element (f32,
    int32). Returns f32 [B, H, r]."""
    B, H, r = q_lat.shape
    Tk = c_data.shape[1]
    bk = min(bk, Tk)
    pad = (-Tk) % bk
    if pad:
        def zpad(t):
            return torch.cat([t, torch.zeros((B, pad, t.shape[2]),
                                             dtype=t.dtype,
                                             device=t.device)], 1)
        c_data, c_meta, pe_data, pe_meta = map(
            zpad, (c_data, c_meta, pe_data, pe_meta))
    dev = q_lat.device
    ql, qp = q_lat.to(torch.float32), q_pe.to(torch.float32)
    cs = c_scale.to(torch.float32).reshape(())
    ps = pe_scale.to(torch.float32).reshape(())
    p_ = pos.to(torch.int32).reshape(())
    m = torch.full((B, H, 1), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, r), dtype=torch.float32, device=dev)
    for t0 in range(0, Tk + pad, bk):
        sl = slice(t0, t0 + bk)
        c_f = _meta_decode32(c_data[:, sl], c_meta[:, sl], cs)
        pe_f = _meta_decode32(pe_data[:, sl], pe_meta[:, sl], ps)
        s = (torch.einsum("bhr,bsr->bhs", ql, c_f)
             + torch.einsum("bhe,bse->bhs", qp, pe_f)) * sm_scale
        kp = torch.arange(t0, t0 + bk, dtype=torch.int32, device=dev)
        ok = (kp < p_)[None, None, :]
        m, l, corr, p = _online_update(m, l, s, ok)
        acc = acc * corr + torch.einsum("bhs,bsr->bhr", p, c_f)
    return acc / torch.clamp(l, min=1e-30)


# keys a tile, raw tiles in the cp.async ring, head rows of a block (one
# m16 tile), threads and warps of a block, the largest cluster, and the
# f16 terms of q (under its row's power-of-two scale) and of p 2^15: TK,
# STAGES, HR, THREADS, WARPS, MAX_SPLITS, QT and PT in
# csrc/sparq_mla_decode.cu
TILE = 32
STAGES = 3
HEAD_ROWS = 16
THREADS = 256
WARPS = THREADS // 32
MAX_SPLITS = 16
Q_TERMS, P_TERMS = 2, 2
# the kernel's (KSW, NP) instantiations, in the order the launcher tries
# them (KSW k-steps of 16 key columns a warp holds Q fragments for, NP
# pairs of 8-column output tiles a warp owns): the reduced deepseek's
# widths, the published ones, and any other r + dr <= 1024, r <= 1024
INSTANCES = ((1, 1), (5, 4), (8, 8))


class MlaPlan(NamedTuple):
    """One K7 launch: a cluster of n_splits blocks (grid x) for each of the
    head_groups groups of 16 heads (grid y) of each batch row (grid z).
    The kernel reads pos and cuts the ceil(min(pos, Tk) / tile) live tiles
    into n_splits runs of ceil(live tiles / n_splits); block z walks run
    z, empty when it starts past the live tiles."""
    tile: int
    n_tiles: int
    n_splits: int
    head_groups: int
    instance: tuple
    smem: int


def tile_ld(r: int, dr: int) -> int:
    """Row stride (f16) of the decoded tile: r + dr rounded up to 16, plus
    8 (`tile_ld` in the kernel)."""
    return 16 * -(-(r + dr) // 16) + 8


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(r: int, dr: int) -> int:
    """Dynamic shared memory of one block (`Layout` in the kernel): STAGES
    raw stages of TILE keys' r + dr data and meta bytes, the f16 tile
    [TILE][tile_ld], the eight warps' partial scores [16][TILE + 4] f32,
    the P tile [P_TERMS][16][TILE + 8] f16, the row statistics (4 x 16
    f32) and the combine's buffer (the block's share of the cluster's
    accumulators, at most 16 r / 2 + MAX_SPLITS float2, and m, l
    [MAX_SPLITS][2][16] f32). Independent of H, Tk and the splits."""
    stage = _align16(TILE * (r + dr) * 2)
    tile = _align16(TILE * tile_ld(r, dr) * 2)
    red = 4 * WARPS * HEAD_ROWS * (TILE + 4)
    ptile = 2 * P_TERMS * HEAD_ROWS * (TILE + 8)
    comb = _align16(8 * (HEAD_ROWS * r // 2 + MAX_SPLITS)
                    + 4 * 2 * HEAD_ROWS * MAX_SPLITS)
    return STAGES * stage + tile + red + ptile + 4 * 4 * HEAD_ROWS + comb


def instance(r: int, dr: int) -> tuple:
    """The kernel instantiation that covers r, dr: the first of INSTANCES
    with KSW >= ceil(ceil((r + dr) / 16) / WARPS) and NP >=
    ceil(ceil(r / 16) / WARPS). Raises when none does."""
    kw = -(-(-(-(r + dr) // 16)) // WARPS)
    pw = -(-(-(-r // 16)) // WARPS)
    for ksw, np_ in INSTANCES:
        if kw <= ksw and pw <= np_:
            return ksw, np_
    raise ValueError(f"MLA decode: r = {r}, dr = {dr} pass the widest "
                     f"instantiation {INSTANCES[-1]}")


def plan(B: int, H: int, r: int, dr: int, Tk: int,
         clusters: Dict[int, int]) -> MlaPlan:
    """K7's launch plan. The splits of a (batch row, head group) are the
    largest n <= MAX_SPLITS for which the card holds B x head_groups
    clusters of n blocks at once (`clusters`: {n: such clusters}, from
    `cluster_capacity`), so the whole call runs in one wave; 1 when none;
    never more than the cache's tiles. pos is a device scalar, so the
    kernel itself cuts the live tiles into the splits' runs. Raises
    ValueError for widths whose block does not fit the card's shared
    memory or no instantiation covers."""
    if min(B, H, r, dr, Tk) <= 0:
        raise ValueError(f"MLA decode: B {B}, H {H}, r {r}, dr {dr}, Tk "
                         f"{Tk} must be positive")
    smem = smem_bytes(r, dr)
    if smem > _b.SMEM_LIMIT:
        raise ValueError(f"MLA decode: r = {r}, dr = {dr} need {smem} bytes "
                         f"of shared memory per block, above the card's "
                         f"{_b.SMEM_LIMIT}")
    inst = instance(r, dr)
    groups = -(-H // HEAD_ROWS)
    want = max([n for n in range(1, MAX_SPLITS + 1)
                if clusters.get(n, 0) >= B * groups], default=1)
    n_tiles = -(-Tk // TILE)
    return MlaPlan(TILE, n_tiles, min(want, n_tiles), groups, inst, smem)


_CAPACITY: Dict[tuple, Dict[int, int]] = {}


def cluster_capacity(dev: torch.device, r: int, dr: int) -> Dict[int, int]:
    """{n: clusters of n blocks at widths r, dr the card `dev` holds at
    once}, asked of the card (cudaOccupancyMaxActiveClusters, the kernel's
    own query) once a device and widths."""
    key = (torch.device(dev).index, r, dr)
    if key not in _CAPACITY:
        query = KERNEL.function(
            "sparq_mla_decode_max_clusters",
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
        got = {}
        with torch.cuda.device(dev):
            for n in range(1, MAX_SPLITS + 1):
                count = ctypes.c_int(0)
                rc = query(HEAD_ROWS, r, dr, n, ctypes.byref(count))
                got[n] = count.value if rc == 0 else 0
        _CAPACITY[key] = got
    return _CAPACITY[key]


def sparq_mla_decode_cuda(q_lat, q_pe, c_data, c_meta, c_scale, pe_data,
                          pe_meta, pe_scale, pos, *, sm_scale: float):
    """Launch K7 on the current stream; arguments as the plain version,
    q_lat / q_pe f32, scales f32 and pos int32 one-element device tensors
    (no host sync). One launch of `plan`'s clusters: each block an online
    softmax over its run of tiles, the cluster combining a row's splits in
    distributed shared memory; no workspace, any Tk. Raises for widths
    whose block does not fit. Returns f32 [B, H, r]."""
    dev = q_lat.device
    B, H, r = q_lat.shape
    dr = q_pe.shape[2]
    Tk = c_data.shape[1]
    _b.check(q_lat, "q_lat", torch.float32, (B, H, r), dev)
    _b.check(q_pe, "q_pe", torch.float32, (B, H, dr), dev)
    if r % 2 or dr % 2:
        raise ValueError(f"the meta byte covers lane pairs; r = {r}, dr = "
                         f"{dr} must be even")
    for name, t, w in (("c_data", c_data, r), ("c_meta", c_meta, r),
                       ("pe_data", pe_data, dr), ("pe_meta", pe_meta, dr)):
        _b.check(t, name, torch.int8, (B, Tk, w), dev)
    c_scale, pe_scale, pos = (t.reshape(1) for t in (c_scale, pe_scale,
                                                      pos))
    _b.check(c_scale, "c_scale", torch.float32, (1,), dev)
    _b.check(pe_scale, "pe_scale", torch.float32, (1,), dev)
    _b.check(pos, "pos", torch.int32, (1,), dev)
    out = torch.empty((B, H, r), dtype=torch.float32, device=dev)
    vec = _vec(c_data, c_meta, pe_data, pe_meta) and r % 16 == 0 \
        and dr % 16 == 0
    with _b.on_device(q_lat):
        p = plan(B, H, r, dr, Tk, cluster_capacity(dev, r, dr))
        KERNEL.launch(
            _b.ptr(q_lat), _b.ptr(q_pe), _b.ptr(c_data), _b.ptr(c_meta),
            _b.ptr(c_scale), _b.ptr(pe_data), _b.ptr(pe_meta),
            _b.ptr(pe_scale), _b.ptr(pos), _b.ptr(out), B, H, r, dr, Tk,
            p.n_splits, int(vec), float(sm_scale),
            _b.stream_ptr(q_lat))
    return out
