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
kernel (`csrc/sparq_mla_decode.cu`) splits the keys across blocks and sums
in f64, so the two agree to a tolerance, not bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import _meta_decode32
from repro_torch.kernels.sparq_decode_attn import (SPLIT_KEYS, _online_update,
                                                   _vec, _workspace,
                                                   row_stride)

# q_lat, q_pe, c_data, c_meta, c_scale, pe_data, pe_meta, pe_scale, pos,
# out, workspace, counters; B, H, r, dr, Tk, kps, vec; sm_scale; the stream
KERNEL = _b.CudaKernel(
    "sparq_mla_decode", "sparq_mla_decode.cu", "sparq_mla_decode_launch",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_float,
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


def _layout_bytes(H: int, r: int, dr: int, kps: int) -> int:
    """`smem_bytes` in csrc/sparq_mla_decode.cu: q [H][r + dr] and p
    [H][kps] in f64 (the count rounded up to even), then the f32 key tile
    [kps][row_stride(r + dr)]."""
    nd = H * (r + dr) + H * kps
    return 8 * (nd + nd % 2) + 4 * kps * row_stride(r + dr)


def split_keys(H: int, r: int, dr: int) -> int:
    """Keys of one split: SPLIT_KEYS, halved until one block's layout fits
    the card's shared memory. Raises when even one key does not fit."""
    kps = SPLIT_KEYS
    while _layout_bytes(H, r, dr, kps) > _b.SMEM_LIMIT and kps > 1:
        kps //= 2
    if _layout_bytes(H, r, dr, kps) > _b.SMEM_LIMIT:
        raise ValueError(
            f"MLA decode: H = {H}, r = {r}, dr = {dr} need "
            f"{_layout_bytes(H, r, dr, kps)} bytes of shared memory per "
            f"block, above the card's {_b.SMEM_LIMIT}")
    return kps


def smem_bytes(H: int, r: int, dr: int, n_splits: int = 1) -> int:
    """Dynamic shared memory of one block, as the launcher computes it:
    the split's layout, or the combine's m, l [n_splits][H] and 1 / l [H]
    in f32 (which reuse it) where they need more."""
    return max(_layout_bytes(H, r, dr, split_keys(H, r, dr)),
               4 * (2 * H * n_splits + H))


def sparq_mla_decode_cuda(q_lat, q_pe, c_data, c_meta, c_scale, pe_data,
                          pe_meta, pe_scale, pos, *, sm_scale: float):
    """Launch K7 on the current stream; arguments as the plain version,
    q_lat / q_pe f32, scales f32 and pos int32 one-element device tensors
    (no host sync). One launch: a block per (batch row, split of
    `split_keys` keys), the last block of a row combining its splits.
    Raises for a layout or a combine that does not fit a block.
    Returns f32 [B, H, r]."""
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
    kps = split_keys(H, r, dr)
    n_splits = -(-Tk // kps)
    if smem_bytes(H, r, dr, n_splits) > _b.SMEM_LIMIT:
        raise ValueError(f"MLA decode: {n_splits} splits of {kps} keys "
                         f"need more shared memory to combine than a block "
                         f"has")
    ws, cnt = _workspace(KERNEL, dev, B * n_splits * H * (r + 2), B)
    out = torch.empty((B, H, r), dtype=torch.float32, device=dev)
    vec = _vec(c_data, c_meta, pe_data, pe_meta) and r % 16 == 0 \
        and dr % 16 == 0
    with _b.on_device(q_lat):
        KERNEL.launch(
            _b.ptr(q_lat), _b.ptr(q_pe), _b.ptr(c_data), _b.ptr(c_meta),
            _b.ptr(c_scale), _b.ptr(pe_data), _b.ptr(pe_meta),
            _b.ptr(pe_scale), _b.ptr(pos), _b.ptr(out), _b.ptr(ws),
            _b.ptr(cnt), B, H, r, dr, Tk, kps, int(vec), float(sm_scale),
            _b.stream_ptr(q_lat))
    return out
