"""Flash-decode attention over the §5.1 packed KV cache — the CUDA kernels'
wrappers and their plain PyTorch versions:

  K2  paged: pages gathered through a block table (port of
      `repro.kernels.sparq_decode_attn.sparq_paged_decode_attn_pallas` and
      of the oracle `repro.kernels.ref.ref_sparq_paged_decode_attn`);
  K5  contiguous: [B, Tk] planes with per-slot positions `kpos` (port of
      `sparq_decode_attn_pallas` and of `ref.ref_sparq_decode_attn`).

Both plain versions run the same per-tile f32 operations (`_online_update`,
the same einsums), so with bk == page_size they agree bit for bit, as the
two kernels do."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import _meta_decode32

KERNEL = _b.CudaKernel(
    "sparq_paged_decode_attn", "sparq_paged_decode_attn.cu",
    "sparq_paged_decode_attn_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                   ctypes.c_void_p],
    replaces="src/repro/kernels/sparq_decode_attn.py:187")

CONTIG_KERNEL = _b.CudaKernel(
    "sparq_decode_attn", "sparq_decode_attn.cu", "sparq_decode_attn_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                   ctypes.c_void_p],
    replaces="src/repro/kernels/sparq_decode_attn.py:114")

NEG_INF = float("-inf")


def _online_update(m, l, s, ok):
    """Shared online-softmax statistics update of the oracles: returns
    (m_new, l_new, corr, p) with m_safe = 0 where m is -inf, corr = 0
    where the previous m is -inf, masked probabilities 0."""
    s = torch.where(ok, s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.where(ok, torch.exp(s - m_safe), 0.0)
    corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
    return m_new, l_new, corr, p


def ref_sparq_paged_decode_attn(q, k_data, k_meta, k_scale, v_data, v_meta,
                                v_scale, block_table, cur, *,
                                window: int = 0):
    """Plain version: one Tk tile == one page fetched through the block
    table, §5.1 meta-decode per tile, online softmax in f32.

    q [B, KV, G, hd]; pools [P, ps, KV, hd] int8; scales [B] f32;
    block_table [B, NB] int32 (-1 unallocated); cur [B] int32 (< 0 =
    inactive: output 0). Returns f32 [B, KV, G, hd]."""
    B, KV, G, hd = q.shape
    ps = k_data.shape[1]
    NB = block_table.shape[1]
    qf = q.to(torch.float32)
    sm_scale = hd ** -0.5
    ks = k_scale.to(torch.float32).reshape(B, 1, 1, 1)
    vs = v_scale.to(torch.float32).reshape(B, 1, 1, 1)
    cur_b = cur.to(torch.int32).reshape(B, 1)
    dev = q.device
    m = torch.full((B, KV, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, hd), dtype=torch.float32, device=dev)
    arange = torch.arange(ps, dtype=torch.int32, device=dev)[None]
    for t in range(NB):
        pages = block_table[:, t]
        safe = torch.clamp(pages, min=0).long()
        k = _meta_decode32(k_data[safe], k_meta[safe], ks)
        s = torch.einsum("bkgh,bskh->bkgs", qf, k) * sm_scale
        kp = t * ps + arange
        ok = (pages >= 0)[:, None] & (kp <= cur_b)
        if window:
            ok = ok & (kp > cur_b - window)
        m, l, corr, p = _online_update(m, l, s, ok[:, None, None, :])
        v = _meta_decode32(v_data[safe], v_meta[safe], vs)
        acc = acc * corr + torch.einsum("bkgs,bskh->bkgh", p, v)
    return acc / torch.clamp(l, min=1e-30)


def sparq_paged_decode_attn_cuda(q, k_data, k_meta, k_scale, v_data, v_meta,
                                 v_scale, block_table, cur, *,
                                 window: int = 0):
    """Launch K2 on the current stream; arguments as the plain version,
    q f32 [B, KV, G, hd], scales f32 [B], block_table/cur int32."""
    dev = q.device
    B, KV, G, hd = q.shape
    P, ps = k_data.shape[:2]
    NB = block_table.shape[1]
    _b.check(q, "q", torch.float32, (B, KV, G, hd), dev)
    for name, t in (("k_data", k_data), ("k_meta", k_meta),
                    ("v_data", v_data), ("v_meta", v_meta)):
        _b.check(t, name, torch.int8, (P, ps, KV, hd), dev)
    _b.check(k_scale, "k_scale", torch.float32, (B,), dev)
    _b.check(v_scale, "v_scale", torch.float32, (B,), dev)
    _b.check(block_table, "block_table", torch.int32, (B, NB), dev)
    _b.check(cur, "cur", torch.int32, (B,), dev)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    KERNEL.launch(
        _b.ptr(q), _b.ptr(k_data), _b.ptr(k_meta), _b.ptr(k_scale),
        _b.ptr(v_data), _b.ptr(v_meta), _b.ptr(v_scale), _b.ptr(block_table),
        _b.ptr(cur), _b.ptr(out), B, KV, G, hd, ps, NB, int(window),
        float(hd ** -0.5), _b.stream_ptr(q))
    return out


def ref_sparq_decode_attn(q, k_data, k_meta, k_scale, v_data, v_meta,
                          v_scale, kpos, cur, *, window: int = 0,
                          bk: int = 128):
    """Plain version: the oracle's Tk-tile loop, §5.1 meta-decode per tile,
    online softmax in f32. A ragged last tile is padded here with zero
    codes and kpos -1 (masked), as the reference dispatcher pads.

    q [B, KV, G, hd]; planes [B, Tk, KV, hd] int8; scales one-element f32;
    kpos [B, Tk] int32 (-1 = empty slot); cur one-element int32. Returns
    f32 [B, KV, G, hd]."""
    B, KV, G, hd = q.shape
    Tk = k_data.shape[1]
    pad = (-Tk) % bk
    if pad:
        def zpad(t, value=0):
            shape = (B, pad) + tuple(t.shape[2:])
            return torch.cat([t, torch.full(shape, value, dtype=t.dtype,
                                             device=t.device)], 1)
        k_data, k_meta, v_data, v_meta = map(zpad, (k_data, k_meta, v_data,
                                                    v_meta))
        kpos = zpad(kpos, -1)
    qf = q.to(torch.float32)
    sm_scale = hd ** -0.5
    ks = k_scale.to(torch.float32).reshape(())
    vs = v_scale.to(torch.float32).reshape(())
    c = cur.to(torch.int32).reshape(())
    dev = q.device
    m = torch.full((B, KV, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, hd), dtype=torch.float32, device=dev)
    for t0 in range(0, Tk + pad, bk):
        sl = slice(t0, t0 + bk)
        k = _meta_decode32(k_data[:, sl], k_meta[:, sl], ks)
        s = torch.einsum("bkgh,bskh->bkgs", qf, k) * sm_scale
        kp = kpos[:, sl].to(torch.int32)
        ok = (kp >= 0) & (kp <= c)
        if window:
            ok = ok & (kp > c - window)
        m, l, corr, p = _online_update(m, l, s, ok[:, None, None, :])
        v = _meta_decode32(v_data[:, sl], v_meta[:, sl], vs)
        acc = acc * corr + torch.einsum("bkgs,bskh->bkgh", p, v)
    return acc / torch.clamp(l, min=1e-30)


def sparq_decode_attn_cuda(q, k_data, k_meta, k_scale, v_data, v_meta,
                           v_scale, kpos, cur, *, window: int = 0,
                           bk: int = 128):
    """Launch K5 on the current stream; arguments as the plain version,
    q f32 [B, KV, G, hd], scales f32 and cur int32 one-element device
    tensors (no host sync), kpos int32 [B, Tk]. The kernel masks the
    ragged last tile itself: the planes are read in place, never padded."""
    dev = q.device
    B, KV, G, hd = q.shape
    Tk = k_data.shape[1]
    if bk < 1:
        raise ValueError(f"bk must be >= 1, got {bk}")
    _b.check(q, "q", torch.float32, (B, KV, G, hd), dev)
    for name, t in (("k_data", k_data), ("k_meta", k_meta),
                    ("v_data", v_data), ("v_meta", v_meta)):
        _b.check(t, name, torch.int8, (B, Tk, KV, hd), dev)
    k_scale, v_scale, cur = (t.reshape(1) for t in (k_scale, v_scale, cur))
    _b.check(k_scale, "k_scale", torch.float32, (1,), dev)
    _b.check(v_scale, "v_scale", torch.float32, (1,), dev)
    _b.check(kpos, "kpos", torch.int32, (B, Tk), dev)
    _b.check(cur, "cur", torch.int32, (1,), dev)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    CONTIG_KERNEL.launch(
        _b.ptr(q), _b.ptr(k_data), _b.ptr(k_meta), _b.ptr(k_scale),
        _b.ptr(v_data), _b.ptr(v_meta), _b.ptr(v_scale), _b.ptr(kpos),
        _b.ptr(cur), _b.ptr(out), B, Tk, KV, G, hd, bk, int(window),
        float(hd ** -0.5), _b.stream_ptr(q))
    return out
