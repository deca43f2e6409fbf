"""K3: ragged chunked-prefill attention over the §5.1 page pool — the CUDA
kernel's wrapper and its plain PyTorch version (port of
`repro.kernels.sparq_prefill_attn.sparq_chunked_prefill_attn_pallas` and of
the oracle `repro.kernels.ref.ref_sparq_chunked_prefill_attn`)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import _meta_decode32
from repro_torch.kernels.sparq_decode_attn import NEG_INF, _online_update

KERNEL = _b.CudaKernel(
    "sparq_chunked_prefill_attn", "sparq_chunked_prefill_attn.cu",
    "sparq_chunked_prefill_attn_launch",
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                   ctypes.c_void_p],
    replaces="src/repro/kernels/sparq_prefill_attn.py:138")


def ref_sparq_chunked_prefill_attn(q, k_chunk, v_chunk, k_data, k_meta,
                                   k_scale, v_data, v_meta, v_scale,
                                   block_table, seq_id, pos, hist,
                                   tile_seq, *, window: int = 0):
    """Plain version. Each stream token attends to (1) its sequence's
    packed pages for kpos < hist (block-table gather, meta-decode per
    page tile), then (2) the chunk's float K/V of the same sequence with
    hist <= kpos <= pos. Pages first (ascending), chunk last.

    q [C, KV, G, hd]; k/v_chunk [C, KV, hd]; pools [P, ps, KV, hd] int8;
    scales [S] f32; block_table [S, NB]; seq_id/pos/hist [C] (-1 seq_id =
    padding); tile_seq [C/bq]. Returns f32 [C, KV, G, hd], zeros on
    padding rows."""
    C, KV, G, hd = q.shape
    ps = k_data.shape[1]
    NB = block_table.shape[1]
    nt = tile_seq.shape[0]
    assert C % nt == 0, (C, nt)
    bq = C // nt
    dev = q.device
    qf = q.to(torch.float32)
    sm_scale = hd ** -0.5
    tseq = torch.repeat_interleave(tile_seq.long(), bq)
    s_safe = torch.clamp(tseq, min=0)
    ksc = k_scale.to(torch.float32)[s_safe]
    vsc = v_scale.to(torch.float32)[s_safe]
    qhist = hist.to(torch.int32)
    sid = seq_id.to(torch.int32)
    qpos = pos.to(torch.int32)
    qvalid = sid >= 0
    m = torch.full((C, KV, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((C, KV, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((C, KV, G, hd), dtype=torch.float32, device=dev)
    arange = torch.arange(ps, dtype=torch.int32, device=dev)[None]
    for t in range(NB):
        pages = block_table[s_safe, t]
        pg = torch.clamp(pages, min=0).long()
        k = _meta_decode32(k_data[pg], k_meta[pg], ksc[:, None, None, None])
        s = torch.einsum("ckgh,cskh->ckgs", qf, k) * sm_scale
        kp = t * ps + arange
        ok = (pages >= 0)[:, None] & qvalid[:, None] & (kp < qhist[:, None])
        if window:
            ok = ok & (kp > qpos[:, None] - window)
        m, l, corr, p = _online_update(m, l, s, ok[:, None, None, :])
        v = _meta_decode32(v_data[pg], v_meta[pg], vsc[:, None, None, None])
        acc = acc * corr + torch.einsum("ckgs,cskh->ckgh", p, v)
    kcf = k_chunk.to(torch.float32)
    vcf = v_chunk.to(torch.float32)
    s = torch.einsum("ckgh,jkh->ckgj", qf, kcf) * sm_scale
    ok = (sid[None, :] == sid[:, None]) & qvalid[:, None] \
        & (qpos[None, :] <= qpos[:, None]) & (qpos[None, :] >= qhist[:, None])
    if window:
        ok = ok & (qpos[None, :] > qpos[:, None] - window)
    m, l, corr, p = _online_update(m, l, s, ok[:, None, None, :])
    acc = acc * corr + torch.einsum("ckgj,jkh->ckgh", p, vcf)
    return acc / torch.clamp(l, min=1e-30)


def sparq_chunked_prefill_attn_cuda(q, k_chunk, v_chunk, k_data, k_meta,
                                    k_scale, v_data, v_meta, v_scale,
                                    block_table, seq_id, pos, hist,
                                    tile_seq, *, window: int = 0):
    """Launch K3 on the current stream; arguments as the plain version,
    float tensors f32, index tensors int32."""
    dev = q.device
    C, KV, G, hd = q.shape
    P, ps = k_data.shape[:2]
    S, NB = block_table.shape
    nt = tile_seq.shape[0]
    if C % nt:
        raise ValueError(f"chunk {C} is not a whole number of {nt} tiles")
    bq = C // nt
    _b.check(q, "q", torch.float32, (C, KV, G, hd), dev)
    _b.check(k_chunk, "k_chunk", torch.float32, (C, KV, hd), dev)
    _b.check(v_chunk, "v_chunk", torch.float32, (C, KV, hd), dev)
    for name, t in (("k_data", k_data), ("k_meta", k_meta),
                    ("v_data", v_data), ("v_meta", v_meta)):
        _b.check(t, name, torch.int8, (P, ps, KV, hd), dev)
    _b.check(k_scale, "k_scale", torch.float32, (S,), dev)
    _b.check(v_scale, "v_scale", torch.float32, (S,), dev)
    _b.check(block_table, "block_table", torch.int32, (S, NB), dev)
    for name, t in (("seq_id", seq_id), ("pos", pos), ("hist", hist)):
        _b.check(t, name, torch.int32, (C,), dev)
    _b.check(tile_seq, "tile_seq", torch.int32, (nt,), dev)
    out = torch.empty((C, KV, G, hd), dtype=torch.float32, device=dev)
    KERNEL.launch(
        _b.ptr(q), _b.ptr(k_chunk), _b.ptr(v_chunk), _b.ptr(k_data),
        _b.ptr(k_meta), _b.ptr(k_scale), _b.ptr(v_data), _b.ptr(v_meta),
        _b.ptr(v_scale), _b.ptr(block_table), _b.ptr(seq_id), _b.ptr(pos),
        _b.ptr(hist), _b.ptr(tile_seq), _b.ptr(out), C, KV, G, hd, ps, NB,
        bq, int(window), float(hd ** -0.5), _b.stream_ptr(q))
    return out
