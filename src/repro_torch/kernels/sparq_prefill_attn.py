"""K3: ragged chunked-prefill attention over the §5.1 page pool — the CUDA
kernels' wrappers and their plain PyTorch version (port of
`repro.kernels.sparq_prefill_attn.sparq_chunked_prefill_attn_pallas` and of
the oracle `repro.kernels.ref.ref_sparq_chunked_prefill_attn`), `walk`,
the rule by which the tensor-core kernel skips key tiles, and `k3_path`,
the rule by which a call takes that kernel or the general loop kernel."""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import _meta_decode32
from repro_torch.kernels.sparq_decode_attn import NEG_INF, _online_update

_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                          ctypes.c_void_p]

# K3's two hand-written paths; `k3_path` picks one per call
KERNEL = _b.CudaKernel(
    "sparq_chunked_prefill_attn", "sparq_chunked_prefill_attn.cu",
    "sparq_chunked_prefill_attn_launch", _ARGTYPES,
    replaces="src/repro/kernels/sparq_prefill_attn.py:138")
LOOP_KERNEL = _b.CudaKernel(
    "sparq_chunked_prefill_attn_loop", "sparq_chunked_prefill_attn_loop.cu",
    "sparq_chunked_prefill_attn_loop_launch", _ARGTYPES,
    replaces="src/repro/kernels/sparq_prefill_attn.py:138")

# keys per tile of the tensor-core kernel, in the page stage and the chunk
# stage alike (`KT` in csrc/sparq_chunked_prefill_attn.cu)
KEY_TILE = 64
# the shapes the tensor-core kernel takes: its head dim, and the most query
# rows (bq * G) one block holds
KERNEL_HD = 64
KERNEL_ROWS = 64
# the loop kernel's chunk-stage key tile (`KT` in
# csrc/sparq_chunked_prefill_attn_loop.cu)
LOOP_KEY_TILE = 16


def loop_smem_bytes(hd: int, G: int, bq: int, ps: int) -> int:
    """Dynamic shared memory of one block of the loop kernel, as its
    launcher computes it: q and acc [bq * G][hd], the decoded K and V tile
    [max(ps, 16)][hd + 1], the scores [bq * G][max(ps, 16)], the row
    statistics, and the query tile's positions and the chunk tile's keys
    (int32)."""
    R, T = bq * G, max(ps, LOOP_KEY_TILE)
    return (4 * (2 * R * hd + 2 * T * (hd + 1) + R * T + 3 * R)
            + 4 * (3 * bq + 2 * LOOP_KEY_TILE))


def k3_path(hd: int, G: int, bq: int, ps: int, aligned: bool) -> str:
    """Which hand-written kernel runs one K3 call: "dmma" (the f64
    tensor-core kernel) exactly when it takes the shape — hd 64, at most
    64 query rows (bq * G) per tile, a page size dividing its 64-key tile
    and every tensor 16-byte aligned — else "loop" (the general kernel).
    Raises only where the loop kernel's block does not fit in shared
    memory."""
    if (hd == KERNEL_HD and bq * G <= KERNEL_ROWS and 0 < ps <= KEY_TILE
            and KEY_TILE % ps == 0 and aligned):
        return "dmma"
    need = loop_smem_bytes(hd, G, bq, ps)
    if need > _b.SMEM_LIMIT:
        raise ValueError(
            f"K3: hd = {hd}, bq * G = {bq * G} and page size {ps} need "
            f"{need} bytes of shared memory per block on the loop path, "
            f"above the card's {_b.SMEM_LIMIT}")
    return "loop"


class Visits(NamedTuple):
    """The key tiles one query tile visits, in the kernel's order: page
    tile u holds the keys at positions [u * key_tile, (u + 1) * key_tile)
    of the sequence's pages, chunk tile u the stream keys [u * key_tile,
    (u + 1) * key_tile) of the chunk."""
    pages: Tuple[int, ...]
    chunk: Tuple[int, ...]


def walk(tile_seq, seq_id, pos, hist, block_table, ps: int,
         key_tile: int = KEY_TILE, window: int = 0) -> List[Visits]:
    """The key tiles each query tile of K3 visits (one `Visits` per tile).

    Skipping a tile is exact when no (query row, key) pair in it is
    unmasked: the online-softmax update then leaves (m, l, acc) bit for
    bit unchanged. The bounds come from the valid rows (seq_id >= 0) of
    the query tile: lo = max(0, min_pos - window + 1) with a window, else
    0. A page is live when its block-table entry is >= 0 and its keys
    meet [lo, max_hist); a page tile is visited when it holds a live page
    (the kernel zero-fills the others in it). A chunk tile is visited when
    it holds a key of the tile's sequence with max(min_hist, lo) <= kpos
    <= max_pos. Padding tiles (tile_seq < 0) and tiles without a valid row
    visit nothing. Nothing here depends on how the runs were packed; each
    valid row of a query tile is taken to belong to the tile's sequence,
    as the stream layout of `launch/prefill.py` has it."""
    tile_seq, seq_id, pos, hist, block_table = (
        np.asarray(a) for a in (tile_seq, seq_id, pos, hist, block_table))
    if key_tile % ps:
        raise ValueError(f"page size {ps} does not divide the key tile "
                         f"{key_tile}")
    nt, C = len(tile_seq), len(seq_id)
    bq = C // nt
    ppt = key_tile // ps
    NB = block_table.shape[1]
    visits = []
    for qt, ts in enumerate(tile_seq.tolist()):
        rows = slice(qt * bq, (qt + 1) * bq)
        ok = seq_id[rows] >= 0
        if ts < 0 or not ok.any():
            visits.append(Visits((), ()))
            continue
        qpos, qhist = pos[rows][ok], hist[rows][ok]
        lo = max(0, int(qpos.min()) - window + 1) if window else 0
        hi = int(qhist.max())
        t = np.arange(NB)
        live = (block_table[ts] >= 0) & (t * ps < hi) & ((t + 1) * ps > lo)
        lo_c = max(int(qhist.min()), lo)
        keys = (seq_id == ts) & (pos >= lo_c) & (pos <= int(qpos.max()))
        visits.append(Visits(
            tuple(sorted(set((t[live] // ppt).tolist()))),
            tuple(sorted(set((np.nonzero(keys)[0] // key_tile).tolist())))))
    return visits


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
    float tensors f32, index tensors int32. `k3_path` picks the kernel:
    the tensor-core one where it takes the shape, else the loop one."""
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (
        q, k_chunk, v_chunk, k_data, k_meta, v_data, v_meta))
    kernel = KERNEL if k3_path(hd, G, bq, ps, aligned) == "dmma" \
        else LOOP_KERNEL
    out = torch.empty((C, KV, G, hd), dtype=torch.float32, device=dev)
    kernel.launch(
        _b.ptr(q), _b.ptr(k_chunk), _b.ptr(v_chunk), _b.ptr(k_data),
        _b.ptr(k_meta), _b.ptr(k_scale), _b.ptr(v_data), _b.ptr(v_meta),
        _b.ptr(v_scale), _b.ptr(block_table), _b.ptr(seq_id), _b.ptr(pos),
        _b.ptr(hist), _b.ptr(tile_seq), _b.ptr(out), C, KV, G, hd, ps, NB,
        bq, int(window), float(hd ** -0.5), _b.stream_ptr(q))
    return out
