"""K3: ragged chunked-prefill attention over the §5.1 page pool — the CUDA
kernel's wrapper and its plain PyTorch version (port of
`repro.kernels.sparq_prefill_attn.sparq_chunked_prefill_attn_pallas` and of
the oracle `repro.kernels.ref.ref_sparq_chunked_prefill_attn`), and the
rules the kernel follows: `k3_traits`, the instantiation a call runs (head
dim, key tile, rows a block), and `walk`, the key tiles each query tile
visits."""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import _meta_decode32
from repro_torch.kernels.sparq_decode_attn import NEG_INF, _online_update

# q .. tile_seq, out; C, KV, G, hd, ps, NB, bq, window, hd_pad, groups;
# sm_scale; the stream
_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                           ctypes.c_void_p]

KERNEL = _b.CudaKernel(
    "sparq_chunked_prefill_attn", "sparq_chunked_prefill_attn.cu",
    "sparq_chunked_prefill_attn_launch", _ARGTYPES,
    replaces="src/repro/kernels/sparq_prefill_attn.py:138")

# the kernel's instantiations (`KeyTile` and `K3_INSTANCE` in
# csrc/sparq_chunked_prefill_attn.cu): keys per tile of each head dim, and
# the row groups of 16 query rows a block of that head dim may have
KEY_TILES = {16: 64, 32: 64, 64: 64, 128: 32, 256: 16}
GROUPS = {16: (1, 2, 4), 32: (1, 2, 4), 64: (1, 2, 4), 128: (1, 2, 4),
          256: (1, 2)}
# producer warps of a block (`Traits::PW` there), beside two consumer
# warps per row group
PRODUCER_WARPS = 4


class Traits(NamedTuple):
    """The instantiation one K3 call runs: its head dim (the call's, or the
    next one up, zero-padded), keys per tile (`walk`'s key_tile), query
    rows a block holds (16 per row group), its warps (two per row group
    and the producers), and how many row blocks a query tile's bq * G
    rows are cut into."""
    hd: int
    key_tile: int
    rows: int
    warps: int
    row_blocks: int


def smem_bytes(hd_pad: int, groups: int, C: int = 0, NB: int = 0,
               ps: int = 1) -> int:
    """Dynamic shared memory of one block, as the launcher computes it:
    `Traits::FIXED` (f64 Q, two f64 K/V buffers, P, the consumer warps'
    row statistics) plus the per-call index arrays pg [NB], flag and
    visit [npt + nct] (int32). With the defaults, the fixed part alone."""
    kt = KEY_TILES[hd_pad]
    rows, cw = 16 * groups, 2 * groups
    npt, nct = -(-NB * ps // kt), -(-C // kt)
    return (8 * (rows * (hd_pad + 4) + 4 * kt * (hd_pad + 4)
                 + rows * (kt + 4) + cw * 16) + 4 * cw * 16
            + 4 * (NB + 2 * (npt + nct)))


def k3_traits(hd: int, G: int, bq: int, ps: int) -> Traits:
    """The instantiation a K3 call at head dim hd, G query heads per KV
    head, bq tokens per query tile and page size ps runs: the smallest
    compiled head dim >= hd (any even hd up to 256), its key tile, and the
    fewest row groups that hold bq * G rows (else the most the head dim
    has, the rows then cut into row blocks). Any page size: a key tile
    holds several pages or a slice of one. Raises past what any
    instantiation takes."""
    if hd < 2 or hd % 2 or hd > max(KEY_TILES):
        raise ValueError(f"K3: head dim {hd}; the kernel takes an even head "
                         f"dim up to {max(KEY_TILES)}")
    if G < 1 or bq < 1 or ps < 1:
        raise ValueError(f"K3: G = {G}, bq = {bq}, page size {ps}")
    hd_pad = min(h for h in KEY_TILES if h >= hd)
    R = bq * G
    groups = next((n for n in GROUPS[hd_pad] if 16 * n >= R),
                  max(GROUPS[hd_pad]))
    rows = 16 * groups
    return Traits(hd_pad, KEY_TILES[hd_pad], rows,
                  2 * groups + PRODUCER_WARPS, -(-R // rows))


class Visits(NamedTuple):
    """The key tiles one query tile visits, in the kernel's order: page
    tile u holds the keys at positions [u * key_tile, (u + 1) * key_tile)
    of the sequence's pages, chunk tile u the stream keys [u * key_tile,
    (u + 1) * key_tile) of the chunk."""
    pages: Tuple[int, ...]
    chunk: Tuple[int, ...]


def walk(tile_seq, seq_id, pos, hist, block_table, ps: int,
         key_tile: int, window: int = 0) -> List[Visits]:
    """The key tiles each query tile of K3 visits (one `Visits` per tile).

    Skipping a tile is exact when no (query row, key) pair in it is
    unmasked: the online-softmax update then leaves (m, l, acc) bit for
    bit unchanged. The bounds come from the valid rows (seq_id >= 0) of
    the query tile: lo = max(0, min_pos - window + 1) with a window, else
    0, and hi = max_hist. Key position x lies on page x // ps. A page is
    live when its block-table entry is >= 0 and its keys meet [lo, hi); a
    page tile is visited when it holds a key of a live page inside [lo,
    hi) (with ps <= key_tile, when it holds a live page; with ps >
    key_tile a live page's tiles outside [lo, hi) are not visited). The
    kernel zero-fills the pages of a visited tile that are not live. A
    chunk tile is visited when it holds a key of the tile's sequence with
    max(min_hist, lo) <= kpos <= max_pos. Padding tiles (tile_seq < 0) and
    tiles without a valid row visit nothing. Nothing here depends on how
    the runs were packed; each valid row of a query tile is taken to
    belong to the tile's sequence, as the stream layout of
    `launch/prefill.py` has it."""
    tile_seq, seq_id, pos, hist, block_table = (
        np.asarray(a) for a in (tile_seq, seq_id, pos, hist, block_table))
    if ps < 1 or key_tile < 1:
        raise ValueError(f"page size {ps}, key tile {key_tile}")
    nt, C = len(tile_seq), len(seq_id)
    bq = C // nt
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
        pages = set()
        for tp in t[live].tolist():
            first = max(tp * ps, lo) // key_tile
            last = (min((tp + 1) * ps, hi) - 1) // key_tile
            pages.update(range(first, last + 1))
        lo_c = max(int(qhist.min()), lo)
        keys = (seq_id == ts) & (pos >= lo_c) & (pos <= int(qpos.max()))
        visits.append(Visits(
            tuple(sorted(pages)),
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
    float tensors f32, index tensors int32. The instantiation is
    `k3_traits`'. A float or int8
    tensor that does not start 16-byte aligned is handed to the kernel as
    an aligned copy (its 16-byte loads need aligned rows)."""
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
    tr = k3_traits(hd, G, bq, ps)
    groups = tr.rows // 16
    smem = smem_bytes(tr.hd, groups, C, NB, ps)
    if smem > _b.SMEM_LIMIT:
        raise ValueError(
            f"K3: a block-table row of {NB} pages of {ps} and a chunk of "
            f"{C} need {smem} bytes of shared memory per block, above the "
            f"card's {_b.SMEM_LIMIT}")
    q, k_chunk, v_chunk, k_data, k_meta, v_data, v_meta = (
        t if t.data_ptr() % 16 == 0 else t.clone() for t in (
            q, k_chunk, v_chunk, k_data, k_meta, v_data, v_meta))
    out = torch.empty((C, KV, G, hd), dtype=torch.float32, device=dev)
    KERNEL.launch(
        _b.ptr(q), _b.ptr(k_chunk), _b.ptr(v_chunk), _b.ptr(k_data),
        _b.ptr(k_meta), _b.ptr(k_scale), _b.ptr(v_data), _b.ptr(v_meta),
        _b.ptr(v_scale), _b.ptr(block_table), _b.ptr(seq_id), _b.ptr(pos),
        _b.ptr(hist), _b.ptr(tile_seq), _b.ptr(out), C, KV, G, hd, ps, NB,
        bq, int(window), tr.hd, groups, float(hd ** -0.5), _b.stream_ptr(q))
    return out
