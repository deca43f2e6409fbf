"""Flash-decode attention over the §5.1 packed KV cache — the CUDA kernels'
wrappers and their plain PyTorch versions:

  K2  paged: pages gathered through a block table (port of
      `repro.kernels.sparq_decode_attn.sparq_paged_decode_attn_pallas` and
      of the oracle `repro.kernels.ref.ref_sparq_paged_decode_attn`);
  K5  contiguous: [B, Tk] planes with per-slot positions `kpos` (port of
      `sparq_decode_attn_pallas` and of `ref.ref_sparq_decode_attn`).

Both plain versions run the same per-tile f32 operations (`_online_update`,
the same einsums), so with bk == page_size they agree bit for bit, as the
two kernels do.

Both kernels are one split-key body (`csrc/sparq_decode_common.cuh`):
`split_plan` is the rule by which they cut a slot's keys into splits, one
block per (slot, KV head, split), and the last block of a (slot, head) to
finish combines the splits' partial softmax states in split order."""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.ref import _meta_decode32

# q, k_data, k_meta, k_scale, v_data, v_meta, v_scale, block_table | kpos,
# cur, out, workspace, counters; then the ints; sm_scale; the stream
_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                          ctypes.c_void_p]

KERNEL = _b.CudaKernel(
    "sparq_paged_decode_attn", "sparq_paged_decode_attn.cu",
    "sparq_paged_decode_attn_launch", _ARGTYPES,
    replaces="src/repro/kernels/sparq_decode_attn.py:187")

CONTIG_KERNEL = _b.CudaKernel(
    "sparq_decode_attn", "sparq_decode_attn.cu", "sparq_decode_attn_launch",
    _ARGTYPES, replaces="src/repro/kernels/sparq_decode_attn.py:114")

# keys one split holds at least: a split is max(1, SPLIT_KEYS // tile)
# whole tiles (`SPLIT_KEYS` in csrc/sparq_decode_common.cuh)
SPLIT_KEYS = 32
# threads of one block of the split-key body (`THREADS` there)
THREADS = 128


class SplitGeometry(NamedTuple):
    """How one call cuts its n_keys key positions (K2: NB * ps logical
    keys through the block table; K5: the Tk rows of the planes): split s
    holds the keys [s * keys_per_split, (s + 1) * keys_per_split), in
    tiles_per_split tiles of `tile` keys."""
    tile: int
    tiles_per_split: int
    keys_per_split: int
    n_splits: int


class Split(NamedTuple):
    """One block's share of a slot's keys: blockIdx.z, its key range
    [start, stop), and the tiles in it that hold an unmasked key, in the
    order the block runs them (tile u holds keys [u * tile, (u + 1) *
    tile))."""
    index: int
    keys: Tuple[int, int]
    tiles: Tuple[int, ...]


def split_geometry(n_keys: int, tile: int) -> SplitGeometry:
    """The fixed partition of `n_keys` key positions into splits: it
    depends on the positions and the tile size alone, never on the grid,
    the card or which kernel runs, so K5 at bk = page size and K2 over the
    same bytes cut identically."""
    if tile < 1 or n_keys < 1:
        raise ValueError(f"empty decode: {n_keys} keys, tile {tile}")
    tps = max(1, SPLIT_KEYS // tile)
    kps = tps * tile
    return SplitGeometry(tile, tps, kps, -(-n_keys // kps))


def split_plan(live, tile: int) -> List[List[Split]]:
    """The splits each slot's blocks work on, as the kernels run them.

    `live` [B, n_keys] bool is the plain version's mask per key position
    (`paged_live` / `contig_live`). For each slot: the splits that hold a
    live key, each with the tiles in it that hold one. Every other split's
    block writes the empty partial (m = -inf, l = 0) and a tile without a
    live key is skipped: both are exact, because the online-softmax update
    leaves (m, l, acc) bit for bit unchanged on a fully masked tile."""
    live = np.asarray(live, bool)
    B, n_keys = live.shape
    geo = split_geometry(n_keys, tile)
    n_tiles = geo.n_splits * geo.tiles_per_split
    padded = np.zeros((B, n_tiles * tile), bool)
    padded[:, :n_keys] = live
    tile_live = padded.reshape(B, n_tiles, tile).any(-1)
    plans = []
    for b in range(B):
        splits = []
        for s in range(geo.n_splits):
            u0 = s * geo.tiles_per_split
            tiles = tuple(u for u in range(u0, u0 + geo.tiles_per_split)
                          if tile_live[b, u])
            if tiles:
                splits.append(Split(s, (s * geo.keys_per_split, min(
                    n_keys, (s + 1) * geo.keys_per_split)), tiles))
        plans.append(splits)
    return plans


def paged_live(block_table, cur, ps: int, window: int = 0) -> np.ndarray:
    """K2's mask over logical key positions [B, NB * ps]: the block is
    allocated, kpos <= cur (cur < 0: inactive, nothing live) and, with a
    window, kpos > cur - window."""
    bt, c = np.asarray(block_table), np.asarray(cur).reshape(-1, 1)
    kp = np.arange(bt.shape[1] * ps)[None]
    ok = (bt[:, kp[0] // ps] >= 0) & (kp <= c)
    if window:
        ok &= kp > c - window
    return ok


def contig_live(kpos, cur, window: int = 0) -> np.ndarray:
    """K5's mask over the Tk rows [B, Tk]: kpos >= 0, kpos <= cur and,
    with a window, kpos > cur - window."""
    kp, c = np.asarray(kpos), int(np.asarray(cur).reshape(()))
    ok = (kp >= 0) & (kp <= c)
    if window:
        ok &= kp > c - window
    return ok


def row_stride(hd: int) -> int:
    """Row stride (floats) of the kernels' K and V shared tiles: hd
    rounded up to 4, plus 4 (`row_stride` in the body)."""
    return -(-hd // 4) * 4 + 4


def smem_bytes(G: int, hd: int, tile: int) -> int:
    """Dynamic shared memory of one block of the split-key body, as its
    launcher computes it: per key of a split its row offset (int64), q
    [G][hd] and the split's scores / p [G][keys] in f64 (each count
    rounded up to even), then f32 K and V [keys][row_stride(hd)], the
    correction factors [tiles][G] and the tiles' live flags (int32)."""
    geo = split_geometry(1, tile)
    kps, tps = geo.keys_per_split, geo.tiles_per_split
    gk = G * kps
    return (8 * (kps + kps % 2 + G * hd + gk + gk % 2)
            + 4 * (2 * kps * row_stride(hd) + tps * G) + 4 * tps)


def check_shape(G: int, hd: int, tile: int) -> None:
    """Raise unless one block of the split-key body fits on the card."""
    need = smem_bytes(G, hd, tile)
    if need > _b.SMEM_LIMIT:
        raise ValueError(
            f"split-key decode: G = {G}, hd = {hd} and a tile of {tile} "
            f"keys need {need} bytes of shared memory per block, above "
            f"the card's {_b.SMEM_LIMIT}")


# per (kernel, device): the split partials (f32) and one arrival counter
# per (slot, KV head), allocated once and grown, never shrunk. The last
# block of a (slot, head) resets its counter, so a call is one launch with
# no memset, and the addresses stay fixed from call to call. Calls on one
# stream are ordered; two streams would need a workspace each.
_WORKSPACE: Dict[Tuple[str, torch.device],
                 Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(kernel, dev, n_floats: int, n_counters: int):
    key = (kernel.name, dev)
    ws, cnt = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty((n_floats,), dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros((n_counters,), dtype=torch.int32, device=dev)
    _WORKSPACE[key] = (ws, cnt)
    return ws, cnt


def _vec(*planes) -> int:
    """1 when every plane starts 16-byte aligned: the kernel then reads a
    key's hd bytes as 16-byte vectors (hd % 16 == 0), else byte by byte."""
    return int(all(t.data_ptr() % 16 == 0 for t in planes))


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
    q f32 [B, KV, G, hd], scales f32 [B], block_table/cur int32. One
    launch: a block per (slot, KV head, split of `split_plan`), the last
    of a (slot, head) combining the splits."""
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
    check_shape(G, hd, ps)
    geo = split_geometry(NB * ps, ps)
    ws, cnt = _workspace(KERNEL, dev, B * KV * geo.n_splits * G * (hd + 2),
                         B * KV)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    KERNEL.launch(
        _b.ptr(q), _b.ptr(k_data), _b.ptr(k_meta), _b.ptr(k_scale),
        _b.ptr(v_data), _b.ptr(v_meta), _b.ptr(v_scale), _b.ptr(block_table),
        _b.ptr(cur), _b.ptr(out), _b.ptr(ws), _b.ptr(cnt), B, KV, G, hd, ps,
        NB, int(window), geo.keys_per_split,
        _vec(k_data, k_meta, v_data, v_meta), float(hd ** -0.5),
        _b.stream_ptr(q))
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
    ragged last tile itself: the planes are read in place, never padded.
    One launch, as K2's: the same body over rows b * Tk + key."""
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
    check_shape(G, hd, bk)
    geo = split_geometry(Tk, bk)
    ws, cnt = _workspace(CONTIG_KERNEL, dev,
                         B * KV * geo.n_splits * G * (hd + 2), B * KV)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    CONTIG_KERNEL.launch(
        _b.ptr(q), _b.ptr(k_data), _b.ptr(k_meta), _b.ptr(k_scale),
        _b.ptr(v_data), _b.ptr(v_meta), _b.ptr(v_scale), _b.ptr(kpos),
        _b.ptr(cur), _b.ptr(out), _b.ptr(ws), _b.ptr(cnt), B, KV, G, hd, bk,
        Tk, int(window), geo.keys_per_split,
        _vec(k_data, k_meta, v_data, v_meta), float(hd ** -0.5),
        _b.stream_ptr(q))
    return out
