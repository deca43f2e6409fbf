"""K4: SPARQ quantization of the KV write path, fused with the write — the
CUDA kernel's wrappers beside their plain PyTorch versions (port of
`repro.kernels.sparq_quant.sparq_quant_pallas` and of the oracle
`repro.kernels.ref.ref_sparq_quant`, and of the writes around them in
`repro.models.paging.PagedCacheStore.update` / `write_chunk` and
`repro.models.cache.CacheStore.update`).

One kernel, `csrc/sparq_quant.cu`, launched in one of four ways:

  rows        `sparq_quant_cuda`: (codes, meta) = quant(x / a), the Pallas
              contract; `codes` are the reconstructed int8 values (window
              << shift, sign applied), `meta` the per-pair byte
              mux_any*64 + shift_even*8 + shift_odd on both lanes.
  paged       `kv_write_paged_cuda`: a paged decode update, K and V, one
              launch.
  chunk       `kv_write_chunk_cuda`: a paged prefill chunk, a scale pass
              and a write pass.
  contiguous  `kv_write_contiguous_cuda`: both planes of a contiguous
              cache append, one launch at T = 1, else a scale pass and a
              write pass.

The write modes quantize, pack to the stored form (`ref.sparq_pack`),
scatter into the pools or planes in place, and return the new scales and
positions as fresh tensors. Their plain versions (`ref_kv_write_*`) are the
port's former composite writes, op for op, so the CPU results are the
JAX package's. Everything after the one IEEE f32 division is integer
arithmetic, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantizer import div_qmax
from repro_torch.kernels import build as _b
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import ref_sparq_quant  # noqa: F401 (plain)

# modes of sparq_quant_launch (csrc/sparq_quant.cu)
ROWS, PAGED, CHUNK_SCALE, CHUNK_WRITE, CONTIG_ONE, CONTIG_SCALE, \
    CONTIG_WRITE = range(7)
# slots a chunk write may cover (the write pass's shared-memory scales)
MAX_SLOTS = 4096

KERNEL = _b.CudaKernel(
    "sparq_quant", "sparq_quant.cu", "sparq_quant_launch",
    [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 16 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sparq_quant.py:79")

X_DTYPES = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------------------
# plain versions of the writes
# ----------------------------------------------------------------------

def _stored_form(x, scale, codec):
    """float -> (§5.1 window codes, meta bytes), int8, with a scale that
    broadcasts against x."""
    codes, meta = _ref.ref_sparq_quant(x.to(torch.float32), scale, **codec)
    return _ref.sparq_pack(codes, meta), meta


def _scatter(pools, page, off, planes) -> None:
    page, off = page.long(), off.long()
    for pool, plane in zip(pools, planes):
        pool[page, off] = plane


def ref_kv_write_paged(k_new, v_new, k_data, k_meta, v_data, v_meta,
                       k_scale, v_scale, block_table, seq_pos, **codec):
    """Plain paged decode update: k_new/v_new float [S, 1, KV, hd]; slot s
    writes at page block_table[s, pos // ps], row pos % ps (inactive slots,
    pos < 0, and unallocated blocks to the trash page, the pools' last).
    A slot's scale is frozen once calibrated (> 0), else this write's
    range. Writes the pools in place; returns the new (k_scale, v_scale,
    seq_pos)."""
    S = k_new.shape[0]
    ps = k_data.shape[1]
    trash = k_data.shape[0] - 1
    pos = seq_pos
    active = pos >= 0
    eff = torch.clamp(pos, min=0)
    blk = torch.clamp(eff // ps, max=block_table.shape[1] - 1)
    page = block_table[torch.arange(S, device=pos.device), blk.long()]
    page = torch.where(active & (page >= 0), page,
                       torch.full_like(page, trash))
    scales = []
    for stored, x in ((k_scale, k_new), (v_scale, v_new)):
        dyn = div_qmax(torch.clamp(torch.amax(torch.abs(
            x.to(torch.float32)), dim=(1, 2, 3)), min=1e-8),
            codec["max_val"])
        scales.append(torch.where(stored > 0, stored, dyn))
    kd, km = _stored_form(k_new[:, 0], scales[0][:, None, None], codec)
    vd, vm = _stored_form(v_new[:, 0], scales[1][:, None, None], codec)
    _scatter((k_data, k_meta, v_data, v_meta), page, eff % ps,
             (kd, km, vd, vm))
    return (torch.where(active, scales[0], k_scale),
            torch.where(active, scales[1], v_scale),
            torch.where(active, pos + 1, pos))


def _chunk_scale(stored, x, s_safe, first_seg, max_val):
    """Per-slot scale of a chunk write: frozen once calibrated, else the
    range of the slot's first-segment tokens (hist == 0) only, so the
    frozen scale depends on (prompt, seg) alone; unchanged for a slot with
    no such token."""
    tok_max = torch.amax(torch.abs(x.to(torch.float32)), dim=(1, 2))
    tok_max = torch.where(first_seg, tok_max, torch.zeros_like(tok_max))
    S = stored.shape[0]
    seq_max = torch.zeros((S,), dtype=torch.float32,
                          device=x.device).scatter_reduce(
        0, s_safe, tok_max, "amax")
    dyn = div_qmax(torch.clamp(seq_max, min=1e-8), max_val)
    has = torch.zeros((S,), dtype=torch.int32,
                      device=x.device).scatter_reduce(
        0, s_safe, first_seg.to(torch.int32), "amax") > 0
    return torch.where(stored > 0, stored, torch.where(has, dyn, stored))


def ref_kv_write_chunk(k_new, v_new, k_data, k_meta, v_data, v_meta,
                       k_scale, v_scale, block_table, seq_id, pos, hist,
                       seq_pos_after, **codec):
    """Plain chunk write: k_new/v_new float [C, KV, hd] in stream order;
    token i lands at page block_table[seq_id[i], pos[i] // ps], row
    pos[i] % ps, quantized with its slot's scale (`_chunk_scale`); padding
    (seq_id < 0) and unallocated blocks to the trash page. Writes the
    pools in place; returns the new (k_scale, v_scale, seq_pos), seq_pos =
    seq_pos_after."""
    ps = k_data.shape[1]
    trash = k_data.shape[0] - 1
    valid = seq_id >= 0
    s_safe = torch.clamp(seq_id, min=0).long()
    first_seg = valid & (hist == 0)
    mv = codec["max_val"]
    k_sc = _chunk_scale(k_scale, k_new, s_safe, first_seg, mv)
    v_sc = _chunk_scale(v_scale, v_new, s_safe, first_seg, mv)
    kd, km = _stored_form(k_new, k_sc[s_safe][:, None, None], codec)
    vd, vm = _stored_form(v_new, v_sc[s_safe][:, None, None], codec)
    eff = torch.clamp(pos, min=0)
    blk = torch.clamp(eff // ps, max=block_table.shape[1] - 1)
    page = block_table[s_safe, blk.long()]
    page = torch.where(valid & (page >= 0), page,
                       torch.full_like(page, trash))
    _scatter((k_data, k_meta, v_data, v_meta), page, eff % ps,
             (kd, km, vd, vm))
    return k_sc, v_sc, seq_pos_after.to(torch.int32).clone()


def ref_kv_write_contiguous(k_new, v_new, k_data, k_meta, v_data, v_meta,
                            k_scale, v_scale, pos, **codec):
    """Plain contiguous append: k_new/v_new float [B, T, KV, hd] at time
    offset pos (int32 0-d), the start clamped so the slab fits (the
    reference's dynamic_update_slice); one scale a plane, frozen once
    calibrated, else the slab's range. Writes the planes in place; returns
    the new (k_scale, v_scale, pos + T)."""
    T_new = k_new.shape[1]
    start = torch.clamp(pos.to(torch.int64), max=k_data.shape[1] - T_new)
    idx = start + torch.arange(T_new, device=k_data.device)
    scales = []
    for x, data, meta, stored in ((k_new, k_data, k_meta, k_scale),
                                  (v_new, v_data, v_meta, v_scale)):
        dyn = div_qmax(torch.clamp(torch.amax(torch.abs(
            x.to(torch.float32))), min=1e-8), codec["max_val"])
        scale = torch.where(stored > 0, stored, dyn)
        st, mt = _stored_form(x, scale, codec)
        data.index_copy_(1, idx, st)
        meta.index_copy_(1, idx, mt)
        scales.append(scale)
    return scales[0], scales[1], pos + T_new


# ----------------------------------------------------------------------
# the kernel's wrappers
# ----------------------------------------------------------------------

def _codec_args(bits=4, opts_shifts=(0, 1, 2, 3, 4), rounding=True,
                vsparq=True, signed=True, max_val=127, enabled=True):
    return (bits, sum(1 << s for s in opts_shifts), max(opts_shifts),
            int(rounding), int(vsparq), int(signed), max_val, int(enabled))


def _launch(mode, codec, x, rows, n, *, v=None, k_scale=None, v_scale=None,
            per_row=0, scale_out=None, maxima=None, block_table=None,
            pos=None, pos_out=None, seq_id=None, hist=None, pos_after=None,
            k_data=None, k_meta=None, v_data=None, v_meta=None, n_slots=0,
            T=1, Tmax=0, ps=1, NB=1, trash=0):
    p = _b.ptr
    KERNEL.launch(
        mode, p(x), p(v), int(x.dtype == torch.bfloat16), p(k_scale),
        p(v_scale), per_row, p(scale_out), p(maxima), p(block_table), p(pos),
        p(pos_out), p(seq_id), p(hist), p(pos_after), p(k_data), p(k_meta),
        p(v_data), p(v_meta), rows, n, n_slots, T, Tmax, ps, NB, trash,
        *_codec_args(**codec), _b.stream_ptr(x))


def _check_kv(k_new, v_new, shape, dev):
    if k_new.dtype not in X_DTYPES:
        raise ValueError(f"K/V dtype {k_new.dtype}: the kernel reads "
                         f"float32 or bfloat16")
    if shape[-1] % 2:
        raise ValueError(f"vSPARQ pairs adjacent lanes; hd={shape[-1]} is "
                         f"odd")
    _b.check(k_new, "k_new", k_new.dtype, shape, dev)
    _b.check(v_new, "v_new", k_new.dtype, shape, dev)
    _check_pair_aligned(k_new, "k_new")
    _check_pair_aligned(v_new, "v_new")


def _check_pools(planes, shape, dev):
    for name, t in zip(("k_data", "k_meta", "v_data", "v_meta"), planes):
        _b.check(t, name, torch.int8, shape, dev)
        _check_pair_aligned(t, name)


def _check_pair_aligned(t, name):
    """The kernel moves a lane pair at least at a time."""
    if t.data_ptr() % (2 * t.element_size()):
        raise ValueError(f"{name}: not aligned to a lane pair")


def sparq_quant_cuda(x, scale, **codec):
    """Rows mode on the current stream. x (M, K) f32 with K even; scale
    f32 (1,) (one step for every row) or (M,) (one per row). Returns
    (codes, meta), int8 (M, K)."""
    dev = x.device
    M, K = x.shape
    if K % 2:
        raise ValueError(f"vSPARQ pairs adjacent lanes; K={K} is odd")
    _b.check(x, "x", torch.float32, (M, K), dev)
    if x.data_ptr() % 8:
        x = x.clone()             # the kernel reads lane pairs as float2
    per_row = scale.numel() != 1
    _b.check(scale, "scale", torch.float32, (M,) if per_row else (1,), dev)
    codes = torch.empty((M, K), dtype=torch.int8, device=dev)
    meta = torch.empty((M, K), dtype=torch.int8, device=dev)
    _launch(ROWS, codec, x, M, K, k_scale=scale, per_row=int(per_row),
            k_data=codes, k_meta=meta)
    return codes, meta


def kv_write_paged_cuda(k_new, v_new, k_data, k_meta, v_data, v_meta,
                        k_scale, v_scale, block_table, seq_pos, **codec):
    """Paged decode update in one launch (contract of
    `ref_kv_write_paged`). k_new/v_new f32 or bf16 [S, 1, KV, hd]; pools
    int8 [P + 1, ps, KV, hd] (the last is the trash page); scales f32 [S];
    block_table int32 [S, NB]; seq_pos int32 [S]."""
    dev = k_new.device
    S, T, KV, hd = k_new.shape
    if T != 1:
        raise ValueError(f"a paged decode writes one token a slot, got {T}")
    _check_kv(k_new, v_new, (S, 1, KV, hd), dev)
    P, ps = k_data.shape[:2]
    _check_pools((k_data, k_meta, v_data, v_meta), (P, ps, KV, hd), dev)
    NB = block_table.shape[-1]
    _b.check(block_table, "block_table", torch.int32, (S, NB), dev)
    _b.check(seq_pos, "seq_pos", torch.int32, (S,), dev)
    _b.check(k_scale, "k_scale", torch.float32, (S,), dev)
    _b.check(v_scale, "v_scale", torch.float32, (S,), dev)
    scale_out = torch.empty((2, S), dtype=torch.float32, device=dev)
    pos_out = torch.empty((S,), dtype=torch.int32, device=dev)
    _launch(PAGED, codec, k_new, S, KV * hd, v=v_new, k_scale=k_scale,
            v_scale=v_scale, scale_out=scale_out, block_table=block_table,
            pos=seq_pos, pos_out=pos_out, k_data=k_data, k_meta=k_meta,
            v_data=v_data, v_meta=v_meta, n_slots=S, ps=ps, NB=NB,
            trash=P - 1)
    return scale_out[0], scale_out[1], pos_out


def kv_write_chunk_cuda(k_new, v_new, k_data, k_meta, v_data, v_meta,
                        k_scale, v_scale, block_table, seq_id, pos, hist,
                        seq_pos_after, **codec):
    """Chunk write in two launches, a scale pass and a write pass
    (contract of `ref_kv_write_chunk`). k_new/v_new f32 or bf16 [C, KV,
    hd]; seq_id/pos/hist int32 [C]; seq_pos_after int32 [S]; the rest as
    `kv_write_paged_cuda`."""
    dev = k_new.device
    C, KV, hd = k_new.shape
    _check_kv(k_new, v_new, (C, KV, hd), dev)
    P, ps = k_data.shape[:2]
    _check_pools((k_data, k_meta, v_data, v_meta), (P, ps, KV, hd), dev)
    S, NB = block_table.shape
    if S > MAX_SLOTS:
        raise ValueError(f"{S} slots: the chunk write takes at most "
                         f"{MAX_SLOTS}")
    _b.check(block_table, "block_table", torch.int32, (S, NB), dev)
    for name, t in (("seq_id", seq_id), ("pos", pos), ("hist", hist)):
        _b.check(t, name, torch.int32, (C,), dev)
    _b.check(seq_pos_after, "seq_pos_after", torch.int32, (S,), dev)
    _b.check(k_scale, "k_scale", torch.float32, (S,), dev)
    _b.check(v_scale, "v_scale", torch.float32, (S,), dev)
    maxima = torch.empty((2, C), dtype=torch.int32, device=dev)
    scale_out = torch.empty((2, S), dtype=torch.float32, device=dev)
    pos_out = torch.empty((S,), dtype=torch.int32, device=dev)
    args = dict(v=v_new, k_scale=k_scale, v_scale=v_scale,
                scale_out=scale_out, maxima=maxima, block_table=block_table,
                pos=pos, pos_out=pos_out, seq_id=seq_id, hist=hist,
                pos_after=seq_pos_after, k_data=k_data, k_meta=k_meta,
                v_data=v_data, v_meta=v_meta, n_slots=S, ps=ps, NB=NB,
                trash=P - 1)
    _launch(CHUNK_SCALE, codec, k_new, C, KV * hd, **args)
    _launch(CHUNK_WRITE, codec, k_new, C, KV * hd, **args)
    return scale_out[0], scale_out[1], pos_out


def kv_write_contiguous_cuda(k_new, v_new, k_data, k_meta, v_data, v_meta,
                             k_scale, v_scale, pos, **codec):
    """Both planes of a contiguous append (contract of
    `ref_kv_write_contiguous`): one launch at T = 1, else a scale pass and
    a write pass. k_new/v_new f32 or bf16 [B, T, KV, hd]; planes int8 [B,
    Tmax, KV, hd]; scales f32 and pos int32, 0-d."""
    dev = k_new.device
    B, T, KV, hd = k_new.shape
    _check_kv(k_new, v_new, (B, T, KV, hd), dev)
    Tmax = k_data.shape[1]
    if T > Tmax:
        raise ValueError(f"a slab of {T} tokens exceeds the cache's {Tmax}")
    _check_pools((k_data, k_meta, v_data, v_meta), (B, Tmax, KV, hd), dev)
    _b.check(k_scale, "k_scale", torch.float32, (), dev)
    _b.check(v_scale, "v_scale", torch.float32, (), dev)
    _b.check(pos, "pos", torch.int32, (), dev)
    scale_out = torch.empty((2,), dtype=torch.float32, device=dev)
    pos_out = torch.empty((), dtype=torch.int32, device=dev)
    args = dict(v=v_new, k_scale=k_scale, v_scale=v_scale,
                scale_out=scale_out, pos=pos, pos_out=pos_out, k_data=k_data,
                k_meta=k_meta, v_data=v_data, v_meta=v_meta, T=T, Tmax=Tmax)
    if T == 1:
        _launch(CONTIG_ONE, codec, k_new, B, KV * hd, **args)
    else:
        args["maxima"] = torch.empty((2, B * T), dtype=torch.int32,
                                     device=dev)
        _launch(CONTIG_SCALE, codec, k_new, B * T, KV * hd, **args)
        _launch(CONTIG_WRITE, codec, k_new, B * T, KV * hd, **args)
    return scale_out[0], scale_out[1], pos_out
