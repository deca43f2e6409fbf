"""Public entry points of the SPARQ kernels (port of `repro.kernels.ops`).

Dispatch goes by the device of the tensors: CPU tensors take the plain
PyTorch versions, CUDA tensors take the hand-written kernels, any other
device raises. There is no switch that could route a CUDA tensor to a
plain version: on the card, the main path always runs the kernels.

Tensor parallelism (`mesh`, a `launch.mesh.TPMesh` of tp > 1): the three
attention dispatchers run once per shard, each over the KV heads its
planes hold (GQA heads are KV-major, so a shard's query heads are one
contiguous run of whole head groups), with the unchanged single-device
kernel on the shard's device; the outputs are concatenated on the lead
device in head order. Per-head flash accumulation never crosses heads, so
each shard's output is the same head slice of the TP 1 output, bit for
bit, and the concatenation is data movement only. The KV writes take the
shard's first head (`head0`) instead: see `kernels.sparq_quant`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizer import QScale
from repro_torch.core.sparq import SparqConfig
from repro_torch.distributed.sharding import shard_heads
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sparq_decode_attn as _dec
from repro_torch.kernels import sparq_dequant as _dq
from repro_torch.kernels import sparq_matmul as _mm
from repro_torch.kernels import sparq_mla_decode as _mla
from repro_torch.kernels import sparq_prefill_attn as _pre
from repro_torch.kernels import sparq_quant as _q

# default Tk-tile size of the contiguous decode-attention kernel (K5);
# CacheConfig.attn_bk overrides it per cache
DEFAULT_BK = 128

# ----------------------------------------------------------------------
# repro_torch.analysis registration (as the reference's): which code may
# turn packed §5.1 planes back into floats, which dispatchers the program
# audit runs as programs of their own, and the hook through which it
# reads the launches a program asks of the kernels.
# ----------------------------------------------------------------------

#: source-path fragments whose integer -> float conversions are the
#: blessed meta-decode (analysis check JX102): the kernels' wrappers decode
#: tile by tile in their loops, and their plain versions are the kernels'
#: counterparts op for op. A float of a packed plane made anywhere else is
#: a whole-plane dequantize, which the format exists to avoid.
META_DECODE_SOURCES = ("repro_torch/kernels/",)

#: public dispatchers the analysis registry runs as programs of their own,
#: on packed planes shaped like the engines'
HOT_DISPATCHERS = (
    "quantized_matmul",
    "sparq_quantize",
    "sparq_dequantize",
    "sparq_decode_attention",
    "sparq_chunked_prefill_attention",
    "sparq_paged_decode_attention",
)

#: set by `analysis.program_audit` while it records a program, None
#: otherwise. Every dispatcher, on either route, calls it as
#: AUDIT_HOOK(kernel, **geometry) with the shapes and static arguments
#: from which its kernel's launch plan is computed; it changes no route.
AUDIT_HOOK = None


def _route(t: torch.Tensor) -> str:
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no SPARQ kernel for device {t.device}")


# ----------------------------------------------------------------------
# tensor parallelism: one launch a shard, over its own KV heads
# ----------------------------------------------------------------------

def tp_size(mesh) -> int:
    """Tensor-parallel degree of `mesh` (a TPMesh; None = 1, no TP)."""
    return 1 if mesh is None else mesh.tp


def _tp_guard(kv_heads: int, tp: int) -> None:
    """Raise unless `tp` splits the KV heads into whole head groups."""
    shard_heads(kv_heads, tp, 0)


def _per_shard(mesh, q, axis: int, k_data, run) -> torch.Tensor:
    """`run(r, h0, h1, q_r)` for every shard r of `mesh`, where k_data[r]
    holds KV heads [h0, h1) and q_r is q's query heads of those groups
    (axis `axis`) on the shard's device; the outputs concatenated on the
    lead device in head order."""
    tp = mesh.tp
    kv = k_data[0].shape[2] * tp
    _tp_guard(kv, tp)
    G = q.shape[axis] // kv
    outs = []
    for r, dev in enumerate(mesh.devices):
        h0, h1 = shard_heads(kv, tp, r)
        q_r = q.narrow(axis, h0 * G, (h1 - h0) * G).to(dev)
        outs.append(run(r, h0, h1, q_r).to(mesh.lead))
    return torch.cat(outs, axis)


# ----------------------------------------------------------------------
# §5.1 footprint accounting (single source of truth, as in the reference)
# ----------------------------------------------------------------------

def data_bytes_per_value(cfg: SparqConfig) -> float:
    """Data plane: n data bits per value + 1 MuxCtrl bit per vSPARQ pair;
    plain int8 (trimming disabled) is one full byte."""
    if not cfg.enabled:
        return 1.0
    mux = 0.5 if cfg.vsparq else 0.0
    return (cfg.bits + mux) / 8.0


def ctrl_bytes_per_value(cfg: SparqConfig) -> float:
    """ShiftCtrl side-band: 3 bits per value when trimming."""
    return 3.0 / 8.0 if cfg.enabled else 0.0


def bytes_per_value(cfg: SparqConfig) -> float:
    """Combined modeled residency of the packed SPARQ format (§5.1)."""
    return data_bytes_per_value(cfg) + ctrl_bytes_per_value(cfg)


def _codec_kw(cfg: SparqConfig) -> dict:
    return dict(bits=cfg.bits, opts_shifts=cfg.shifts, rounding=cfg.rounding,
                vsparq=cfg.vsparq, signed=cfg.signed, max_val=cfg.max_val,
                enabled=cfg.enabled)


def quantized_matmul(x: torch.Tensor, w_codes: torch.Tensor, act_qs: QScale,
                     chan_scale: torch.Tensor,
                     cfg: SparqConfig) -> torch.Tensor:
    """SPARQ-quantized x @ dequant(w), f32 out; leading dims of x flatten.

    K must be even (vSPARQ pairs adjacent lanes). The kernel masks its
    ragged tile edges itself, which is the same as zero-padding K in whole
    pairs: a padded pair is all zeros and changes no vSPARQ decision."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w_codes.shape[1]
    if K % 2:
        raise ValueError("vSPARQ pairs adjacent K lanes; K must be even")
    x2 = x.reshape(-1, K)
    a = torch.as_tensor(act_qs.scale, dtype=torch.float32, device=x.device)
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_matmul", M=x2.shape[0], N=N, K=K, device=x.device)
    if _route(x) == "plain":
        out = _mm.ref_sparq_matmul(x2, w_codes, a, chan_scale,
                                   **_codec_kw(cfg))
    else:
        out = _mm.sparq_matmul_cuda(
            x2.contiguous(), w_codes.contiguous(), a.reshape(1),
            chan_scale.to(torch.float32).contiguous(), **_codec_kw(cfg))
    return out.reshape(*lead, N)


def sparq_quantize(x: torch.Tensor, scale: torch.Tensor,
                   cfg: SparqConfig):
    """SPARQ quantization, K4's rows mode (the Pallas contract): float
    (..., K) -> (codes, meta), int8 with x's shape; the last axis is the
    vSPARQ pair axis (K even). `scale` is the f32 quantization step on x's
    device: one element for every row, or one per row of the flattened
    leading dims. `codes` are the reconstructed values (window << shift,
    sign applied); `sparq_pack` shifts them down to the stored form. The
    KV writes do not come here: they take `kv_write_*`, which quantize,
    pack and scatter in one pass."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K).to(torch.float32)
    M = x2.shape[0]
    sc = scale.to(torch.float32).reshape(-1)
    if sc.numel() not in (1, M):
        raise ValueError(f"scale has {sc.numel()} elements; expected 1 or "
                         f"one per row ({M})")
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_quant", mode="rows", widths=(K,), lane0=0)
    if _route(x) == "plain":
        a = sc.reshape(()) if sc.numel() == 1 else sc[:, None]
        codes, meta = _q.ref_sparq_quant(x2, a, **_codec_kw(cfg))
    else:
        codes, meta = _q.sparq_quant_cuda(x2.contiguous(), sc.contiguous(),
                                          **_codec_kw(cfg))
    return codes.reshape(*lead, K), meta.reshape(*lead, K)


sparq_pack = _ref.sparq_pack


def _kv(x: torch.Tensor) -> torch.Tensor:
    """K/V as K4's write modes read them: float32 or bfloat16, contiguous
    (no copy for the model's own activations)."""
    if x.dtype not in _q.X_DTYPES:
        x = x.to(torch.float32)
    return x.contiguous()


def kv_write_paged(k_new, v_new, k_data, k_meta, v_data, v_meta, k_scale,
                   v_scale, block_table, seq_pos, cfg: SparqConfig,
                   head0: int = 0):
    """A paged decode update (`models.paging.PagedCacheStore.update`):
    float [S, 1, KV, hd] K/V, one token a slot, quantized and written into
    the pools in place (a head shard's pools: heads [head0, head0 +
    KV_local), under the scale of every head). Returns the new (k_scale,
    v_scale, seq_pos). One K4 launch on the card."""
    args = (k_data, k_meta, v_data, v_meta, k_scale, v_scale, block_table,
            seq_pos)
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_quant", mode="paged",
                   widths=(k_new.shape[-1], v_new.shape[-1]),
                   lane0=head0 * k_new.shape[-1])
    if _route(k_new) == "plain":
        return _q.ref_kv_write_paged(k_new, v_new, *args, head0=head0,
                                     **_codec_kw(cfg))
    return _q.kv_write_paged_cuda(_kv(k_new), _kv(v_new), *args,
                                  head0=head0, **_codec_kw(cfg))


def kv_write_chunk(k_new, v_new, k_data, k_meta, v_data, v_meta, k_scale,
                   v_scale, block_table, seq_id, pos, hist, seq_pos_after,
                   cfg: SparqConfig, head0: int = 0):
    """A prefill chunk's write (`models.paging.PagedCacheStore.
    write_chunk`): float [C, KV, hd] K/V in stream order, written into the
    pools in place (heads from `head0`, as `kv_write_paged`). Returns the
    new (k_scale, v_scale, seq_pos). Two K4 launches on the card (scale
    pass, write pass)."""
    args = (k_data, k_meta, v_data, v_meta, k_scale, v_scale, block_table,
            seq_id, pos, hist, seq_pos_after)
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_quant", mode="chunk",
                   widths=(k_new.shape[-1], v_new.shape[-1]),
                   lane0=head0 * k_new.shape[-1])
    if _route(k_new) == "plain":
        return _q.ref_kv_write_chunk(k_new, v_new, *args, head0=head0,
                                     **_codec_kw(cfg))
    return _q.kv_write_chunk_cuda(_kv(k_new), _kv(v_new), *args,
                                  head0=head0, **_codec_kw(cfg))


def kv_write_contiguous(k_new, v_new, k_data, k_meta, v_data, v_meta,
                        k_scale, v_scale, pos, cfg: SparqConfig,
                        head0: int = 0):
    """Both planes of a contiguous sparq append (`models.cache.CacheStore.
    update`, `MLACache.update`): float [B, T, ...] slabs at time offset
    `pos`, written in place; each plane's rows have their own width (K/V
    [B, T, KV, hd], or MLA's c_kv [B, T, r] and k_pe [B, T, dr]) and its
    own scale; K/V planes of a head shard take heads from `head0`, as
    `kv_write_paged`. Returns the new (k_scale, v_scale, pos). On the card
    one K4 launch at T = 1, two (scale pass, write pass) otherwise."""
    args = (k_data, k_meta, v_data, v_meta, k_scale, v_scale, pos)
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_quant", mode="contiguous",
                   widths=(k_new.shape[-1], v_new.shape[-1]),
                   lane0=head0 * k_new.shape[-1])
    if _route(k_new) == "plain":
        return _q.ref_kv_write_contiguous(k_new, v_new, *args, head0=head0,
                                          **_codec_kw(cfg))
    return _q.kv_write_contiguous_cuda(_kv(k_new), _kv(v_new), *args,
                                       head0=head0, **_codec_kw(cfg))


def kv_write_ring(k_new, v_new, k_data, k_meta, v_data, v_meta, k_scale,
                  v_scale, slot_pos, pos, cfg: SparqConfig):
    """The sliding-window ring's write (`models.cache.RingKVCache.
    insert`): float [B, T, KV, hd] K/V (T <= W) at slots (pos + t) % W of
    the [B, W, KV, hd] sparq planes, written in place with `slot_pos`
    [B, W]. Returns the new (k_scale, v_scale, pos). On the card K4's ring
    mode: one launch at T = 1, two (scale pass, write pass) otherwise."""
    if k_new.shape[1] > k_data.shape[1]:
        raise ValueError(f"a ring write of {k_new.shape[1]} tokens exceeds "
                         f"the window's {k_data.shape[1]} slots")
    args = (k_data, k_meta, v_data, v_meta, k_scale, v_scale, slot_pos, pos)
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_quant", mode="ring",
                   widths=(k_new.shape[-1], v_new.shape[-1]), lane0=0)
    if _route(k_new) == "plain":
        return _q.ref_kv_write_ring(k_new, v_new, *args, **_codec_kw(cfg))
    return _q.kv_write_ring_cuda(_kv(k_new), _kv(v_new), *args,
                                 **_codec_kw(cfg))


def sparq_dequantize(store: torch.Tensor, meta: torch.Tensor, scale=None,
                     dtype=None) -> torch.Tensor:
    """§5.1 meta-decode of the KV read-back path: int8 (store, meta)
    (..., K) -> int8 reconstructed codes, or with `scale` (the plane's f32
    0-d scale) the floats codes * scale, cast to `dtype` when given (the
    whole of `CachedTensor.read`, one K6 launch on the card, which writes
    float32 or bfloat16). The decode
    hot path never calls this: the attention kernels decode tile by tile
    in their loops."""
    lead = store.shape[:-1]
    K = store.shape[-1]
    s2, m2 = store.reshape(-1, K), meta.reshape(-1, K)
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_dequant", K=K)
    if _route(store) == "plain":
        out = _dq.ref_sparq_dequant(s2, m2) if scale is None else \
            _dq.ref_sparq_dequant_float(s2, m2, scale, dtype)
    else:
        out = _dq.sparq_dequant_cuda(s2.contiguous(), m2.contiguous(),
                                     scale, dtype)
    return out.reshape(*lead, K)


def sparq_mla_decode(q_lat, q_pe, c_data, c_meta, c_scale, pe_data,
                     pe_meta, pe_scale, pos, *, sm_scale: float, out_dtype,
                     bk: int = 128) -> torch.Tensor:
    """Absorbed-MLA flash-decode over the packed latent planes (K7 on the
    card). q_lat (B, 1, H, r), q_pe (B, 1, H, dr); c planes (B, Tk, r),
    pe planes (B, Tk, dr) int8; each plane's f32 scale and pos (the
    position after this step's append; keys t < pos attend) as device
    scalars. `bk` is the plain version's tile (the reference's 128).
    Returns (B, 1, H, r) in `out_dtype`."""
    args = (q_lat[:, 0].to(torch.float32).contiguous(),
            q_pe[:, 0].to(torch.float32).contiguous(), c_data, c_meta,
            c_scale.to(torch.float32), pe_data, pe_meta,
            pe_scale.to(torch.float32), pos.to(torch.int32))
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_mla_decode", H=q_lat.shape[2], r=q_lat.shape[3],
                   dr=q_pe.shape[3], n_keys=c_data.shape[1])
    if _route(q_lat) == "plain":
        out = _mla.ref_sparq_mla_decode(*args, sm_scale=sm_scale, bk=bk)
    else:
        out = _mla.sparq_mla_decode_cuda(*args, sm_scale=sm_scale)
    return out[:, None].to(out_dtype)


def sparq_decode_attention(q, k_data, k_meta, k_scale, v_data, v_meta,
                           v_scale, kpos, cur, window: int = 0,
                           bk: Optional[int] = None,
                           mesh=None) -> torch.Tensor:
    """Fused flash-decode attention over contiguous packed SPARQ planes.
    q (B, 1, H, hd); planes (B, Tk, KV, hd) int8; per-site scales and the
    decoded position `cur` as one-element device tensors; kpos (B, Tk)
    int32 slot positions (-1 = empty). `bk` is the Tk-tile size (None ->
    DEFAULT_BK, clamped to Tk): the tile split fixes the f32 summation
    order, so bk == page_size reproduces the paged kernel bit for bit.
    With `mesh` (tp > 1) every argument but q is a sequence over the
    shards: shard r's planes (its KV heads) and its device's copies of the
    rest. Returns f32 (B, 1, H, hd)."""
    if tp_size(mesh) > 1:
        return _per_shard(mesh, q, 2, k_data, lambda r, h0, h1, q_r:
                          sparq_decode_attention(
                              q_r, k_data[r], k_meta[r], k_scale[r],
                              v_data[r], v_meta[r], v_scale[r], kpos[r],
                              cur[r], window=window, bk=bk))
    B, Tq, H, hd = q.shape
    assert Tq == 1, f"decode attention takes one query token, got Tq={Tq}"
    Tk, KV = k_data.shape[1], k_data.shape[2]
    G = H // KV
    bk = DEFAULT_BK if bk is None else bk
    if bk < 1:
        raise ValueError(f"bk must be >= 1, got {bk}")
    bk = min(bk, Tk)
    args = (q.reshape(B, KV, G, hd).to(torch.float32).contiguous(),
            k_data, k_meta, k_scale.to(torch.float32),
            v_data, v_meta, v_scale.to(torch.float32),
            kpos.to(torch.int32).contiguous(), cur.to(torch.int32))
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_decode_attn", G=G, hd=hd, tile=bk, n_keys=Tk)
    if _route(q) == "plain":
        out = _dec.ref_sparq_decode_attn(*args, window=window, bk=bk)
    else:
        out = _dec.sparq_decode_attn_cuda(*args, window=window, bk=bk)
    return out.reshape(B, 1, H, hd)


def sparq_chunked_prefill_attention(q, k_chunk, v_chunk, k_data, k_meta,
                                    k_scale, v_data, v_meta, v_scale,
                                    block_table, seq_id, pos, hist,
                                    tile_seq, window: int = 0,
                                    bq: int = 8, mesh=None) -> torch.Tensor:
    """Ragged chunked-prefill flash attention over the §5.1 page pool.
    q (C, H, hd), k/v_chunk (C, KV, hd), pools (P, ps, KV, hd), per-slot
    scales (S,), block_table (S, NB), seq_id/pos/hist (C,), tile_seq
    (C/bq,). With `mesh` (tp > 1) the pools and everything after them are
    sequences over the shards, as in `sparq_decode_attention`; q and the
    chunk's float K/V (all heads, lead device) are cut per shard. Returns
    f32 (C, H, hd); padding rows are zeros."""
    if tp_size(mesh) > 1:
        def run(r, h0, h1, q_r):
            dev = k_data[r].device
            return sparq_chunked_prefill_attention(
                q_r, k_chunk[:, h0:h1].to(dev), v_chunk[:, h0:h1].to(dev),
                k_data[r], k_meta[r], k_scale[r], v_data[r], v_meta[r],
                v_scale[r], block_table[r], seq_id[r], pos[r], hist[r],
                tile_seq[r], window=window, bq=bq)
        return _per_shard(mesh, q, 1, k_data, run)
    C, H, hd = q.shape
    KV = k_data.shape[2]
    G = H // KV
    assert C % bq == 0 and tile_seq.shape[0] == C // bq, (C, bq)
    i32 = torch.int32
    args = (q.reshape(C, KV, G, hd).to(torch.float32).contiguous(),
            k_chunk.to(torch.float32).contiguous(),
            v_chunk.to(torch.float32).contiguous(),
            k_data, k_meta, k_scale.to(torch.float32), v_data, v_meta,
            v_scale.to(torch.float32), block_table.to(i32),
            seq_id.to(i32), pos.to(i32), hist.to(i32), tile_seq.to(i32))
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_chunked_prefill_attn", C=C, G=G, hd=hd, bq=bq,
                   page=k_data.shape[1], NB=block_table.shape[1])
    if _route(q) == "plain":
        out = _pre.ref_sparq_chunked_prefill_attn(*args, window=window)
    else:
        out = _pre.sparq_chunked_prefill_attn_cuda(*args, window=window)
    return out.reshape(C, H, hd)


def sparq_paged_decode_attention(q, k_data, k_meta, k_scale, v_data, v_meta,
                                 v_scale, block_table, cur, window: int = 0,
                                 mesh=None) -> torch.Tensor:
    """Fused flash-decode attention over a paged packed SPARQ cache.
    q (B, 1, H, hd); pools (P, ps, KV, hd); per-sequence scales (B,);
    block_table (B, NB); cur (B,) (< 0 = inactive slot, output zeros).
    With `mesh` (tp > 1) every argument but q is a sequence over the
    shards, as in `sparq_decode_attention`. Returns f32 (B, 1, H, hd)."""
    if tp_size(mesh) > 1:
        return _per_shard(mesh, q, 2, k_data, lambda r, h0, h1, q_r:
                          sparq_paged_decode_attention(
                              q_r, k_data[r], k_meta[r], k_scale[r],
                              v_data[r], v_meta[r], v_scale[r],
                              block_table[r], cur[r], window=window))
    B, Tq, H, hd = q.shape
    assert Tq == 1, f"decode attention takes one query token, got Tq={Tq}"
    KV = k_data.shape[2]
    G = H // KV
    i32 = torch.int32
    args = (q.reshape(B, KV, G, hd).to(torch.float32).contiguous(),
            k_data, k_meta, k_scale.to(torch.float32), v_data, v_meta,
            v_scale.to(torch.float32), block_table.to(i32), cur.to(i32))
    if AUDIT_HOOK is not None:
        AUDIT_HOOK("sparq_paged_decode_attn", G=G, hd=hd,
                   page=k_data.shape[1], NB=block_table.shape[1])
    if _route(q) == "plain":
        out = _dec.ref_sparq_paged_decode_attn(*args, window=window)
    else:
        out = _dec.sparq_paged_decode_attn_cuda(*args, window=window)
    return out.reshape(B, 1, H, hd)
