"""Public entry points of the SPARQ kernels (port of `repro.kernels.ops`).

Dispatch goes by the device of the tensors: CPU tensors take the plain
PyTorch versions, CUDA tensors take the hand-written kernels, any other
device raises. There is no switch that could route a CUDA tensor to a
plain version: on the card, the main path always runs the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizer import QScale
from repro_torch.core.sparq import SparqConfig
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sparq_decode_attn as _dec
from repro_torch.kernels import sparq_dequant as _dq
from repro_torch.kernels import sparq_matmul as _mm
from repro_torch.kernels import sparq_prefill_attn as _pre
from repro_torch.kernels import sparq_quant as _q

# default Tk-tile size of the contiguous decode-attention kernel (K5);
# CacheConfig.attn_bk overrides it per cache
DEFAULT_BK = 128


def _route(t: torch.Tensor) -> str:
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no SPARQ kernel for device {t.device}")


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
                   v_scale, block_table, seq_pos, cfg: SparqConfig):
    """A paged decode update (`models.paging.PagedCacheStore.update`):
    float [S, 1, KV, hd] K/V, one token a slot, quantized and written into
    the pools in place. Returns the new (k_scale, v_scale, seq_pos). One K4
    launch on the card."""
    args = (k_data, k_meta, v_data, v_meta, k_scale, v_scale, block_table,
            seq_pos)
    if _route(k_new) == "plain":
        return _q.ref_kv_write_paged(k_new, v_new, *args, **_codec_kw(cfg))
    return _q.kv_write_paged_cuda(_kv(k_new), _kv(v_new), *args,
                                  **_codec_kw(cfg))


def kv_write_chunk(k_new, v_new, k_data, k_meta, v_data, v_meta, k_scale,
                   v_scale, block_table, seq_id, pos, hist, seq_pos_after,
                   cfg: SparqConfig):
    """A prefill chunk's write (`models.paging.PagedCacheStore.
    write_chunk`): float [C, KV, hd] K/V in stream order, written into the
    pools in place. Returns the new (k_scale, v_scale, seq_pos). Two K4
    launches on the card (scale pass, write pass)."""
    args = (k_data, k_meta, v_data, v_meta, k_scale, v_scale, block_table,
            seq_id, pos, hist, seq_pos_after)
    if _route(k_new) == "plain":
        return _q.ref_kv_write_chunk(k_new, v_new, *args, **_codec_kw(cfg))
    return _q.kv_write_chunk_cuda(_kv(k_new), _kv(v_new), *args,
                                  **_codec_kw(cfg))


def kv_write_contiguous(k_new, v_new, k_data, k_meta, v_data, v_meta,
                        k_scale, v_scale, pos, cfg: SparqConfig):
    """Both planes of a contiguous sparq append (`models.cache.CacheStore.
    update`): float [B, T, KV, hd] K/V at time offset `pos`, written in
    place. Returns the new (k_scale, v_scale, pos). On the card one K4
    launch at T = 1, two (scale pass, write pass) otherwise."""
    args = (k_data, k_meta, v_data, v_meta, k_scale, v_scale, pos)
    if _route(k_new) == "plain":
        return _q.ref_kv_write_contiguous(k_new, v_new, *args,
                                          **_codec_kw(cfg))
    return _q.kv_write_contiguous_cuda(_kv(k_new), _kv(v_new), *args,
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
    if _route(store) == "plain":
        out = _dq.ref_sparq_dequant(s2, m2) if scale is None else \
            _dq.ref_sparq_dequant_float(s2, m2, scale, dtype)
    else:
        out = _dq.sparq_dequant_cuda(s2.contiguous(), m2.contiguous(),
                                     scale, dtype)
    return out.reshape(*lead, K)


def sparq_decode_attention(q, k_data, k_meta, k_scale, v_data, v_meta,
                           v_scale, kpos, cur, window: int = 0,
                           bk: Optional[int] = None) -> torch.Tensor:
    """Fused flash-decode attention over contiguous packed SPARQ planes.
    q (B, 1, H, hd); planes (B, Tk, KV, hd) int8; per-site scales and the
    decoded position `cur` as one-element device tensors; kpos (B, Tk)
    int32 slot positions (-1 = empty). `bk` is the Tk-tile size (None ->
    DEFAULT_BK, clamped to Tk): the tile split fixes the f32 summation
    order, so bk == page_size reproduces the paged kernel bit for bit.
    Returns f32 (B, 1, H, hd)."""
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
    if _route(q) == "plain":
        out = _dec.ref_sparq_decode_attn(*args, window=window, bk=bk)
    else:
        out = _dec.sparq_decode_attn_cuda(*args, window=window, bk=bk)
    return out.reshape(B, 1, H, hd)


def sparq_chunked_prefill_attention(q, k_chunk, v_chunk, k_data, k_meta,
                                    k_scale, v_data, v_meta, v_scale,
                                    block_table, seq_id, pos, hist,
                                    tile_seq, window: int = 0,
                                    bq: int = 8) -> torch.Tensor:
    """Ragged chunked-prefill flash attention over the §5.1 page pool.
    q (C, H, hd), k/v_chunk (C, KV, hd), pools (P, ps, KV, hd), per-slot
    scales (S,), block_table (S, NB), seq_id/pos/hist (C,), tile_seq
    (C/bq,). Returns f32 (C, H, hd); padding rows are zeros."""
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
    if _route(q) == "plain":
        out = _pre.ref_sparq_chunked_prefill_attn(*args, window=window)
    else:
        out = _pre.sparq_chunked_prefill_attn_cuda(*args, window=window)
    return out.reshape(C, H, hd)


def sparq_paged_decode_attention(q, k_data, k_meta, k_scale, v_data, v_meta,
                                 v_scale, block_table, cur,
                                 window: int = 0) -> torch.Tensor:
    """Fused flash-decode attention over a paged packed SPARQ cache.
    q (B, 1, H, hd); pools (P, ps, KV, hd); per-sequence scales (B,);
    block_table (B, NB); cur (B,) (< 0 = inactive slot, output zeros).
    Returns f32 (B, 1, H, hd)."""
    B, Tq, H, hd = q.shape
    assert Tq == 1, f"decode attention takes one query token, got Tq={Tq}"
    KV = k_data.shape[2]
    G = H // KV
    i32 = torch.int32
    args = (q.reshape(B, KV, G, hd).to(torch.float32).contiguous(),
            k_data, k_meta, k_scale.to(torch.float32), v_data, v_meta,
            v_scale.to(torch.float32), block_table.to(i32), cur.to(i32))
    if _route(q) == "plain":
        out = _dec.ref_sparq_paged_decode_attn(*args, window=window)
    else:
        out = _dec.sparq_paged_decode_attn_cuda(*args, window=window)
    return out.reshape(B, 1, H, hd)
