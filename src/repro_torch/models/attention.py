"""GQA attention sub-block (port of `repro.models.attention`): the QKV
projections, the flash-style train/prefill attention in plain torch, the
contiguous-cache prefill and decode modes, and the paged chunk-prefill and
decode modes."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.cache import CacheConfig, CacheStore
from repro_torch.models.common import (ModelConfig, QuantCtx, dense,
                                       init_dense, rope)


def _split_heads(x, n_heads):
    B, T, _ = x.shape
    return x.reshape(B, T, n_heads, -1)


def _merge_heads(x):
    B, T, H, hd = x.shape
    return x.reshape(B, T, H * hd)


def qkv_proj(params: Dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, ctx: Optional[QuantCtx] = None):
    q = _split_heads(dense(params["wq"], x, "attn_q", ctx), cfg.n_heads)
    k = _split_heads(dense(params["wk"], x, "attn_k", ctx), cfg.n_kv_heads)
    v = _split_heads(dense(params["wv"], x, "attn_v", ctx), cfg.n_kv_heads)
    return rope(q, positions, cfg.rope_theta), \
        rope(k, positions, cfg.rope_theta), v


def flash_attention(q, k, v, *, q_chunk=512, kv_chunk=1024):
    """Causal online-softmax attention in plain torch (the calibration
    forward; not a TPU kernel in the reference either). q [B,Tq,H,hd],
    k/v [B,Tk,KV,hd], GQA by head grouping, positions 0..T-1."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    dev = q.device
    q_chunk, kv_chunk = min(q_chunk, Tq), min(kv_chunk, Tk)
    out = torch.empty((B, Tq, H, hd), dtype=q.dtype, device=dev)
    for q0 in range(0, Tq, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        nq = qc.shape[1]
        qg = qc.reshape(B, nq, KV, G, hd)
        qpos = torch.arange(q0, q0 + nq, device=dev)
        m = torch.full((B, KV, G, nq), float("-inf"), device=dev)
        l = torch.zeros((B, KV, G, nq), device=dev)
        acc = torch.zeros((B, KV, G, nq, hd), device=dev)
        for k0 in range(0, Tk, kv_chunk):
            kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            kpos = torch.arange(k0, k0 + kc.shape[1], device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                             kc.float()) * scale
            allow = kpos[None, :] <= qpos[:, None]
            s = torch.where(allow, s, float("-inf"))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.where(allow, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vc.dtype).float(),
                              vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + nq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, nq, H, hd).to(q.dtype)
    return out


def decode_attention(q: torch.Tensor, cache, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode against a cache the step has already written.
    q [B, 1, H, hd].

    paged store: K2 over the page pool (per-slot positions and scales);
    contiguous sparq: K5 over the raw packed planes, kpos = arange and
    cur = pos - 1 (device tensors: no host sync); the planes are never
    dequantized whole;
    contiguous fp: `decode_attention_dequant`, plain torch."""
    from repro_torch.models.paging import (PagedCacheStore,
                                           paged_decode_attention)
    if isinstance(cache, PagedCacheStore):
        return paged_decode_attention(q, cache, window=window)
    if cache.k.is_sparq:
        from repro_torch.kernels.ops import sparq_decode_attention
        B, Tk = cache.k.data.shape[:2]
        kpos = torch.arange(Tk, dtype=torch.int32,
                            device=q.device)[None].expand(B, Tk)
        out = sparq_decode_attention(
            q, cache.k.data, cache.k.meta, cache.k.scale,
            cache.v.data, cache.v.meta, cache.v.scale,
            kpos, cache.pos - 1, window=window, bk=cache.k.bk)
        return out.to(q.dtype)
    return decode_attention_dequant(q, cache, window=window)


def decode_attention_dequant(q: torch.Tensor, cache: CacheStore, *,
                             window: int = 0) -> torch.Tensor:
    """Full-plane decode: CachedTensor.read() then attend, plain torch.
    The path of fp planes; for the sparq layout it dequantizes the whole
    cache each step, so it is only the oracle the fused kernel is held to."""
    B, _, H, hd = q.shape
    k, v = cache.kv()
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) \
        * hd ** -0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    allow = kpos < cache.pos
    if window:
        allow = allow & (kpos >= cache.pos - window)
    s = torch.where(allow, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def cache_init(cfg: ModelConfig, batch: int, max_len: int, device,
               cache_cfg: Optional[CacheConfig] = None) -> CacheStore:
    cc = cache_cfg or CacheConfig(layout="fp", dtype=cfg.dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return CacheStore.init(shape, cc, device)


def cache_update(cache, k_new: torch.Tensor, v_new: torch.Tensor):
    """Insert [B, T_new, KV, hd] at the cache's position (in place). Sparq
    planes quantize on write, the per-site scale frozen at first write."""
    return cache.update(k_new, v_new)


def attention_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, cache=None, mode: str = "train",
                    ctx: Optional[QuantCtx] = None, chunk=None):
    """qkv -> attend -> out projection. Returns (out, cache).

    train:          causal flash attention over x (calibration forward);
    prefill:        the prompt's K/V are written to the contiguous cache,
                    then causal flash attention over the fresh K/V;
    chunk_prefill:  x is one chunk of the packed prompt stream; its K/V
                    quantize straight into the slots' pages
                    (PagedCacheStore.write_chunk), then attention runs over
                    the chunk plus the already-written pages (K3);
    decode:         one token per sequence, written to the cache, then
                    `decode_attention` (K5 contiguous, K2 paged)."""
    from repro_torch.models.paging import chunked_prefill_attention
    q, k, v = qkv_proj(params, x, cfg, positions, ctx)
    if mode == "chunk_prefill":
        assert cache is not None and chunk is not None
        cache.write_chunk(k[0], v[0], chunk)
        out = chunked_prefill_attention(q, k[0], v[0], cache, chunk)
    elif mode == "decode":
        assert cache is not None
        cache_update(cache, k, v)
        out = decode_attention(q, cache)
    elif mode in ("train", "prefill"):
        if mode == "prefill":
            assert cache is not None
            cache_update(cache, k, v)
        out = flash_attention(q, k, v, q_chunk=cfg.attn_chunk,
                              kv_chunk=cfg.attn_chunk)
    else:
        raise ValueError(f"attention mode {mode!r} is not ported")
    return dense(params["wo"], _merge_heads(out), "attn_out", ctx), cache


def attention_init(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": init_dense(gen, d, cfg.n_heads * hd, device),
        "wk": init_dense(gen, d, cfg.n_kv_heads * hd, device),
        "wv": init_dense(gen, d, cfg.n_kv_heads * hd, device),
        "wo": init_dense(gen, cfg.n_heads * hd, d, device,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
