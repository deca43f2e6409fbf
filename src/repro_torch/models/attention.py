"""GQA attention sub-block (port of `repro.models.attention`): the QKV
projections, the flash-style train/calibration attention in plain torch,
and the paged chunk-prefill and decode modes."""
from __future__ import annotations

from typing import Dict, Optional

import torch

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


def attention_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, cache=None, mode: str = "train",
                    ctx: Optional[QuantCtx] = None, chunk=None):
    """qkv -> attend -> out projection. Returns (out, cache).

    train:          causal flash attention over x (calibration forward);
    chunk_prefill:  x is one chunk of the packed prompt stream; its K/V
                    quantize straight into the slots' pages
                    (PagedCacheStore.write_chunk), then attention runs over
                    the chunk plus the already-written pages (K3);
    decode:         one token per slot, written to its page, then paged
                    flash-decode over the pool (K2)."""
    from repro_torch.models.paging import (chunked_prefill_attention,
                                           paged_decode_attention)
    q, k, v = qkv_proj(params, x, cfg, positions, ctx)
    if mode == "chunk_prefill":
        assert cache is not None and chunk is not None
        cache.write_chunk(k[0], v[0], chunk)
        out = chunked_prefill_attention(q, k[0], v[0], cache, chunk)
    elif mode == "decode":
        assert cache is not None
        cache.update(k, v)
        out = paged_decode_attention(q, cache)
    elif mode == "train":
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
