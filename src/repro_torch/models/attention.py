"""GQA attention sub-block (port of `repro.models.attention`): the QKV
projections, the flash-style train/prefill attention (causal, prefix-LM
or bidirectional) and its sliding-window form in plain torch, the contiguous-cache prefill and decode modes,
and the paged chunk-prefill and decode modes."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.cache import CacheConfig, CacheStore
from repro_torch.models.common import (ModelConfig, QuantCtx, dense,
                                       dense_f32, init_dense, rope, row_sum)


def _split_heads(x, n_heads):
    B, T, _ = x.shape
    return x.reshape(B, T, n_heads, -1)


def _merge_heads(x):
    B, T, H, hd = x.shape
    return x.reshape(B, T, H * hd)


def heads_on(params: Dict, cfg: ModelConfig, mp):
    """`mp` where this attention's q heads arrive split over the model
    axis (`wq` a block narrower than every head), else None."""
    if mp is None or params["wq"].shape[-1] == cfg.n_heads * cfg.head_dim:
        return None
    return mp


def _heads_kv(kv: torch.Tensor, h0: int, Hl: int, G: int) -> torch.Tensor:
    """The KV heads [B, T, *, hd] that q heads h0 .. h0 + Hl - 1 read
    (query head h reads KV head h // G): the one they share, or one a q
    head where they span several groups in part."""
    first, last = h0 // G, (h0 + Hl - 1) // G
    if first == last:
        return kv[:, :, first:first + 1]
    idx = torch.div(torch.arange(h0, h0 + Hl, device=kv.device), G,
                    rounding_mode="floor")
    return kv.index_select(2, idx)


def split_proj(params: Dict, x: torch.Tensor, kv_x: torch.Tensor,
               cfg: ModelConfig, mp):
    """q, k, v [B, T, heads, hd] of a rank whose q heads are split over the
    model axis (training; no RoPE): q from its `wq` block on x (through
    `copy_to`, in f32), k and v from their blocks on kv_x the same way
    where the KV heads split with q; otherwise k and v computed whole
    from kv_x (outside the split, as one device computes them), entering
    through `copy_to`, and cut to the KV heads this rank's q heads read
    (MQA; fewer KV heads than ranks)."""
    hd, dt = cfg.head_dim, x.dtype
    xf = mp.copy(x.to(torch.float32))

    def col(name, site, src):
        return _split_heads(dense_f32(params[name], src, site, dt).to(dt),
                            params[name].shape[-1] // hd)
    q = col("wq", "attn_q", xf)
    if params["wk"].shape[-1] != cfg.n_kv_heads * hd:
        kf = xf if kv_x is x else mp.copy(kv_x.to(torch.float32))
        return q, col("wk", "attn_k", kf), col("wv", "attn_v", kf)
    Hl, G = q.shape[2], cfg.n_heads // cfg.n_kv_heads
    k, v = (_heads_kv(mp.copy(_split_heads(dense(params[n], kv_x, s),
                                           cfg.n_kv_heads)),
                      mp.index * Hl, Hl, G)
            for n, s in (("wk", "attn_k"), ("wv", "attn_v")))
    return q, k, v


def qkv_proj(params: Dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, ctx: Optional[QuantCtx] = None,
             mp=None):
    """q, k, v [B, T, heads, hd], RoPE applied; with `mp` where the heads
    arrive split, this rank's (`split_proj`)."""
    if heads_on(params, cfg, mp) is not None:
        q, k, v = split_proj(params, x, x, cfg, mp)
    else:
        q = _split_heads(dense(params["wq"], x, "attn_q", ctx), cfg.n_heads)
        k = _split_heads(dense(params["wk"], x, "attn_k", ctx),
                         cfg.n_kv_heads)
        v = _split_heads(dense(params["wv"], x, "attn_v", ctx),
                         cfg.n_kv_heads)
    if not cfg.use_rope:
        return q, k, v
    return rope(q, positions, cfg.rope_theta), \
        rope(k, positions, cfg.rope_theta), v


def flash_attention(q, k, v, *, causal=True, q_chunk=512, kv_chunk=1024,
                    window=0, prefix_len=0, q_offset=0, kv_offset=0):
    """Online-softmax attention in plain torch (not a TPU kernel in the
    reference either). q [B,Tq,H,hd], k/v [B,Tk,KV,hd], GQA by head
    grouping. q_offset / kv_offset: the absolute positions of q[0] and
    k[0]; a key at a negative position is masked (the left context the
    windowed blocks pad with). The mask is the reference's: kp <= qp when
    `causal`, or kp < prefix_len (the prefix-LM mask: a prefix the
    queries attend to both ways, causal only), and qp - kp < window when
    `window`."""
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
        qpos = torch.arange(q_offset + q0, q_offset + q0 + nq, device=dev)
        m = torch.full((B, KV, G, nq), float("-inf"), device=dev)
        l = torch.zeros((B, KV, G, nq), device=dev)
        acc = torch.zeros((B, KV, G, nq, hd), device=dev)
        for k0 in range(0, Tk, kv_chunk):
            kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            kpos = torch.arange(kv_offset + k0, kv_offset + k0 + kc.shape[1],
                                device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                             kc.float()) * scale
            allow = (kpos >= 0)[None, :].expand(nq, -1)
            if causal:
                seen = kpos[None, :] <= qpos[:, None]
                if prefix_len:
                    seen = seen | (kpos < prefix_len)[None, :]
                allow = allow & seen
            if window:
                allow = allow & (qpos[:, None] - kpos[None, :] < window)
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


def local_attention(q, k, v, *, window: int):
    """Exact sliding-window attention by the reference's two-block trick:
    T is padded to a multiple of W and one zero block of left context is
    added; each block of W queries attends to the 2W keys of its own block
    and the one before (key offset (i - 1) * W) through `flash_attention`,
    so the cost is O(T * W)."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    W = window
    pad = (-T) % W
    nb = (T + pad) // W

    def padded(x):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    qp = padded(q)
    left = torch.zeros((B, W, KV, hd), dtype=k.dtype, device=k.device)
    k2 = torch.cat([left, padded(k)], 1)
    v2 = torch.cat([left.to(v.dtype), padded(v)], 1)
    out = torch.empty((B, nb * W, H, hd), dtype=q.dtype, device=q.device)
    for i in range(nb):
        out[:, i * W:(i + 1) * W] = flash_attention(
            qp[:, i * W:(i + 1) * W], k2[:, i * W:(i + 2) * W],
            v2[:, i * W:(i + 2) * W], causal=True, window=W,
            q_chunk=min(512, W), kv_chunk=min(1024, 2 * W),
            q_offset=i * W, kv_offset=(i - 1) * W)
    return out[:, :T]


def decode_attention(q: torch.Tensor, cache, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode against a cache the step has already written.
    q [B, 1, H, hd].

    paged store: K2 over the page pool (per-slot positions and scales);
    contiguous sparq: K5 over the raw packed planes, kpos = arange and
    cur = pos - 1 (device tensors: no host sync); the planes are never
    dequantized whole;
    contiguous fp: `decode_attention_dequant`, plain torch.
    A sharded store (tensor parallelism) reads once a shard, and the
    output holds every head on the lead device."""
    from repro_torch.models.paging import (PagedCacheStore,
                                           ShardedPagedCacheStore,
                                           paged_decode_attention)
    if isinstance(cache, (PagedCacheStore, ShardedPagedCacheStore)):
        return paged_decode_attention(q, cache, window=window)
    shards = cache.shards
    if shards[0].k.is_sparq:
        from repro_torch.kernels.ops import sparq_decode_attention
        B, Tk = shards[0].k.data.shape[:2]

        def args(c):
            kpos = torch.arange(Tk, dtype=torch.int32,
                                device=c.pos.device)[None].expand(B, Tk)
            return (c.k.data, c.k.meta, c.k.scale, c.v.data, c.v.meta,
                    c.v.scale, kpos, c.pos - 1)
        cols = list(zip(*map(args, shards)))
        out = sparq_decode_attention(
            q, *(cols if cache.mesh is not None else (c[0] for c in cols)),
            window=window, bk=shards[0].k.bk, mesh=cache.mesh)
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
               cache_cfg: Optional[CacheConfig] = None, mesh=None):
    cc = cache_cfg or CacheConfig(layout="fp", dtype=cfg.dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return CacheStore.init(shape, cc, device, mesh=mesh)


def cache_update(cache, k_new: torch.Tensor, v_new: torch.Tensor):
    """Insert [B, T_new, KV, hd] at the cache's position (in place). Sparq
    planes quantize on write, the per-site scale frozen at first write."""
    return cache.update(k_new, v_new)


def attention_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, cache=None, mode: str = "train",
                    ctx: Optional[QuantCtx] = None, chunk=None,
                    window: int = 0, prefix_len: int = 0, mp=None):
    """qkv -> attend -> out projection. Returns (out, cache).

    train:          causal flash attention over x (calibration forward;
                    the first `prefix_len` keys seen by every query),
                    or with `window` the sliding-window `local_attention`;
    prefill:        the prompt's K/V are written to the contiguous cache,
                    then causal flash attention over the fresh K/V;
    chunk_prefill:  x is one chunk of the packed prompt stream; its K/V
                    quantize straight into the slots' pages
                    (PagedCacheStore.write_chunk), then attention runs over
                    the chunk plus the already-written pages (K3);
    decode:         one token per sequence, written to the cache, then
                    `decode_attention` (K5 contiguous, K2 paged).
    With `mp` (train only) where the heads arrive split over the model
    axis, a rank attends with its heads and `wo`'s block sums the
    partial outputs (`row_sum`)."""
    from repro_torch.models.paging import chunked_prefill_attention
    q, k, v = qkv_proj(params, x, cfg, positions, ctx, mp)
    if mode == "chunk_prefill":
        assert cache is not None and chunk is not None
        cache.write_chunk(k[0], v[0], chunk)
        out = chunked_prefill_attention(q, k[0], v[0], cache, chunk)
    elif mode == "decode":
        assert cache is not None
        cache_update(cache, k, v)
        out = decode_attention(q, cache, window=window)
    elif mode in ("train", "prefill"):
        if mode == "prefill":
            assert cache is not None
            cache_update(cache, k, v)
        if window:
            out = local_attention(q, k, v, window=window)
        else:
            out = flash_attention(q, k, v, q_chunk=cfg.attn_chunk,
                                  kv_chunk=cfg.attn_chunk,
                                  prefix_len=prefix_len)
    else:
        raise ValueError(f"attention mode {mode!r} is not ported")
    if heads_on(params, cfg, mp) is not None:
        return row_sum(params["wo"], _merge_heads(out), "attn_out", mp), \
            cache
    # a tensor-parallel read returned every head, concatenated on the lead
    # device: wo contracts them whole, in the TP 1 order (a row-parallel
    # wo summing tp partial products would reassociate the contraction)
    return dense(params["wo"], _merge_heads(out), "attn_out", ctx), cache


def attention_init(gen: torch.Generator, cfg: ModelConfig, device,
                   dtype=torch.float32) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": init_dense(gen, d, cfg.n_heads * hd, device, dtype=dtype),
        "wk": init_dense(gen, d, cfg.n_kv_heads * hd, device, dtype=dtype),
        "wv": init_dense(gen, d, cfg.n_kv_heads * hd, device, dtype=dtype),
        "wo": init_dense(gen, cfg.n_heads * hd, d, device,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5, dtype=dtype),
    }
