"""Multi-head Latent Attention, DeepSeek-V2 (port of `repro.models.mla`):
a low-rank compressed KV cache.

The cache holds the rank-r latent c_kv and one RoPE key head shared by all
heads (`cache.MLACache`): 512 + 64 = 576 values a token at deepseek-v2-
lite's widths, against 4096 for GQA-16. Both planes are `CachedTensor`s,
fp or the §5.1 packed sparq layout, each with its own per-site scale.

  train / prefill  the naive form: K and V decompressed through `dense`
                   (sites mla_uk, mla_uv: K1 when quantized), the RoPE key
                   broadcast across heads, V zero-padded from dv to dn + dr
                   for the plain flash attention and sliced back;
  decode           the absorbed form: W_uk folds into the query and W_uv
                   into the output, so attention runs in the latent space.
                   The sparq layout attends through `sparq_mla_decode`
                   over the packed planes (K7 on the card, no plane is
                   dequantized); fp planes take a full read and a plain
                   softmax.

The scale is (dn + dr) ** -0.5 in both forms. The cache stays contiguous
and is served by the scan engine: the paged engine refuses MLA, as the
reference's does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.attention import flash_attention
from repro_torch.models.cache import CacheConfig, MLACache
from repro_torch.models.common import (ModelConfig, QuantCtx, dense,
                                       dense_f32, init_dense, rope, row_sum)
from repro_torch.models.quantize import as_weight

__all__ = ["MLACache", "mla_init", "mla_block", "mla_cache_init",
           "sparq_mla_decode"]


def mla_init(gen: torch.Generator, cfg: ModelConfig, device,
             dtype=torch.float32) -> Dict:
    """One layer's MLA params in the reference's layout: projections drawn
    in f32 and cast to `dtype`, `c_norm` (the latent's RMS gain, applied
    as 1 + c_norm) zeros in f32."""
    d, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq": init_dense(gen, d, H * (dn + dr), device, dtype=dtype),
        "w_dkv": init_dense(gen, d, r + dr, device, dtype=dtype),
        "w_uk": init_dense(gen, r, H * dn, device, dtype=dtype),
        "w_uv": init_dense(gen, r, H * dv, device, dtype=dtype),
        "wo": init_dense(gen, H * dv, d, device,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5, dtype=dtype),
        "c_norm": torch.zeros((r,), dtype=torch.float32, device=device),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * (1.0 + scale.to(torch.float32))).to(x.dtype)


def sparq_mla_decode(q_lat: torch.Tensor, q_pe: torch.Tensor,
                     cache: MLACache, *, sm_scale: float,
                     out_dtype) -> torch.Tensor:
    """Fused absorbed-MLA decode over the packed latent planes, masked to
    the keys t < cache.pos (`kernels.ops.sparq_mla_decode`: K7 on the
    card, the reference's tile loop at 128 keys on the CPU). q_lat [B, 1,
    H, r], q_pe [B, 1, H, dr]. Returns o_lat [B, 1, H, r] in
    `out_dtype`."""
    from repro_torch.kernels.ops import sparq_mla_decode as _decode
    c, p = cache.c_kv, cache.k_pe
    return _decode(q_lat, q_pe, c.data, c.meta, c.scale, p.data, p.meta,
                   p.scale, cache.pos, sm_scale=sm_scale, out_dtype=out_dtype)


def mla_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: Optional[MLACache] = None,
              mode: str = "train", ctx: Optional[QuantCtx] = None,
              mp=None):
    """Returns (out, cache); `cache` is written in place (prefill, decode).
    `positions` [B, T]; the decode mask is kpos < pos, with pos the cache
    position after this step's append. With `mp` (training) where `wq`,
    `w_uk`, `w_uv` and `wo` arrive as blocks of the heads over the model
    axis, a rank computes its heads: x enters `wq` through `copy_to`, the
    latent and the shared RoPE key (from `w_dkv`, whole) enter `w_uk` /
    `w_uv` and the attention through it, and `wo`'s block sums the
    partial outputs."""
    B, T, _ = x.shape
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    H = cfg.n_heads
    if mp is not None:                 # a block's heads, or every head
        H = params["wq"].shape[-1] // (dn + dr)
        mp = mp if H != cfg.n_heads else None
    sm_scale = (dn + dr) ** -0.5
    if mp is None:
        q = dense(params["wq"], x, "mla_q", ctx)
    else:
        q = dense_f32(params["wq"], mp.copy(x.to(torch.float32)), "mla_q",
                      x.dtype).to(x.dtype)
    q = q.reshape(B, T, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = rope(q_pe, positions, cfg.rope_theta)

    ckv_pe = dense(params["w_dkv"], x, "mla_dkv", ctx)
    c_kv = _rms(ckv_pe[..., :r], params["c_norm"], cfg.norm_eps)
    # one RoPE key head shared by every head
    k_pe = rope(ckv_pe[..., None, r:], positions, cfg.rope_theta)[:, :, 0]

    if mode in ("prefill", "decode"):
        assert cache is not None
        cache.update(c_kv, k_pe)
    elif mode != "train":
        raise ValueError(f"MLA mode {mode!r} is not ported")

    if mode == "decode":
        wuk = as_weight(params["w_uk"], x.dtype).reshape(r, H, dn)
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope, wuk)
        if cache.c_kv.is_sparq:
            o_lat = sparq_mla_decode(q_lat, q_pe, cache, sm_scale=sm_scale,
                                     out_dtype=x.dtype)
        else:
            c_full = cache.c_kv.read(x.dtype)
            pe_full = cache.k_pe.read(x.dtype)
            s = (torch.einsum("bthr,bsr->bhts", q_lat, c_full)
                 + torch.einsum("bthe,bse->bhts", q_pe, pe_full))
            s = s.to(torch.float32) * sm_scale
            kpos = torch.arange(c_full.shape[1], device=x.device)
            s = torch.where((kpos < cache.pos)[None, None, None], s,
                            float("-inf"))
            p = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhts,bsr->bthr", p.to(x.dtype),
                                 c_full.to(x.dtype))
        wuv = as_weight(params["w_uv"], x.dtype).reshape(r, H, dv)
        out = torch.einsum("bthr,rhv->bthv", o_lat, wuv)
    else:
        if mp is None:
            k_nope = dense(params["w_uk"], c_kv, "mla_uk", ctx)
            v = dense(params["w_uv"], c_kv, "mla_uv", ctx)
        else:
            cf, k_pe = mp.copy(c_kv.to(torch.float32)), mp.copy(k_pe)
            k_nope, v = (dense_f32(params[n], cf, s, x.dtype).to(x.dtype)
                         for n, s in (("w_uk", "mla_uk"), ("w_uv", "mla_uv")))
        k_nope, v = k_nope.reshape(B, T, H, dn), v.reshape(B, T, H, dv)
        k_pe_b = k_pe[:, :, None].expand(B, T, H, dr)
        qf = torch.cat([q_nope, q_pe], -1)
        kf = torch.cat([k_nope, k_pe_b], -1)
        # pad v to the qk head dim for the shared flash attention, then
        # slice back
        v_p = torch.nn.functional.pad(v, (0, dn + dr - dv)) \
            if dv < dn + dr else v
        out = flash_attention(qf, kf, v_p, q_chunk=cfg.attn_chunk,
                              kv_chunk=cfg.attn_chunk)[..., :dv]
    out = out.reshape(B, T, H * dv)
    if mp is not None:
        return row_sum(params["wo"], out, "mla_out", mp), cache
    return dense(params["wo"], out, "mla_out", ctx), cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, device,
                   cache_cfg: Optional[CacheConfig] = None) -> MLACache:
    cc = cache_cfg or CacheConfig(layout="fp", dtype=torch.bfloat16)
    return MLACache.init(batch, max_len, cfg.kv_lora_rank, cfg.qk_rope_dim,
                         cc, device)
