"""RG-LRU recurrent block (port of `repro.models.rglru`, RecurrentGemma /
Griffin): a causal depthwise conv and a gated linear recurrence,

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(L) * sigmoid(W_a x_t)),  c = 8,

in plain torch (the reference's is plain JAX, outside any Pallas kernel).
The prefill runs the recurrence as an associative scan in the reference's
combine order (`_assoc_scan`, the odd/even recursion of
`jax.lax.associative_scan`), so its f32 states round as JAX's do; decode
and `mixer_impl="scan"` run it step by step. The 1:2 local-attention :
recurrent pattern is assembled in `models.transformer`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, QuantCtx, dense,
                                       dense_f32, init_dense, row_sum,
                                       trunc_normal)

_C = 8.0


@dataclasses.dataclass
class RGLRUCache:
    """The recurrent state of one RG-LRU layer, overwritten every step (in
    place): h [B, W] and the conv's trailing inputs [B, conv_width - 1,
    W]."""
    h: torch.Tensor
    conv: torch.Tensor


def _causal_conv(x, kernel, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv by shifted adds. x [B, T, C], kernel [W, C];
    cache [B, W - 1, C] the trailing context of the previous call.
    Returns (out, the new trailing context)."""
    W = kernel.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], 1)                 # [B, T + W - 1, C]
    T = x.shape[1]
    out = torch.zeros_like(x)
    for w in range(W):
        out = out + xp[:, w:w + T] * kernel[w].to(x.dtype)
    new_cache = xp[:, -(W - 1):] if W > 1 else pad
    return out, new_cache


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _assoc_scan(a, b):
    """Inclusive scan of (a, b) under `_combine` along axis 1, in
    `jax.lax.associative_scan`'s order: combine adjacent pairs, scan the
    pairs recursively, then fill the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    out = []
    for first, even, odd in ((a, ea, oa), (b, eb, ob)):
        even = torch.cat([first[:, :1], even], 1)
        full = torch.empty_like(first)
        full[:, 0::2] = even
        full[:, 1::2] = odd
        out.append(full)
    return out[0], out[1]


def _lru_scan(a, bx, h0, impl: str):
    """h_t = a_t h_{t-1} + bx_t elementwise over [B, T, C], from h0
    [B, C] (None: zeros). Returns (hs [B, T, C], h_last [B, C])."""
    if impl == "scan":
        h = h0 if h0 is not None else torch.zeros_like(bx[:, 0])
        hs = torch.empty_like(bx)
        for t in range(bx.shape[1]):
            h = a[:, t] * h + bx[:, t]
            hs[:, t] = h
        return hs, h
    b0 = bx
    if h0 is not None:                 # fold h0 into the first input term
        b0 = bx.clone()
        b0[:, 0] = bx[:, 0] + a[:, 0] * h0
    _, bb = _assoc_scan(a, b0)
    return bb, bb[:, -1]


def rglru_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[RGLRUCache] = None, mode: str = "train",
                ctx: Optional[QuantCtx] = None, mp=None):
    """The recurrent sub-block: in-projections (x and gate branches) ->
    conv -> RG-LRU -> gated out-projection. The gates and the recurrence
    run in f32. With a cache, its state is read and then overwritten in
    place, cast to the cache's own dtypes. Returns (out, cache).

    With `mp` (training) where the leaves arrive as blocks of the width W
    over the model axis, a rank runs its block of the channels: x enters
    `w_y` / `w_x` through `copy_to`, the conv takes its channels, the
    `w_a` / `w_i` products (their input rows split) are summed and
    scattered back to its block (`reduce_scatter_to`), `lam` is sliced
    (through `copy_to`), and `w_out`'s block sums the partial outputs."""
    B, dt = x.shape[0], x.dtype
    if mp is not None and params["w_x"].shape[-1] == (cfg.lru_width
                                                      or cfg.d_model):
        mp = None
    if mp is None:
        def col(name, site):
            return dense(params[name], x, site, ctx)

        def gates(name, site, xb):
            return dense(params[name], xb, site, ctx).float()
        lam = params["lam"].float()
    else:
        xf = mp.copy(x.to(torch.float32))

        def col(name, site):
            return dense_f32(params[name], xf, site, dt).to(dt)

        def gates(name, site, xb):
            return mp.reduce_scatter(dense_f32(
                params[name], xb.to(torch.float32), site, dt)).to(dt).float()
        lam = mp.copy(params["lam"])[mp.part(params["lam"].shape[0])].float()
    gate = F.gelu(col("w_y", "rg_gate"), approximate="tanh")
    xb = col("w_x", "rg_in")
    xb, conv_cache = _causal_conv(
        xb, params["conv_k"], cache.conv if cache is not None else None)
    r = torch.sigmoid(gates("w_a", "rg_rgate", xb))
    i = torch.sigmoid(gates("w_i", "rg_igate", xb))
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    a = torch.exp(-_C * softplus * r)
    gated_x = i * xb.float()
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated_x
    h0 = cache.h.float() if cache is not None else \
        torch.zeros((B, xb.shape[-1]), dtype=torch.float32, device=x.device)
    impl = "scan" if (mode == "decode" or cfg.mixer_impl == "scan") \
        else "assoc"
    hs, h_last = _lru_scan(a, bx, h0, impl)
    if mp is not None:
        out = row_sum(params["w_out"], hs.to(dt) * gate, "rg_out", mp)
    else:
        out = dense(params["w_out"], hs.to(dt) * gate, "rg_out", ctx)
    if cache is not None:
        cache.h = h_last.to(cache.h.dtype)
        cache.conv = conv_cache.to(cache.conv.dtype)
    return out, cache


def rglru_init(gen: torch.Generator, cfg: ModelConfig, device,
               dtype=torch.float32) -> Dict:
    """f32 draws cast to `dtype`; `lam` f32 (a ~ U(0.9, 0.999)^c-ish, the
    reference's Griffin init)."""
    D, W = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "w_y": init_dense(gen, D, W, device, dtype=dtype),
        "w_x": init_dense(gen, D, W, device, dtype=dtype),
        "w_a": init_dense(gen, W, W, device, scale=0.1, dtype=dtype),
        "w_i": init_dense(gen, W, W, device, scale=0.1, dtype=dtype),
        "w_out": init_dense(gen, W, D, device,
                            scale=1.0 / (2 * cfg.n_layers) ** 0.5,
                            dtype=dtype),
        "conv_k": trunc_normal((cfg.conv_width, W), 0.1, gen, device, dtype),
        "lam": torch.full((W,), 0.65, dtype=torch.float32, device=device),
    }


def rglru_cache_init(cfg: ModelConfig, batch: int, device,
                     dtype=torch.bfloat16) -> RGLRUCache:
    W = cfg.lru_width or cfg.d_model
    return RGLRUCache(
        h=torch.zeros((batch, W), dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, W), dtype=dtype,
                         device=device))
