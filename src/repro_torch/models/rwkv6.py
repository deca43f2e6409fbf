"""RWKV6 "Finch" (port of `repro.models.rwkv6`): the attention-free time
mix with a data-dependent decay, and the squared-ReLU channel mix, whose
post-ReLU^2 activation makes `cm_v`'s input genuinely sparse (the zoo's
closest match to the paper's vSPARQ assumptions).

Two sequence-mixer forms, as in the reference, in plain torch (the
reference's are plain JAX, outside any Pallas kernel):
  scan     `_wkv_scan`, the exact recurrence step by step, in the input
           dtype (decode, and `mixer_impl="scan"`);
  chunked  `_wkv_chunked`, the chunked parallel form in f32: intra-chunk
           work as matmuls, the state carried across chunk boundaries;
           the per-step log-decay is clipped to [-5, -1e-4] so the
           largest factor within a chunk stays inside f32 range.

Token shift interpolates with static per-channel `mu`s for r/k/v/g; the
decay keeps its data-dependent LoRA (w0 + tanh(x A) B).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, QuantCtx, dense,
                                       dense_f32, init_dense, row_sum,
                                       trunc_normal)

LOG_DECAY_FLOOR = -5.0


@dataclasses.dataclass
class RWKVCache:
    """One RWKV layer's state, overwritten every step (in place): the wkv
    state [B, H, hs, hs] and the last normed input of the time mix and of
    the channel mix [B, D] (their token shifts)."""
    state: torch.Tensor
    tm_last: torch.Tensor
    cm_last: torch.Tensor


def _token_shift(x, mu, last=None):
    """lerp(x, prev_token(x), mu). x [B, T, D]; last [B, D] or None (the
    dtypes promote as in the reference)."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = torch.cat([last[:, None], x[:, :-1]], 1)
    return x + (prev - x) * mu.to(x.dtype)


def _heads(x, hs):
    B, T, D = x.shape
    return x.reshape(B, T, D // hs, hs)


def _log_decay(params, xw):
    """Per-step log decay -exp(w0 + tanh(xw A) B), clipped to
    [LOG_DECAY_FLOOR, -1e-4], in f32; the LoRA is two plain products."""
    lora = torch.matmul(torch.tanh(torch.matmul(
        xw, params["w_A"].to(xw.dtype))), params["w_B"].to(xw.dtype))
    logw = params["w0"].to(xw.dtype) + lora
    return torch.clamp(-torch.exp(logw.float()), LOG_DECAY_FLOOR, -1e-4)


def _wkv_scan(r, k, v, logw, u, state0):
    """The exact recurrence. r/k/v [B, T, H, hs], logw [B, T, H, hs] (log
    decay a key channel), u [H, hs]. The state is carried in r's dtype and
    each step's decay cast to it; the bonus term u * k is in u's dtype
    (f32), as the reference's mixed-dtype einsums promote. Returns (y
    [B, T, H, hs], state [B, H, hs, hs])."""
    w = torch.exp(logw).to(r.dtype)
    S = state0.to(r.dtype)
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t = r[:, t], k[:, t], v[:, t]
        uk = u[None] * k_t
        ct = torch.promote_types(r_t.dtype, uk.dtype)
        bonus = torch.einsum("bhi,bhi->bh", r_t.to(ct), uk.to(ct))
        y = torch.einsum("bhi,bhij->bhj", r_t, S)
        y = y.to(ct) + bonus[..., None] * v_t.to(ct)
        S = w[:, t][..., None] * S + k_t[..., None] * v_t[..., None, :]
        ys.append(y)
    return torch.stack(ys, 1), S


def _wkv_chunked(r, k, v, logw, u, state0, chunk):
    """The chunked parallel form in f32 (see the module docstring). T is
    padded to a multiple of the chunk with zero k/v (which inject nothing)
    and zero log-decay (which passes the state through), and the padding
    is sliced away."""
    B, T, H, hs = r.shape
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    Tp = T + pad
    n = Tp // C
    f32 = torch.float32
    rc = r.reshape(B, n, C, H, hs).to(f32)
    kc = k.reshape(B, n, C, H, hs).to(f32)
    vc = v.reshape(B, n, C, H, hs).to(f32)
    lw = logw.reshape(B, n, C, H, hs).to(f32)
    cum = torch.cumsum(lw, dim=2)                # inclusive, in-chunk
    cum_prev = cum - lw                          # up to t - 1
    r_t = rc * torch.exp(cum_prev)
    k_t = kc * torch.exp(-cum)
    k_end = kc * torch.exp(cum[:, :, -1:] - cum)  # decay from s to the end
    a_end = torch.exp(cum[:, :, -1])              # [B, n, H, hs]
    scores = torch.einsum("bnthi,bnshi->bnhts", r_t, k_t)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    scores = torch.where(tri, scores, 0.0)
    y_intra = torch.einsum("bnhts,bnshj->bnthj", scores, vc)
    bonus = torch.einsum("bnthi,hi,bnthi->bnth", rc, u.to(f32), kc)
    y_intra = y_intra + bonus[..., None] * vc
    inject = torch.einsum("bnshi,bnshj->bnhij", k_end, vc)
    S = state0.to(f32)
    s_in = []
    for c in range(n):                       # the state entering chunk c
        s_in.append(S)
        S = a_end[:, c][..., None] * S + inject[:, c]
    y_state = torch.einsum("bnthi,bnhij->bnthj", r_t, torch.stack(s_in, 1))
    y = (y_intra + y_state).reshape(B, Tp, H, hs)[:, :T]
    return y.to(r.dtype), S.to(r.dtype)


def _split_in(params: Dict, x: torch.Tensor, mp):
    """(col(name, site, xs), part(v)) of a sub-block split over the model
    axis: col the product of a column block on a token-shifted input xs
    (computed whole, entering through `copy_to` in f32), part(v) this
    rank's block of the last dimension of a tensor every rank holds whole
    (a replicated vector or the decay LoRA's output), through
    `copy_to`."""
    def col(name, site, xs):
        return dense_f32(params[name], mp.copy(xs.to(torch.float32)), site,
                         x.dtype).to(x.dtype)

    def part(v):
        return mp.copy(v)[..., mp.part(v.shape[-1])]
    return col, part


def time_mix(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
             cache: Optional[RWKVCache] = None, mode: str = "train",
             ctx: Optional[QuantCtx] = None, mp=None):
    """The time mix of normed x [B, T, D]. With a cache, its wkv state and
    tm_last are read and then overwritten in place (cast to their own
    dtypes); cm_last is the block's to set. Returns (out, cache).

    With `mp` (training) where `w_r`, `w_k`, `w_v`, `w_g` and `w_o`
    arrive as blocks of the heads over the model axis, a rank runs its
    heads: the token shifts and the decay LoRA are computed whole (as one
    device computes them) and enter through `copy_to`, w0's LoRA sum
    sliced to the rank's heads, u and the group norm's scale and bias too;
    `w_o`'s block sums the partial outputs."""
    B, T, D = x.shape
    hs = cfg.head_size
    if mp is not None and params["w_r"].shape[-1] == D:
        mp = None
    last = cache.tm_last if cache is not None else None
    xr = _token_shift(x, params["mu_r"], last)
    xk = _token_shift(x, params["mu_k"], last)
    xv = _token_shift(x, params["mu_v"], last)
    xw = _token_shift(x, params["mu_w"], last)
    xg = _token_shift(x, params["mu_g"], last)
    if mp is None:
        def col(name, site, xs):
            return dense(params[name], xs, site, ctx)

        def part(v):
            return v
    else:
        col, part = _split_in(params, x, mp)
    r = _heads(col("w_r", "tm_r", xr), hs)
    k = _heads(col("w_k", "tm_k", xk), hs)
    v = _heads(col("w_v", "tm_v", xv), hs)
    g = F.silu(col("w_g", "tm_g", xg))
    logw = _heads(part(_log_decay(params, xw)), hs)
    H = r.shape[2]
    u = part(params["u"]).reshape(H, hs)
    state0 = cache.state if cache is not None else \
        torch.zeros((B, H, hs, hs), dtype=x.dtype, device=x.device)
    if mode == "decode" or cfg.mixer_impl == "scan":
        y, state = _wkv_scan(r, k, v, logw, u, state0)
    else:
        y, state = _wkv_chunked(r, k, v, logw, u, state0, cfg.mixer_chunk)
    # per-head group norm, f32
    yf = y.to(torch.float32)
    mean = torch.mean(yf, -1, keepdim=True)
    yc = yf - mean
    var = torch.mean(yc * yc, -1, keepdim=True)
    yf = yc * torch.rsqrt(var + 64e-5)
    y = (yf.reshape(B, T, H * hs) * part(params["ln_x_scale"])
         + part(params["ln_x_bias"])).to(x.dtype)
    if mp is not None:
        out = row_sum(params["w_o"], y * g, "tm_out", mp)
    else:
        out = dense(params["w_o"], y * g, "tm_out", ctx)
    if cache is not None:
        cache.state = state.to(cache.state.dtype)
        cache.tm_last = x[:, -1].to(cache.tm_last.dtype)
    return out, cache


def channel_mix(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                last: Optional[torch.Tensor] = None,
                ctx: Optional[QuantCtx] = None, mp=None) -> torch.Tensor:
    """The channel mix of normed x. With `mp` (training) where `w_ck` and
    `w_cv` arrive as blocks of d_ff over the model axis, a rank's column
    and row products on its block (the token-shifted input through
    `copy_to`); where `w_cr` arrives as a block of its columns, the gate
    r, which multiplies the summed output, is gathered whole
    (`gather_from`)."""
    xk = _token_shift(x, params["mu_ck"], last)
    xr = _token_shift(x, params["mu_cr"], last)
    split_k = mp is not None and params["w_ck"].shape[-1] != cfg.d_ff
    split_r = mp is not None and params["w_cr"].shape[-1] != cfg.d_model
    col = _split_in(params, x, mp)[0] if mp is not None else None
    if split_k:
        k = torch.square(torch.relu(col("w_ck", "cm_k", xk)))
        out = row_sum(params["w_cv"], k, "cm_v", mp)
    else:
        k = torch.square(torch.relu(dense(params["w_ck"], xk, "cm_k", ctx)))
        # k is post-ReLU^2: a genuinely sparse input to cm_v
        out = dense(params["w_cv"], k, "cm_v", ctx)
    if split_r:
        r = mp.gather(torch.sigmoid(col("w_cr", "cm_r", xr)))
    else:
        r = torch.sigmoid(dense(params["w_cr"], xr, "cm_r", ctx))
    if mp is not None:       # under sequence parallelism, this rank's T
        r = mp.shard(r)
        out = out if split_k else mp.shard(out)
    return r * out


def rwkv_block_init(gen: torch.Generator, cfg: ModelConfig, device,
                    dtype=torch.float32) -> Dict:
    """The block's params but its norms: weights drawn in f32 and cast to
    `dtype`; the mus, w0, u and the group norm's scale and bias f32."""
    D, F_, la = cfg.d_model, cfg.d_ff, cfg.decay_lora
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5

    def full(value):
        return torch.full((D,), value, dtype=torch.float32, device=device)
    p = {f"mu_{n}": full(0.5) for n in ("r", "k", "v", "w", "g", "ck",
                                         "cr")}
    p.update({
        "w_r": init_dense(gen, D, D, device, dtype=dtype),
        "w_k": init_dense(gen, D, D, device, dtype=dtype),
        "w_v": init_dense(gen, D, D, device, dtype=dtype),
        "w_g": init_dense(gen, D, D, device, dtype=dtype),
        "w_o": init_dense(gen, D, D, device, scale=out_scale, dtype=dtype),
        "w_A": init_dense(gen, D, la, device, dtype=dtype),
        "w_B": trunc_normal((la, D), 0.01, gen, device, dtype),
        "w0": full(-1.0),                    # exp(-exp(-1)) ~ 0.69 decay
        "u": full(0.0),
        "ln_x_scale": full(1.0),
        "ln_x_bias": full(0.0),
        "w_ck": init_dense(gen, D, F_, device, dtype=dtype),
        "w_cr": init_dense(gen, D, D, device, dtype=dtype),
        "w_cv": init_dense(gen, F_, D, device, scale=out_scale, dtype=dtype),
    })
    return p


def rwkv_cache_init(cfg: ModelConfig, batch: int, device,
                    dtype=torch.bfloat16) -> RWKVCache:
    """O(1) state a layer in `dtype`: quantized storage would accumulate
    error in a state overwritten every step, so the sparq layout does not
    apply to it, as in the reference."""
    D, hs = cfg.d_model, cfg.head_size
    H = D // hs

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return RWKVCache(state=z(batch, H, hs, hs), tm_last=z(batch, D),
                     cm_last=z(batch, D))
